"""The train step, the port of ``repro/train/step.py::make_train_step``.

Mixed precision as in the reference: the compute copy of the f32 master
params is every floating leaf cast to ``cfg.dtype`` (``tree_cast``, norms
and router included; not the serving ``cast_params``, which keeps some
weights in f32), and the gradient is taken with respect to that copy, its
leaves fresh (``detach().requires_grad_()``): the gradients come out in
``cfg.dtype``, as the reference's ``value_and_grad`` over ``params_c``
gives them, and ``adamw_update`` widens them to f32. ``abstract_params``
and ``abstract_opt_state`` take logical rules and a mesh; they wait for
the port of ``sharding/`` and ``launch/``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.tensor import DTensor, Shard

from repro_torch.models.layers import abstract_leaf, abstract_tree
from repro_torch.models.registry import Model
from repro_torch.sharding.logical import (LogicalRules, NamedSharding, P,
                                          get_rules)
from repro_torch.train.optimizer import AdamWConfig, adamw_update
from repro_torch.utils.tree import tree_cast, tree_leaves, tree_map


def compute_params(params, dtype: torch.dtype):
    """The compute copy of the master ``params``: every floating leaf cast
    to ``dtype`` (``tree_cast``), each a fresh leaf that requires grad."""
    return tree_map(lambda p: p.detach().requires_grad_(),
                    tree_cast(params, dtype))


def _placed_like(g, p):
    """Gradient ``g`` in the placements of its param ``p`` (a DTensor's;
    a plain tensor's gradient as it is)."""
    if isinstance(p, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def loss_and_grads(model: Model, params_c, batch) -> tuple:
    """(loss, metrics, grads) of ``model.loss`` at ``params_c``
    (``compute_params``' tree), the gradients in its dtype and its leaves'
    placements; a leaf the loss does not reach gets zeros, as ``jax.grad``
    gives it."""
    loss, metrics = model.loss(params_c, batch)
    loss.backward()
    grads = tree_map(lambda p: torch.zeros_like(p) if p.grad is None
                     else _placed_like(p.grad, p), params_c)
    for p in tree_leaves(params_c):
        p.grad = None
    return loss.detach(), tree_map(torch.Tensor.detach, metrics), grads


def microbatch(x, n: int, i: int):
    """Microbatch ``i`` of ``n`` of ``x`` along its leading dim: the
    reference's ``reshape((n, B // n) + rest)[i]``; for a DTensor sharded
    on that dim, the same slice of each rank's shard (the module
    docstring)."""
    if isinstance(x, DTensor) and Shard(0) in x.placements:
        loc = x.to_local()
        loc = loc.reshape((n, loc.shape[0] // n) + tuple(loc.shape[1:]))[i]
        return DTensor.from_local(loc, x.device_mesh, x.placements,
                                  run_check=False)
    return x.reshape((n, x.shape[0] // n) + tuple(x.shape[1:]))[i]


def make_train_step(model: Model, opt_cfg: AdamWConfig,
                    grad_accum: int = 1, donate: bool = False):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), ``batch`` a dict of tensors on the params' device.

    grad_accum > 1 loops over microbatches (the batch's leading dim must
    divide), adding the gradients in place into an f32 sum the step
    allocates (each microbatch's gradients dropped before the next), then
    divides loss and gradients by their count; the metrics are the last
    microbatch's.

    ``donate=True`` is the reference's ``jax.jit(..., donate_argnums=(0,
    1))``: the step takes over the ``params`` and ``opt_state`` it is
    given and writes the new values into their tensors (``adamw_update``'s
    ``donate``); the bits are those of ``donate=False``. It returns the
    tensors it was given. A caller that needs the old values after the
    call copies them first, as JAX makes donated buffers unusable."""
    cfg = model.cfg
    grad_accum = max(grad_accum, getattr(cfg, "grad_accum", 1))
    dtype = getattr(torch, cfg.dtype)

    def train_step(params, opt_state, batch):
        params_c = compute_params(params, dtype)
        if grad_accum == 1:
            loss, metrics, grads = loss_and_grads(model, params_c, batch)
        else:
            loss = torch.zeros((), dtype=torch.float32,
                               device=tree_leaves(params)[0].device)
            grads = tree_map(lambda p: torch.zeros_like(
                p, dtype=torch.float32), params)
            for i in range(grad_accum):
                mb = {k: microbatch(x, grad_accum, i)
                      for k, x in batch.items()}
                lo, metrics, g = loss_and_grads(model, params_c, mb)
                loss = loss + lo
                for a, b in zip(tree_leaves(grads), tree_leaves(g)):
                    a.add_(b.to(torch.float32))
                del g
            loss = loss / grad_accum
            for g in tree_leaves(grads):
                g.div_(grad_accum)
        del params_c
        with torch.no_grad():
            params, opt_state, opt_metrics = adamw_update(
                opt_cfg, params, grads, opt_state, donate=donate)
        return params, opt_state, {"loss": loss, **metrics, **opt_metrics}

    return train_step


def abstract_params(model: Model, rules: Optional[LogicalRules] = None):
    """Meta tensor tree of the params (DTensors of the rules' shardings
    when rules are given or active)."""
    rules = rules or get_rules()
    fn = (lambda names, shape: rules.sharding(names, shape)) if rules else None
    return abstract_tree(model.specs(), getattr(torch, model.cfg.param_dtype),
                         fn)


def abstract_opt_state(model: Model, rules: Optional[LogicalRules] = None):
    p = abstract_params(model, rules)
    rules = rules or get_rules()
    rep = None if rules is None else NamedSharding(rules.mesh, P())
    return {"step": abstract_leaf((), torch.int32, rep), "mu": p, "nu": p}
