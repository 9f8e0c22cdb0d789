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

import torch

from repro_torch.models.registry import Model
from repro_torch.train.optimizer import AdamWConfig, adamw_update
from repro_torch.utils.tree import tree_cast, tree_leaves, tree_map


def compute_params(params, dtype: torch.dtype):
    """The compute copy of the master ``params``: every floating leaf cast
    to ``dtype`` (``tree_cast``), each a fresh leaf that requires grad."""
    return tree_map(lambda p: p.detach().requires_grad_(),
                    tree_cast(params, dtype))


def loss_and_grads(model: Model, params_c, batch) -> tuple:
    """(loss, metrics, grads) of ``model.loss`` at ``params_c``
    (``compute_params``' tree), the gradients in its dtype; a leaf the
    loss does not reach gets zeros, as ``jax.grad`` gives it."""
    loss, metrics = model.loss(params_c, batch)
    loss.backward()
    grads = tree_map(lambda p: torch.zeros_like(p) if p.grad is None
                     else p.grad, params_c)
    for p in tree_leaves(params_c):
        p.grad = None
    return loss.detach(), tree_map(torch.Tensor.detach, metrics), grads


def make_train_step(model: Model, opt_cfg: AdamWConfig,
                    grad_accum: int = 1):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), ``batch`` a dict of tensors on the params' device.

    grad_accum > 1 loops over microbatches (the batch's leading dim must
    divide), summing the gradients in f32, then divides loss and
    gradients by their count; the metrics are the last microbatch's."""
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
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            for i in range(grad_accum):
                mb = {k: x.reshape((grad_accum, x.shape[0] // grad_accum)
                                   + tuple(x.shape[1:]))[i]
                      for k, x in batch.items()}
                lo, metrics, g = loss_and_grads(model, params_c, mb)
                loss = loss + lo
                grads = tree_map(lambda a, b: a + b.to(torch.float32),
                                 grads, g)
            loss = loss / grad_accum
            grads = tree_map(lambda g: g / grad_accum, grads)
        with torch.no_grad():
            params, opt_state, opt_metrics = adamw_update(
                opt_cfg, params, grads, opt_state)
        return params, opt_state, {"loss": loss, **metrics, **opt_metrics}

    return train_step
