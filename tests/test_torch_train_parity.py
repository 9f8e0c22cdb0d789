"""The port's training path against the JAX package's, on the CPU:
``loss_fn`` with every gradient leaf, its remat policies, and one train
step (tests/test_torch_train_pieces.py holds the loss, the attention's
gradient, the tree helpers and checkpoints across the two packages).

The same numpy weights (``numpy_params``, the zero-initialized leaves
drawn at 0.1 so that they take part) and the same batches (``make_batch``)
go through both packages in f32. The port's attention takes its plain
forward here (CPU tensors) and the backward the card runs,
``flash_attention_backward``; the JAX package differentiates its chunked
softmax (``_sdpa_block``).

Tolerances (measured in brackets, on this file's inputs):

- ``loss_fn``: the loss within rtol 1e-5 (0-1.7e-7), every gradient leaf
  within ``F32``, atol and rtol 1e-5 (largest difference 5e-6, on RWKV-6's
  decay weights, whose gradients run to ~1; 2.2e-6 of a leaf's norm at
  most).
- one train step in f32: loss rtol 1e-5 and grad_norm rtol 1e-4, the
  reference's own limits for grad_accum (tests/test_train.py), lr exact;
  the params and first moments after it within 1e-4 absolute, 0.1 of the
  learning rate (0.035 of it): AdamW's first step moves a weight by lr
  times g / (|g| + eps), so a gradient near 0 that differs in its last
  bits moves its weight by a fraction of lr.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKE_ARCHS
from repro.models import build_model as jbuild
from repro.models import transformer as jtfm
from repro.train.optimizer import AdamWConfig as JAdamW
from repro.train.optimizer import init_opt_state as j_init_opt_state
from repro.train.step import make_train_step as j_make_train_step
from repro_torch.configs import SMOKE_ARCHS as T_SMOKE
from repro_torch.models import build_model
from repro_torch.models.convert import numpy_params, params_from_numpy
from repro_torch.train.data import DataConfig, make_batch
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.step import make_train_step
from repro_torch.utils import tree as ttree

F32 = dict(atol=1e-5, rtol=1e-5)
# one smoke config per block kind and input path
LOSS_CONFIGS = ["qwen3-0.6b", "gemma2-27b", "mixtral-8x22b", "qwen2-vl-2b",
                "musicgen-large", "rwkv6-1.6b", "recurrentgemma-9b"]


def _np(x):
    """A tensor or a JAX array as a float32 (or integer) numpy array."""
    if isinstance(x, torch.Tensor):
        return (x.float() if x.is_floating_point() else x).detach().numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == jnp.bfloat16 else x


def _flat_np(tree) -> dict:
    return {k: _np(v) for k, v in ttree.flatten_dict(tree).items()}


def _weights(cfg, seed=0):
    """``numpy_params`` with every all-zero leaf drawn at 0.1 instead."""
    rng = np.random.default_rng(seed + 1)

    def fill(a):
        if isinstance(a, dict):
            return {k: fill(a[k]) for k in sorted(a)}
        if a.any():
            return a
        return (rng.standard_normal(a.shape) * 0.1).astype(np.float32)
    return fill(numpy_params(cfg, seed))


def _configs(name: str, **kw):
    return SMOKE_ARCHS[name].replace(**kw), T_SMOKE[name].replace(**kw)


def _batch(cfg, seed=1, batch=2, seq_len=32, step=0):
    return make_batch(DataConfig(seed=seed, batch=batch, seq_len=seq_len),
                      cfg, step)


# ---------------------------------------------------------------------------
# loss_fn and its gradient
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(name: str) -> tuple:
    """The JAX package's (loss, metrics, flat grads) of ``loss_fn`` on the
    smoke config ``name`` in f32, jitted."""
    jcfg, tcfg = _configs(name, dtype="float32")
    w = _weights(tcfg)
    batch = _batch(tcfg)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p, b: jtfm.loss_fn(p, b, jcfg), has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, w),
        jax.tree_util.tree_map(jnp.asarray, batch))
    return (float(loss), {k: float(v) for k, v in metrics.items()},
            _flat_np(grads))


def _port_loss_and_grads(name: str, **kw) -> tuple:
    _, tcfg = _configs(name, dtype="float32", **kw)
    params = params_from_numpy(_weights(tcfg), "cpu")
    for leaf in ttree.tree_leaves(params):
        leaf.requires_grad_()
    batch = {k: torch.as_tensor(v) for k, v in _batch(tcfg).items()}
    loss, metrics = build_model(tcfg).loss(params, batch)
    loss.backward()
    grads = {k: (np.zeros(tuple(p.shape), np.float32) if p.grad is None
                 else _np(p.grad))
             for k, p in ttree.flatten_dict(params).items()}
    return float(loss), {k: float(v) for k, v in metrics.items()}, grads


def _assert_same_loss(got: tuple, want: tuple) -> None:
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    for k in ("xent", "moe_aux"):
        np.testing.assert_allclose(got[1][k], want[1][k], rtol=1e-5,
                                   atol=1e-7)
    assert sorted(got[2]) == sorted(want[2])
    for k, w in want[2].items():
        np.testing.assert_allclose(got[2][k], w, err_msg=k, **F32)


@pytest.mark.parametrize("name", LOSS_CONFIGS)
def test_loss_fn_and_every_gradient_match_jax(name):
    """``Model.loss`` (``loss_fn``: the backbone under the config's remat,
    the fused chunked head loss, the MoE aux) and the gradient of every
    parameter leaf against ``jax.value_and_grad`` of the reference's
    ``loss_fn``: dense with qk-norm (qwen3), local and global layers with
    both softcaps (gemma2), MoE with its index writes (mixtral), embeds and
    M-RoPE positions (qwen2-vl), codebooks (musicgen), the RWKV-6 chunked
    WKV and the RG-LRU scan with their in-place writes (rwkv6,
    recurrentgemma)."""
    _assert_same_loss(_port_loss_and_grads(name), _jax_loss_and_grads(name))


@pytest.mark.parametrize("policy", ["full", "dots", "none"])
def test_remat_policies_give_the_reference_gradient(policy):
    """Each remat policy of the port (``"full"`` checkpoint per group,
    ``"dots"`` keeping the matrix products, ``"none"``) gives the
    reference's loss and gradients: the recompute changes no value."""
    _assert_same_loss(_port_loss_and_grads("gemma2-27b",
                                           remat_policy=policy),
                      _jax_loss_and_grads("gemma2-27b"))


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["qwen3-0.6b", "mixtral-8x22b"])
def test_train_step_matches_jax(name):
    """One ``make_train_step`` step in f32 from the same weights and state:
    loss, grad_norm and lr, then the params and the AdamW state after it."""
    jcfg, tcfg = _configs(name, dtype="float32")
    w = numpy_params(tcfg, 0)
    batch = _batch(tcfg)
    kw = dict(lr=1e-3, warmup_steps=0, total_steps=10)
    jp = jax.tree_util.tree_map(jnp.asarray, w)
    jp, js, jm = jax.jit(j_make_train_step(jbuild(jcfg), JAdamW(**kw)))(
        jp, j_init_opt_state(jp), jax.tree_util.tree_map(jnp.asarray, batch))
    tp = params_from_numpy(w, "cpu")
    tp, ts, tm = make_train_step(build_model(tcfg), AdamWConfig(**kw))(
        tp, init_opt_state(tp), {k: torch.as_tensor(v)
                                 for k, v in batch.items()})
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-4)
    assert float(tm["lr"]) == float(jm["lr"])
    assert int(ts["step"]) == int(js["step"]) == 1
    for got, want in ((tp, jp), (ts["mu"], js["mu"])):
        want = _flat_np(want)
        for k, g in _flat_np(got).items():
            np.testing.assert_allclose(g, want[k], atol=1e-4, rtol=0,
                                       err_msg=k)


