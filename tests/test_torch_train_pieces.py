"""Pieces of the port's training path against the JAX package's, on the
CPU: ``cross_entropy``, the attention's gradient, the tree helpers, and
checkpoints written by one package and restored by the other.

The port's attention takes its plain forward here (CPU tensors) and the
backward the card runs, ``flash_attention_backward``; the JAX package's
gradient is ``jax.vjp`` of ``repro/kernels/ref.py::attention_ref``.

Tolerances: ``cross_entropy`` and the attention's gradient in f32 within
``F32``, atol and rtol 1e-5 (both run the same f32 arithmetic in another
order; 5e-7 measured); the attention in bf16 within 2e-2, the
reference's bf16 tolerance; checkpoints equal by bits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import attention_ref as j_attention_ref
from repro.models import layers as jlayers
from repro.train.checkpoint import CheckpointManager as JCheckpoints
from repro.utils import tree as jtree
from repro_torch.configs import SMOKE_ARCHS as T_SMOKE
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_backward,
                                                 flash_attention_plain)
from repro_torch.models import layers as tlayers
from repro_torch.models.convert import numpy_params, params_from_numpy
from repro_torch.train.checkpoint import CheckpointManager, _flatten
from repro_torch.utils import tree as ttree
from test_torch_train_parity import F32, _np

BF16 = dict(atol=2e-2, rtol=2e-2)


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cap,z_loss", [(None, 0.0), (30.0, 0.0),
                                        (None, 1e-3), (5.0, 1e-3)])
@pytest.mark.parametrize("shape", [(2, 16, 97), (2, 8, 3, 97)])
def test_cross_entropy_matches_jax(cap, z_loss, shape):
    """f32 logits (a codebook model's too), softcapped, logsumexp minus the
    gold logit, plus z_loss; the value and the gradient wrt the logits."""
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal(shape) * 8).astype(np.float32)
    labels = rng.integers(0, shape[-1], shape[:-1]).astype(np.int32)
    want, jgrad = jax.value_and_grad(
        lambda x: jlayers.cross_entropy(x, jnp.asarray(labels), cap,
                                        z_loss))(jnp.asarray(logits))
    x = torch.as_tensor(logits).requires_grad_()
    got = tlayers.cross_entropy(x, torch.as_tensor(labels), cap, z_loss)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), **F32)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgrad), **F32)


# ---------------------------------------------------------------------------
# the attention's gradient
# ---------------------------------------------------------------------------
ATTN_CASES = {  # name: (B, H, KV, Sq, Sk, D, causal, window, softcap, scale)
    "causal": (2, 4, 4, 40, 40, 16, True, None, None, None),
    "window": (2, 4, 4, 40, 40, 16, True, 8, None, None),
    "softcap": (2, 4, 4, 40, 40, 16, True, None, 5.0, None),
    "gqa": (2, 8, 2, 40, 40, 16, True, None, None, None),
    "scale": (1, 4, 2, 33, 33, 8, True, None, None, 0.3),
    "all": (2, 8, 2, 48, 48, 16, True, 5, 2.0, 1 / 3),
    "not_causal": (1, 4, 1, 24, 24, 8, False, None, 3.0, None),
    "sq_below_sk": (1, 4, 2, 24, 40, 8, True, 16, None, None),
}


def _attn_inputs(case, seed=0):
    B, H, KV, Sq, Sk, D = case[:6]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, Sq, D)).astype(np.float32)
    k = rng.standard_normal((B, KV, Sk, D)).astype(np.float32)
    v = rng.standard_normal((B, KV, Sk, D)).astype(np.float32)
    do = rng.standard_normal((B, H, Sq, D)).astype(np.float32)
    return q, k, v, do


def _jax_attention_vjp(q, k, v, do, dtype, causal, window, softcap, scale):
    """(dq, dk, dv) of ``repro.kernels.ref.attention_ref`` by ``jax.vjp``,
    in the port's (B, heads, S, D) layout; GQA by repeating k and v per
    query head inside the function, so the sum over a group is JAX's."""
    g = q.shape[1] // k.shape[1]

    def f(q, k, v):
        t = lambda x: jnp.swapaxes(x, 1, 2)
        return t(j_attention_ref(t(q), t(jnp.repeat(k, g, 1)),
                                 t(jnp.repeat(v, g, 1)), causal=causal,
                                 window=window, softcap=softcap, scale=scale))
    args = [jnp.asarray(a).astype(dtype) for a in (q, k, v)]
    _, vjp = jax.vjp(f, *args)
    return vjp(jnp.asarray(do).astype(dtype))


@pytest.mark.parametrize("name", sorted(ATTN_CASES))
def test_attention_gradient_matches_jax_vjp(name):
    """``FlashAttentionFn``'s dq, dk, dv (its forward the plain version on
    the CPU, its backward ``flash_attention_backward``) against
    ``jax.vjp`` of ``attention_ref``, in f32."""
    *_, causal, window, softcap, scale = ATTN_CASES[name]
    q, k, v, do = _attn_inputs(ATTN_CASES[name])
    want = _jax_attention_vjp(q, k, v, do, jnp.float32, causal, window,
                              softcap, scale)
    ts = [torch.as_tensor(a).requires_grad_() for a in (q, k, v)]
    out = flash_attention(*ts, causal=causal, window=window, softcap=softcap,
                          scale=scale)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, ts, torch.as_tensor(do))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), **F32)


@pytest.mark.parametrize("rows", [7, 16])
def test_attention_backward_in_chunks_matches_jax_vjp(rows):
    """The backward's query chunks (``rows`` rows at a time, here less
    than a sequence, with a short last chunk) against ``jax.vjp``, on the
    case with everything: GQA, window, softcap, custom scale."""
    *_, causal, window, softcap, scale = ATTN_CASES["all"]
    q, k, v, do = _attn_inputs(ATTN_CASES["all"], seed=1)
    want = _jax_attention_vjp(q, k, v, do, jnp.float32, causal, window,
                              softcap, scale)
    got = flash_attention_backward(
        *(torch.as_tensor(a) for a in (q, k, v, do)), causal=causal,
        window=window, softcap=softcap, scale=scale, rows=rows)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), **F32)


def test_attention_gradient_in_bf16_matches_jax_vjp():
    """bf16 q, k, v: the gradients come back in bf16, within the
    reference's bf16 tolerance of ``jax.vjp`` in bf16."""
    *_, causal, window, softcap, scale = ATTN_CASES["all"]
    q, k, v, do = _attn_inputs(ATTN_CASES["all"], seed=2)
    want = _jax_attention_vjp(q, k, v, do, jnp.bfloat16, causal, window,
                              softcap, scale)
    ts = [torch.as_tensor(a).bfloat16().requires_grad_() for a in (q, k, v)]
    out = flash_attention(*ts, causal=causal, window=window, softcap=softcap,
                          scale=scale)
    got = torch.autograd.grad(out, ts, torch.as_tensor(do).bfloat16())
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(_np(g), _np(w), **BF16)


def test_attention_needs_no_graph_when_serving():
    """Under ``torch.inference_mode`` (the session's steps) the forward is
    all that runs: no graph, nothing saved, the plain version's values."""
    q, k, v, _ = _attn_inputs(ATTN_CASES["gqa"])
    ts = [torch.as_tensor(a) for a in (q, k, v)]
    with torch.inference_mode():
        out = flash_attention(*ts)
    assert out.grad_fn is None and not out.requires_grad
    assert torch.equal(out, flash_attention_plain(*ts))


def test_tree_helpers_match_jax():
    """``utils/tree.py`` against the reference's on the same tree: counts,
    bytes, the cast of every floating leaf (ints untouched), flatten."""
    w = numpy_params(T_SMOKE["qwen3-0.6b"], 0)
    tree = {"p": w, "step": np.int32(3)}
    jt = jax.tree_util.tree_map(jnp.asarray, tree)
    tt = params_from_numpy(tree, "cpu")
    assert ttree.tree_param_count(tt) == jtree.tree_param_count(jt)
    assert ttree.tree_size_bytes(tt) == jtree.tree_size_bytes(jt)
    jc, tc = jtree.tree_cast(jt, jnp.bfloat16), ttree.tree_cast(tt,
                                                              torch.bfloat16)
    assert tc["step"].dtype == torch.int32 and jc["step"].dtype == jnp.int32
    assert all(x.dtype == torch.bfloat16 for x in ttree.tree_leaves(tc["p"]))
    assert ttree.tree_size_bytes(tc) == jtree.tree_size_bytes(jc)
    assert sorted(ttree.flatten_dict(tt)) == sorted(jtree.flatten_dict(jt))
    assert [tuple(x.shape) for x in ttree.tree_leaves(tt)] == \
        [x.shape for x in jax.tree_util.tree_leaves(jt)]


# ---------------------------------------------------------------------------
# checkpoints across the packages
# ---------------------------------------------------------------------------
def _train_state(seed=0):
    """(params, AdamW state) as numpy: smoke weights, moments from a seed,
    step 7."""
    w = numpy_params(T_SMOKE["qwen3-0.6b"], seed)
    rng = np.random.default_rng(seed + 5)
    mom = lambda: jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), w)
    return w, {"step": np.int32(7), "mu": mom(), "nu": mom()}


def _to_torch(state: tuple) -> tuple:
    return tuple(ttree.tree_map(lambda a: torch.as_tensor(np.asarray(a)), t)
                 for t in state)


def _same_bits(got, want) -> None:
    g = {k: _np(v) for k, v in _flatten(got).items()}
    w = {k: _np(v) for k, v in _flatten(want).items()}
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
        assert g[k].tobytes() == w[k].tobytes(), k


def test_checkpoint_from_jax_restores_in_the_port(tmp_path):
    """The JAX package's ``CheckpointManager`` writes (params, opt_state);
    the port's restores it, equal by bits, on its device."""
    state = _train_state()
    JCheckpoints(str(tmp_path)).save(
        3, jax.tree_util.tree_map(jnp.asarray, state))
    template = _to_torch(state)
    got, step = CheckpointManager(str(tmp_path)).restore(template,
                                                         device="cpu")
    assert step == 3
    _same_bits(got, state)


def test_checkpoint_from_the_port_restores_in_jax(tmp_path):
    """The port's ``CheckpointManager`` writes (params, opt_state) as
    tensors; the JAX package's restores it, equal by bits."""
    state = _train_state(seed=1)
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(4, _to_torch(state))
    mgr.wait()
    mgr = JCheckpoints(str(tmp_path))
    got, step = mgr.restore(jax.tree_util.tree_map(jnp.asarray, state))
    assert step == 4
    _same_bits(got, state)
