"""The port's model layers (repro_torch/models) against the JAX package's.

The same inputs and weights, made from a seed with numpy, go through each
function of ``repro.models`` and its counterpart in ``repro_torch.models``
on the CPU: ``rms_norm``, the rotary embeddings (M-RoPE too), the MLP,
``attention_full`` (global, local, softcap), ``attention_decode`` (a bf16
or int8 cache, ``valid < L`` and the ring wrap) and ``moe_apply`` (with
drops, and with a routing tie). The port's attention takes its plain
version here (CPU tensors), the kernel's arithmetic step by step.

Tolerances: f32 ``F32`` (1e-5, absolute and relative): both packages run
the same f32 arithmetic, in another order of summation. bf16 ``BF16``
(2e-2), the reference's own (tests/test_system.py, decode against
forward). The activations are held by bits: the port repeats the
reference's bf16 rounding steps (``models/layers.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKE_ARCHS
from repro.configs.base import ModelConfig
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro_torch.configs import SMOKE_ARCHS as T_SMOKE
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.kernels.ref import attention_ref
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import moe as tmoe
from repro_torch.models.convert import params_from_numpy

F32 = dict(atol=1e-5, rtol=1e-5)
BF16 = dict(atol=2e-2, rtol=2e-2)
DTYPES = {"float32": (jnp.float32, torch.float32, F32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16)}


def _np(x):
    """A JAX array or a tensor as a float32 (or integer) numpy array."""
    if isinstance(x, torch.Tensor):
        return (x.float() if x.is_floating_point() else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == jnp.bfloat16 else x


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _weights(specs, seed):
    """numpy weights for a Spec tree of either package: normal leaves at
    their Spec scale, the zero-initialized ones (norm scales, biases) at
    0.1 so that they take part."""
    rng = np.random.default_rng(seed)

    def draw(s):
        if isinstance(s, dict):
            return {k: draw(s[k]) for k in sorted(s)}
        std = 0.1 if s.init == "zeros" else tlayers.std_of(s)
        return rng.standard_normal(s.shape).astype(np.float32) * \
            np.float32(std)
    return draw(specs)


def _pair(tree):
    """(JAX tree, port tree) of the same numpy tree, f32 master weights."""
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            params_from_numpy(tree, "cpu"))


def _attn_cfg(**kw):
    base = dict(name="t", family="dense", n_layers=1, d_model=32, n_heads=4,
                n_kv_heads=2, head_dim=8, d_ff=64, vocab_size=64,
                rope_theta=1e4)
    base.update(kw)
    return ModelConfig(**base), TModelConfig(**base)


def _rope(S, B, hd, theta, positions=None):
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy() \
        if positions is None else positions
    return (jlayers.rope_angles(jnp.asarray(pos), hd, theta),
            tlayers.rope_angles(torch.as_tensor(pos), hd, theta))


# ---------------------------------------------------------------------------
# norms, activations, rotary embeddings, MLP
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("upcast", [True, False])
def test_rms_norm_matches_jax(dtype, upcast):
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, 64)).astype(np.float32) * 3
    scale = rng.standard_normal(64).astype(np.float32) * 0.1
    want = jlayers.rms_norm(jnp.asarray(x).astype(jdt), jnp.asarray(scale),
                            1e-6, upcast)
    got = tlayers.rms_norm(torch.as_tensor(x).to(tdt), torch.as_tensor(scale),
                           1e-6, upcast)
    assert got.dtype == tdt
    _close(got, want, tol)


@pytest.mark.parametrize("name", ["silu", "gelu", "relu"])
def test_activations_match_jax_by_bits_in_bf16(name):
    x = np.random.default_rng(1).standard_normal(1 << 14).astype(
        np.float32) * 4
    want = jlayers.act_fn(name)(jnp.asarray(x).astype(jnp.bfloat16))
    got = tlayers.act_fn(name)(torch.as_tensor(x).bfloat16())
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("mrope", [False, True])
def test_rope_matches_jax(mrope):
    B, S, hd = 2, 24, 16
    rng = np.random.default_rng(2)
    if mrope:
        pos = rng.integers(0, 100, (3, B, S)).astype(np.int32)
        js, jc = jlayers.rope_angles(jnp.asarray(pos), hd, 1e4, (2, 3, 3))
        ts, tc = tlayers.rope_angles(torch.as_tensor(pos), hd, 1e4, (2, 3, 3))
    else:
        (js, jc), (ts, tc) = _rope(S, B, hd, 1e4)
    _close(ts, js, F32)
    _close(tc, jc, F32)
    x = rng.standard_normal((B, S, 4, hd)).astype(np.float32)
    for jdt, tdt, tol in DTYPES.values():
        _close(tlayers.apply_rope(torch.as_tensor(x).to(tdt), ts, tc),
               jlayers.apply_rope(jnp.asarray(x).astype(jdt), js, jc), tol)


def test_mrope_sections_reduce_to_rope_for_equal_positions():
    B, S, hd = 2, 16, 32
    pos1d = torch.arange(S, dtype=torch.int32).expand(B, S)
    s1, c1 = tlayers.rope_angles(pos1d, hd, 1e4)
    s2, c2 = tlayers.rope_angles(pos1d.expand(3, B, S), hd, 1e4,
                                 mrope_sections=(4, 6, 6))
    np.testing.assert_allclose(s1.numpy(), s2.numpy(), atol=1e-6)
    np.testing.assert_allclose(c1.numpy(), c2.numpy(), atol=1e-6)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp_matches_jax(dtype, act):
    jdt, tdt, tol = DTYPES[dtype]
    jcfg, tcfg = _attn_cfg(mlp_act=act)
    w = _weights(jlayers.mlp_specs(jcfg), 3)
    jp, tp = _pair(w)
    x = np.random.default_rng(4).standard_normal((2, 8, 32)).astype(
        np.float32)
    _close(tlayers.mlp_apply(tp, torch.as_tensor(x).to(tdt), tcfg),
           jlayers.mlp_apply(jp, jnp.asarray(x).astype(jdt), jcfg), tol)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("local,softcap,chunk",
                         [(False, None, 16), (True, None, 8),
                          (False, 20.0, 32), (True, 10.0, 16)])
def test_attention_full_matches_jax(local, softcap, chunk, dtype):
    """Mirrors tests/test_models.py::test_chunked_attention_matches_ref:
    the port's one-call attention against the reference's chunked one,
    and against the port's dense ``attention_ref``."""
    jdt, tdt, tol = DTYPES[dtype]
    jcfg, tcfg = _attn_cfg(sliding_window=24 if local else None,
                           attn_logit_softcap=softcap, attn_chunk=chunk,
                           qkv_bias=True, qk_norm=True)
    w = _weights(jattn.attn_specs(jcfg), 5)
    jp, tp = _pair(w)
    B, S = 2, 64
    x = np.random.default_rng(6).standard_normal((B, S, 32)).astype(
        np.float32) * 0.5
    (js, jc), (ts, tc) = _rope(S, B, 8, 1e4)
    want, (jk, jv) = jattn.attention_full(jp, jnp.asarray(x).astype(jdt),
                                          jcfg, js, jc, local=local)
    got, (tk, tv) = tattn.attention_full(tp, torch.as_tensor(x).to(tdt),
                                         tcfg, ts, tc, local=local)
    assert got.dtype == tdt and tk.shape == (B, S, 2, 8)
    _close(got, want, tol)
    _close(tk, jk, tol)
    _close(tv, jv, tol)
    if dtype == "float32":
        q, k, v = tattn._project_qkv(tp, torch.as_tensor(x), tcfg, ts, tc)
        r = attention_ref(q, k.repeat_interleave(2, dim=2),
                          v.repeat_interleave(2, dim=2), causal=True,
                          window=24 if local else None, softcap=softcap,
                          scale=8 ** -0.5)
        _close(got, tattn._out_proj(tp, r, torch.float32), dict(
            atol=2e-4, rtol=2e-3))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
@pytest.mark.parametrize("local", [False, True])
def test_attention_decode_matches_jax(local, kv, dtype):
    """Steps at pos 3 and 5 (fewer valid slots than L = 8), 7 (all), 8
    and 13 (the ring wraps), each from the cache the last step left: the
    outputs and the whole caches against the reference's."""
    jdt, tdt, tol = DTYPES[dtype]
    jcfg, tcfg = _attn_cfg(sliding_window=8 if local else None,
                           attn_logit_softcap=30.0, kv_cache_dtype=kv,
                           dtype=dtype, qk_norm=True)
    w = _weights(jattn.attn_specs(jcfg), 7)
    jp, tp = _pair(w)
    B, L = 2, 8
    rng = np.random.default_rng(8)
    init = rng.standard_normal((2, B, L, 2, 8)).astype(np.float32)
    if kv == "int8":
        init = np.round(np.clip(init * 127 / 16 * 4, -127, 127))
        jcache = {n: jnp.asarray(init[i]).astype(jnp.int8)
                  for i, n in enumerate("kv")}
        tcache = {n: torch.as_tensor(init[i]).to(torch.int8)
                  for i, n in enumerate("kv")}
    else:
        jcache = {n: jnp.asarray(init[i]).astype(jdt)
                  for i, n in enumerate("kv")}
        tcache = {n: torch.as_tensor(init[i]).to(tdt)
                  for i, n in enumerate("kv")}
    for pos in (3, 5, 7, 8, 13):
        x = rng.standard_normal((B, 1, 32)).astype(np.float32)
        p = np.full((B, 1), pos, np.int32)
        (js, jc), (ts, tc) = _rope(1, B, 8, 1e4, positions=p)
        want, jcache = jattn.attention_decode(
            jp, jnp.asarray(x).astype(jdt), jcache,
            jnp.asarray(pos, jnp.int32), jcfg, js, jc, local=local)
        got, tcache = tattn.attention_decode(
            tp, torch.as_tensor(x).to(tdt), tcache, pos, tcfg, ts, tc,
            local=local)
        _close(got, want, tol)
        for n in "kv":
            assert tcache[n].dtype == (torch.int8 if kv == "int8" else tdt)
            if kv == "int8" and dtype == "float32":
                # int8 rounding of equal f32 values: at most one step where
                # a value lies within the f32 error of a rounding boundary
                assert np.abs(_np(tcache[n]) - _np(jcache[n])).max() <= 1
            else:
                _close(tcache[n], jcache[n], tol)


def test_int8_kv_roundtrip_matches_jax():
    jcfg, tcfg = _attn_cfg(kv_cache_dtype="int8")
    x = np.random.default_rng(9).standard_normal(4096).astype(np.float32) * 8
    jq = jattn.quantize_kv(jcfg, jnp.asarray(x))
    tq = tattn.quantize_kv(tcfg, torch.as_tensor(x))
    np.testing.assert_array_equal(_np(tq), _np(jq))
    np.testing.assert_array_equal(
        _np(tattn.dequantize_kv(tcfg, tq, torch.float32)),
        _np(jattn.dequantize_kv(jcfg, jq, jnp.float32)))


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------
def _moe_pair(name, seed, **kw):
    jcfg = SMOKE_ARCHS[name].replace(**kw)
    tcfg = T_SMOKE[name].replace(**kw)
    w = _weights(jmoe.moe_specs(jcfg), seed)
    return jcfg, tcfg, w


def _drops(probs, cfg, T):
    """How many (token, choice) pairs the capacity drops, counted here from
    the port's routing."""
    idx = tmoe.top_k(probs, cfg.top_k)[1].reshape(-1)
    counts = torch.bincount(idx, minlength=cfg.n_experts)
    return int((counts - tmoe.capacity(cfg, T)).clamp(min=0).sum())


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", ["drops", "tie"])
def test_moe_matches_jax(case, dtype):
    """``drops``: capacity factor 0.5, so that experts overflow; ``tie``:
    experts 1 and 2 have the same router column, so that tokens whose top
    two are {1 or 2, 3} tie at the k boundary, and ``jax.lax.top_k``'s
    order (the lower index) decides which expert they reach."""
    jdt, tdt, tol = DTYPES[dtype]
    jcfg, tcfg, w = _moe_pair("moonshot-v1-16b-a3b", 10,
                              capacity_factor=0.5 if case == "drops" else 4.0)
    B, S = 2, 16
    x = np.random.default_rng(11).standard_normal((B, S, 64)).astype(
        np.float32)
    if case == "tie":
        w["router"][:, 0] = -1.0 * np.abs(w["router"][:, 0])
        w["router"][:, 2] = w["router"][:, 1]
        x[..., :] = np.abs(x)
    jp, tp = _pair(w)
    probs = torch.softmax(torch.as_tensor(x).reshape(-1, 64)
                          @ tp["router"], -1)
    if case == "drops":
        assert _drops(probs, tcfg, B * S) > 0
    else:                 # the tie is met both at the top and at the boundary
        _, idx = tmoe.top_k(probs, 2)
        assert torch.equal(probs[:, 1], probs[:, 2])
        with3 = (idx == 3).any(-1)
        assert 0 < int(with3.sum()) < B * S
        assert torch.equal(idx[with3].sort(-1).values,
                           torch.tensor([1, 3]).expand(int(with3.sum()), 2))
        assert torch.equal(idx[~with3], torch.tensor([1, 2]).expand(
            B * S - int(with3.sum()), 2))
    want, jaux = jmoe.moe_apply(jp, jnp.asarray(x).astype(jdt), jcfg)
    got, taux = tmoe.moe_apply(tp, torch.as_tensor(x).to(tdt), tcfg)
    assert got.dtype == tdt
    _close(got, want, tol)
    _close(taux, jaux, F32)


def test_top_k_breaks_ties_to_the_lower_index():
    """On router probabilities (no NaN, no -0.0), ``top_k`` gives
    ``jax.lax.top_k``'s values and indices."""
    x = np.array([[0.2, 0.3, 0.3, 0.1, 0.3],
                  [0.5, 0.5, 0.5, 0.5, 0.5],
                  [0.0, 0.0, 0.1, 0.1, 0.0]], np.float32)
    for k in (1, 2, 3, 5):
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        tv, ti = tmoe.top_k(torch.as_tensor(x), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_moe_capacity_and_conservation():
    """Mirrors tests/test_models.py::test_moe_capacity_and_conservation."""
    cfg = T_SMOKE["moonshot-v1-16b-a3b"]
    params = params_from_numpy(_weights(tmoe.moe_specs(cfg), 12), "cpu")
    x = torch.as_tensor(np.random.default_rng(13).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32))
    y, aux = tmoe.moe_apply(params, x, cfg)
    assert y.shape == x.shape
    assert np.isfinite(float(aux)) and float(aux) > 0
    assert bool(torch.isfinite(y).all())
    C = tmoe.capacity(cfg, 2 * 16)
    assert C >= cfg.top_k and C % 8 == 0
    assert C == jmoe.capacity(SMOKE_ARCHS["moonshot-v1-16b-a3b"], 2 * 16)


def test_moe_matches_dense_reference_when_no_drops():
    """Mirrors tests/test_models.py::
    test_moe_matches_dense_reference_when_no_drops, on the port."""
    cfg = T_SMOKE["mixtral-8x22b"].replace(capacity_factor=64.0)
    p = params_from_numpy(_weights(tmoe.moe_specs(cfg), 14), "cpu")
    B, S = 2, 8
    x = torch.as_tensor(np.random.default_rng(15).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32))
    y, _ = tmoe.moe_apply(p, x, cfg)
    xf = x.reshape(B * S, -1)
    probs = torch.softmax(xf @ p["router"], -1)
    topv, topi = tmoe.top_k(probs, cfg.top_k)
    topv = topv / topv.sum(-1, keepdim=True)
    act = torch.nn.functional.silu(torch.einsum("td,edf->tef", xf, p["wg"])) \
        * torch.einsum("td,edf->tef", xf, p["wi"])
    per_expert = torch.einsum("tef,efd->ted", act, p["wo"])
    ref = torch.zeros_like(xf)
    for k in range(cfg.top_k):
        sel = per_expert[torch.arange(B * S), topi[:, k]]
        ref = ref + topv[:, k, None] * sel
    np.testing.assert_allclose(y.reshape(B * S, -1).numpy(), ref.numpy(),
                               atol=1e-4, rtol=1e-3)


# ---------------------------------------------------------------------------
# specs and initialization
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("init", ["zeros", "ones", "decay", "lambda"])
def test_materialize_fixed_inits_match_jax(init):
    """The initializers that draw nothing give the reference's values."""
    spec = (2, 3, 24)
    want = jlayers.materialize(jlayers.Spec(spec, ("a", "b", "c"), init),
                               jax.random.PRNGKey(0), jnp.float32)
    got = tlayers.materialize(tlayers.Spec(spec, ("a", "b", "c"), init),
                              torch.Generator().manual_seed(0),
                              torch.float32, "cpu")
    _close(got, want, F32)


@pytest.mark.parametrize("init", ["normal", "uniform_small"])
def test_materialize_random_inits_follow_the_spec(init):
    """The drawing initializers: the reference's distribution (its std, or
    the uniform range), from the generator given, in the dtype given."""
    spec = tlayers.Spec((64, 512), ("a", "b"), init)
    gen = torch.Generator().manual_seed(1)
    got = tlayers.materialize(spec, gen, torch.float32, "cpu")
    again = tlayers.materialize(spec, torch.Generator().manual_seed(1),
                                torch.bfloat16, "cpu")
    assert again.dtype == torch.bfloat16 and tuple(got.shape) == (64, 512)
    assert torch.equal(got.bfloat16(), again)
    x = got
    if init == "normal":
        assert abs(float(x.std()) - 64 ** -0.5) < 0.01
    else:
        assert float(x.abs().max()) <= 0.01 and float(x.std()) > 0.005


# the recurrent blocks' weights the reference reads from its f32 master
# (repro/models/rwkv6.py::_project, layers.group_norm; griffin.py::_gates)
F32_RECURRENT = {"w0", "wd1", "wd2", "u", "ln_x_scale", "ln_x_bias",
                 "gate_a", "gate_a_b", "gate_x", "gate_x_b", "lam"}


@pytest.mark.parametrize("name", ["qwen3-0.6b", "mixtral-8x22b",
                                  "musicgen-large", "rwkv6-1.6b",
                                  "recurrentgemma-9b"])
def test_init_params_has_the_reference_tree(name):
    """``Model.init``, ``numpy_params`` and the reference's ``init`` give
    the same tree of shapes and dtypes; ``cast_params`` casts every weight
    to the activation dtype but the ones the reference reads in f32 (for
    the recurrent blocks, the 11 of ``F32_RECURRENT``)."""
    from repro.models import build_model as jbuild
    from repro_torch.models import build_model
    from repro_torch.models.convert import numpy_params
    cfg = T_SMOKE[name]
    model = build_model(cfg)
    got = model.init(torch.Generator().manual_seed(0), "cpu")
    want = jax.eval_shape(jbuild(SMOKE_ARCHS[name]).init,
                          jax.random.PRNGKey(0))

    def shapes(tree):
        return jax.tree_util.tree_map(
            lambda a: (tuple(a.shape), str(a.dtype).removeprefix("torch.")),
            tree)
    assert shapes(got) == shapes(want) == shapes(numpy_params(cfg, 0))
    cast = model.cast_params(got)
    kept = set()
    for path, leaf in jax.tree_util.tree_leaves_with_path(cast):
        key = path[-1].key
        f32 = key.endswith("norm") or key == "router" or (
            key == "embed" and cfg.n_codebooks > 0) or key in F32_RECURRENT
        assert leaf.dtype == (torch.float32 if f32 else torch.bfloat16), path
        kept |= {key} & F32_RECURRENT
    assert kept == {"ssm": F32_RECURRENT - {"gate_a", "gate_a_b", "gate_x",
                                            "gate_x_b", "lam"},
                    "hybrid": {"gate_a", "gate_a_b", "gate_x", "gate_x_b",
                               "lam"}}.get(cfg.family, set())


@pytest.mark.parametrize("sliced", [False, True])
@pytest.mark.parametrize("name", sorted(T_SMOKE))
def test_init_cast_params_is_the_cast_of_init(name, sliced, monkeypatch):
    """``Model.init_cast`` (init leaf by leaf, each cast before the next is
    drawn) equals ``cast_params(init(...))`` by bits and dtypes, from the
    same seed: with no leaf sliced, and with every stacked leaf drawn one
    group at a time (``SLICE_BYTES`` 0): on the CPU the slices' draws are
    the whole leaf's."""
    from repro_torch.models import build_model
    from repro_torch.models import transformer as tfm
    from repro_torch.utils.tree import flatten_dict
    cfg = T_SMOKE[name]
    model = build_model(cfg)
    want = flatten_dict(model.cast_params(
        model.init(torch.Generator().manual_seed(3), "cpu")))
    if sliced:
        monkeypatch.setattr(tfm, "SLICE_BYTES", 0)
    got = flatten_dict(model.init_cast(torch.Generator().manual_seed(3),
                                       "cpu"))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and torch.equal(got[k], w), k


def test_init_kv_cache_matches_jax():
    jcfg, tcfg = _attn_cfg(sliding_window=8)
    for local in (False, True):
        want = jattn.init_kv_cache(jcfg, 2, 24, local=local,
                                   dtype=jnp.bfloat16)
        got = tattn.init_kv_cache(tcfg, 2, 24, local=local,
                                  dtype=torch.bfloat16, device="cpu")
        for n in "kv":
            assert tuple(got[n].shape) == want[n].shape
            assert got[n].dtype == torch.bfloat16 and not got[n].any()
