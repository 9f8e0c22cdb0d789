"""The port's recurrent blocks (repro_torch/models/rwkv6.py, griffin.py, and
layers.associative_scan, group_norm, kernels/ref.py::wkv6_ref) against the
JAX package's.

The same inputs and weights, made from a seed with numpy, go through each
function of ``repro.models`` and its counterpart in ``repro_torch.models``
on the CPU, states included. Mirrors tests/test_models.py's WKV6 and RG-LRU
tests (chunked against sequential, scan against a loop).

Tolerances: f32 ``F32`` (1e-5), bf16 ``BF16`` (2e-2), from
tests/test_torch_models.py, or bits where the port repeats the reference's
rounding steps: ``associative_scan`` and the causal conv. A jitted XLA
build on the CPU contracts a multiply and an add into one fused
multiply-add; the scans' combines do the same by ``torch.addcmul``, so they
equal the jitted reference by bits, and a plain combine equals the
op-by-op one. The chunked WKV6 against the exact sequential recurrence is
another algorithm: it is held to the reference's own tolerance for that
comparison (tests/test_models.py::test_wkv6_chunked_matches_sequential).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKE_ARCHS
from repro.kernels.ref import wkv6_ref as jwkv6_ref
from repro.models import griffin as jgriffin
from repro.models import layers as jlayers
from repro.models import rwkv6 as jrwkv6
from repro_torch.configs import SMOKE_ARCHS as T_SMOKE
from repro_torch.kernels.ref import wkv6_ref
from repro_torch.models import griffin as tgriffin
from repro_torch.models import layers as tlayers
from repro_torch.models import rwkv6 as trwkv6
from test_torch_models import DTYPES, F32, _close, _np, _pair, _weights

# the reference's tolerance for chunked against sequential WKV6
WKV_CHUNKED = dict(atol=2e-4, rtol=2e-3)
RWKV, GRIFFIN = "rwkv6-1.6b", "recurrentgemma-9b"


def _wkv_inputs(B, T, H, N, seed):
    """tests/test_models.py's WKV6 inputs: r, k, v, lw, u, S0."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(B, T, H, N)).astype(np.float32)
               for _ in range(3))
    w = rng.uniform(-6, 0.5, size=(B, T, H, N)).astype(np.float32)
    lw = np.maximum(-np.exp(w), trwkv6.LW_CLAMP).astype(np.float32)
    u = rng.normal(size=(H, N)).astype(np.float32)
    S0 = rng.normal(size=(B, H, N, N)).astype(np.float32)
    return r, k, v, lw, u, S0


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _t(*arrays):
    return tuple(torch.as_tensor(a) for a in arrays)


# ---------------------------------------------------------------------------
# layers: associative_scan, group_norm
# ---------------------------------------------------------------------------
def _plain(c1, c2):
    a1, b1 = c1
    a2, b2 = c2
    return a1 * a2, a2 * b1 + b2


@pytest.mark.parametrize("T", [1, 2, 3, 37, 130])
def test_associative_scan_bits_match_jax(T):
    """Non-power-of-two lengths: the plain combine against JAX op by op,
    the fused one (``griffin._combine``) against JAX jitted, by bits; both
    results, the products too."""
    rng = np.random.default_rng(T)
    a = np.exp(-np.exp(rng.uniform(-4, 0, (2, T, 16)))).astype(np.float32)
    x = rng.normal(size=(2, T, 16)).astype(np.float32)
    want = jax.lax.associative_scan(_plain, _j(a, x), axis=1)
    got = tlayers.associative_scan(_plain, _t(a, x), dim=1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    want = jax.jit(lambda a, x: jax.lax.associative_scan(
        _plain, (a, x), axis=1))(*_j(a, x))
    got = tlayers.associative_scan(tgriffin._combine, _t(a, x), dim=1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_associative_scan_is_not_sequential():
    """The reference's association is not a left-to-right loop: on a sum of
    values of mixed magnitude the two differ, and the port takes the
    reference's."""
    x = np.random.default_rng(5).normal(size=(1, 64)).astype(np.float32) \
        * np.logspace(-4, 4, 64, dtype=np.float32)
    (got,) = tlayers.associative_scan(lambda a, b: (a[0] + b[0],),
                                      _t(x), dim=1)
    (want,) = jax.lax.associative_scan(lambda a, b: (a[0] + b[0],),
                                       _j(x), axis=1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not np.array_equal(got.numpy(), np.cumsum(x, axis=1))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_group_norm_matches_jax(dtype):
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 8, 64)).astype(np.float32) * 3 + 1
    scale = rng.standard_normal(64).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32) * 0.1
    want = jlayers.group_norm(jnp.asarray(x).astype(jdt), jnp.asarray(scale),
                              jnp.asarray(bias), 4)
    got = tlayers.group_norm(torch.as_tensor(x).to(tdt),
                             torch.as_tensor(scale), torch.as_tensor(bias), 4)
    assert got.dtype == tdt
    _close(got, want, tol)


# ---------------------------------------------------------------------------
# WKV6
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("T", [16, 48, 96, 130])
@pytest.mark.parametrize("chunk", [16, 32])
def test_wkv6_matches_jax_and_sequential(T, chunk):
    """Mirrors tests/test_models.py::test_wkv6_chunked_matches_sequential:
    the port's chunked ``wkv6`` (the padded single chunk where T is no
    multiple of the chunk) against the JAX package's at ``F32`` and
    against the port's ``wkv6_ref`` at the reference's tolerance; the two
    ``wkv6_ref``s at ``F32``."""
    args = _wkv_inputs(2, T, 2, 8, seed=T + chunk)
    y, S = trwkv6.wkv6(*_t(*args), chunk=chunk)
    jy, jS = jrwkv6.wkv6(*_j(*args), chunk=chunk)
    _close(y, jy, F32)
    _close(S, jS, F32)
    ry, rS = wkv6_ref(*_t(*args))
    _close(y, ry, WKV_CHUNKED)
    _close(S, rS, WKV_CHUNKED)
    jry, jrS = jwkv6_ref(*_j(*args))
    _close(ry, jry, F32)
    _close(rS, jrS, F32)


# ---------------------------------------------------------------------------
# RWKV-6 time mix, decode and channel mix
# ---------------------------------------------------------------------------
def _rwkv_pair(seed, **kw):
    jcfg = SMOKE_ARCHS[RWKV].replace(**kw)
    tcfg = T_SMOKE[RWKV].replace(**kw)
    w = _weights(jrwkv6.rwkv6_specs(jcfg), seed)
    w["w0"] = np.broadcast_to(np.linspace(-6.0, -0.5, jcfg.d_model,
                                          dtype=np.float32),
                              w["w0"].shape).copy()
    return jcfg, tcfg, _pair(w)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("T,chunk", [(48, 16), (40, 32)])
def test_rwkv6_time_mix_matches_jax(dtype, T, chunk):
    """A fresh state, then a given one (xprev and S): outputs, last x and
    the state against the reference's; chunks of 16 (three of them) and a
    padded single chunk."""
    jdt, tdt, tol = DTYPES[dtype]
    jcfg, tcfg, (jp, tp) = _rwkv_pair(20, scan_chunk=chunk)
    rng = np.random.default_rng(21)
    x = rng.standard_normal((2, T, 64)).astype(np.float32)
    xprev = rng.standard_normal((2, T, 64)).astype(np.float32)
    S0 = rng.standard_normal((2, 4, 16, 16)).astype(np.float32) * 0.1
    for kw in ({}, {"xprev": xprev, "state": S0}):
        jkw = {k: jnp.asarray(v).astype(jdt) if k == "xprev"
               else jnp.asarray(v) for k, v in kw.items()}
        tkw = {k: torch.as_tensor(v).to(tdt) if k == "xprev"
               else torch.as_tensor(v) for k, v in kw.items()}
        want, (jx, jS) = jrwkv6.rwkv6_time_mix(
            jp, jnp.asarray(x).astype(jdt), jcfg, **jkw)
        got, (tx, tS) = trwkv6.rwkv6_time_mix(
            tp, torch.as_tensor(x).to(tdt), tcfg, **tkw)
        assert got.dtype == tdt and tS.dtype == torch.float32
        _close(got, want, tol)
        _close(tx, jx, tol)
        _close(tS, jS, tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rwkv6_decode_matches_jax(dtype):
    """Three steps, each from the state the last one left."""
    jdt, tdt, tol = DTYPES[dtype]
    jcfg, tcfg, (jp, tp) = _rwkv_pair(22)
    rng = np.random.default_rng(23)
    prev = rng.standard_normal((2, 64)).astype(np.float32)
    S = rng.standard_normal((2, 4, 16, 16)).astype(np.float32) * 0.1
    jprev, jS = jnp.asarray(prev).astype(jdt), jnp.asarray(S)
    tprev, tS = torch.as_tensor(prev).to(tdt), torch.as_tensor(S)
    for _ in range(3):
        x = rng.standard_normal((2, 1, 64)).astype(np.float32)
        want, (jprev, jS) = jrwkv6.rwkv6_decode(
            jp, jnp.asarray(x).astype(jdt), jprev, jS, jcfg)
        got, (tprev, tS) = trwkv6.rwkv6_decode(
            tp, torch.as_tensor(x).to(tdt), tprev, tS, tcfg)
        _close(got, want, tol)
        _close(tprev, jprev, tol)
        _close(tS, jS, tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rwkv6_channel_mix_matches_jax(dtype):
    jdt, tdt, tol = DTYPES[dtype]
    jcfg = SMOKE_ARCHS[RWKV]
    w = _weights(jrwkv6.rwkv6_cm_specs(jcfg), 24)
    jp, tp = _pair(w)
    rng = np.random.default_rng(25)
    x = rng.standard_normal((2, 12, 64)).astype(np.float32)
    xprev = rng.standard_normal((2, 1, 64)).astype(np.float32)
    for jkw, tkw in (({}, {}), ({"xprev": jnp.asarray(xprev).astype(jdt)},
                                {"xprev": torch.as_tensor(xprev).to(tdt)})):
        xs = x[:, :1] if jkw else x
        want, jlast = jrwkv6.rwkv6_channel_mix(
            jp, jnp.asarray(xs).astype(jdt), jcfg, **jkw)
        got, tlast = trwkv6.rwkv6_channel_mix(
            tp, torch.as_tensor(xs).to(tdt), T_SMOKE[RWKV], **tkw)
        _close(got, want, tol)
        _close(tlast, jlast, tol)


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("state", [False, True])
def test_causal_conv1d_bits_match_jax_in_bf16(state):
    """K shifted multiplies, each step rounded to bf16, ``+ b`` last: the
    reference's bits, and its new state; a ``conv1d`` that rounds once
    would differ."""
    rng = np.random.default_rng(30)
    u = rng.standard_normal((2, 19, 64)).astype(np.float32)
    w = rng.standard_normal((4, 64)).astype(np.float32) * 0.5
    b = rng.standard_normal(64).astype(np.float32) * 0.1
    st = rng.standard_normal((2, 3, 64)).astype(np.float32) if state else None
    bf = jnp.bfloat16
    want, jst = jgriffin._causal_conv1d(
        *(jnp.asarray(a).astype(bf) for a in (u, w, b)),
        state=None if st is None else jnp.asarray(st).astype(bf))
    got, tst = tgriffin._causal_conv1d(
        *(torch.as_tensor(a).bfloat16() for a in (u, w, b)),
        state=None if st is None else torch.as_tensor(st).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got), _np(want))
    np.testing.assert_array_equal(_np(tst), _np(jst))


@pytest.mark.parametrize("h0", [False, True])
def test_rglru_scan_matches_jax_and_sequential(h0):
    """Mirrors tests/test_models.py::test_rglru_scan_matches_sequential:
    T = 37 against the JAX package's scan and against a sequential loop."""
    B, T, W = 2, 37, 16
    rng = np.random.default_rng(1)
    log_a = -np.exp(rng.uniform(-4, 0, (B, T, W))).astype(np.float32)
    x = rng.normal(size=(B, T, W)).astype(np.float32)
    h = rng.normal(size=(B, W)).astype(np.float32) if h0 else None
    got = tgriffin.rglru_scan(*_t(log_a, x), None if h is None
                              else torch.as_tensor(h))
    want = jgriffin.rglru_scan(*_j(log_a, x), None if h is None
                               else jnp.asarray(h))
    _close(got, want, F32)
    ref = np.zeros((B, T, W), np.float32)
    prev = np.zeros((B, W), np.float32) if h is None else h
    for t in range(T):
        prev = np.exp(log_a[:, t]) * prev + x[:, t]
        ref[:, t] = prev
    _close(got, ref, F32)


def _griffin_pair(seed):
    jcfg = SMOKE_ARCHS[GRIFFIN]
    w = _weights(jgriffin.rglru_specs(jcfg), seed)
    sp = np.linspace(1.25e-4, 1.32e-2, w["lam"].shape[0], dtype=np.float32)
    w["lam"] = np.log(np.expm1(sp))           # a in [0.9, 0.999], as init
    return jcfg, T_SMOKE[GRIFFIN], _pair(w)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rglru_block_matches_jax(dtype):
    """A fresh state, then a given one (conv state and h0)."""
    jdt, tdt, tol = DTYPES[dtype]
    jcfg, tcfg, (jp, tp) = _griffin_pair(31)
    rng = np.random.default_rng(32)
    x = rng.standard_normal((2, 24, 64)).astype(np.float32)
    conv = rng.standard_normal((2, 3, 64)).astype(np.float32)
    h0 = rng.standard_normal((2, 64)).astype(np.float32)
    for given in (False, True):
        jkw = dict(conv_state=jnp.asarray(conv).astype(jdt),
                   h0=jnp.asarray(h0)) if given else {}
        tkw = dict(conv_state=torch.as_tensor(conv).to(tdt),
                   h0=torch.as_tensor(h0)) if given else {}
        want, (jc, jh) = jgriffin.rglru_block(
            jp, jnp.asarray(x).astype(jdt), jcfg, **jkw)
        got, (tc, th) = tgriffin.rglru_block(
            tp, torch.as_tensor(x).to(tdt), tcfg, **tkw)
        assert got.dtype == tdt and th.dtype == tdt
        _close(got, want, tol)
        _close(tc, jc, tol)
        _close(th, jh, tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rglru_decode_matches_jax(dtype):
    """Three steps, each from the states the last one left; h in f32."""
    jdt, tdt, tol = DTYPES[dtype]
    jcfg, tcfg, (jp, tp) = _griffin_pair(33)
    rng = np.random.default_rng(34)
    conv = rng.standard_normal((2, 3, 64)).astype(np.float32)
    h = rng.standard_normal((2, 64)).astype(np.float32)
    jconv, jh = jnp.asarray(conv).astype(jdt), jnp.asarray(h)
    tconv, th = torch.as_tensor(conv).to(tdt), torch.as_tensor(h)
    for _ in range(3):
        x = rng.standard_normal((2, 1, 64)).astype(np.float32)
        want, (jconv, jh) = jgriffin.rglru_decode(
            jp, jnp.asarray(x).astype(jdt), jconv, jh, jcfg)
        got, (tconv, th) = tgriffin.rglru_decode(
            tp, torch.as_tensor(x).to(tdt), tconv, th, tcfg)
        assert th.dtype == torch.float32
        _close(got, want, tol)
        _close(tconv, jconv, tol)
        _close(th, jh, tol)


def test_init_rglru_state_matches_jax():
    jc, jh = jgriffin.init_rglru_state(SMOKE_ARCHS[GRIFFIN], 2, jnp.bfloat16)
    tc, th = tgriffin.init_rglru_state(T_SMOKE[GRIFFIN], 2, torch.bfloat16,
                                       "cpu")
    assert tuple(tc.shape) == jc.shape and tc.dtype == torch.bfloat16
    assert tuple(th.shape) == jh.shape and th.dtype == torch.float32
    assert not tc.any() and not th.any()
