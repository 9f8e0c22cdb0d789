"""Parity of the port's attention (``repro_torch.kernels.ops.flash_attention``
and ``repro_torch.kernels.ref.attention_ref``) with the JAX package's
``repro.kernels.ops.flash_attention`` (Pallas, interpret mode on the CPU) and
``repro.kernels.ref.attention_ref``, on the CPU.

Each case makes its inputs with numpy from a seed and hands the same arrays
to both packages. Tolerances are those of tests/test_kernels.py, 2e-5 atol
and rtol in f32, and 2e-2 in bf16 (sums taken in another order, rounded once
to bf16). On CPU tensors ``flash_attention`` takes its plain version and
counts no launch.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import launch_counts, ops, ref
from repro_torch.kernels.flash_attention import (_blocks,
                                                 attention_tf32_plan,
                                                 attention_tile,
                                                 flash_attention_plain,
                                                 tf32_head_class,
                                                 tf32_split_plain)

SMEM_LIMIT = 232448     # shared memory one block may take on the H100
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _case(b, h, kv, sq, sk, d, *, qk_scale=0.4, dtype="float32", **kw):
    return dict(shape=(b, h, kv, sq, sk, d), qk_scale=qk_scale, dtype=dtype,
                kw=kw)


# tests/test_kernels.py:77-110: gqa 1/4 x four masks, blocks 32, and decode
CASES = {
    f"gqa{g}-{name}": _case(2, 4, 4 // g, 128, 128, 32, causal=causal,
                            window=window, softcap=softcap, block_q=32,
                            block_k=32)
    for g in (1, 4)
    for name, causal, window, softcap in (
        ("causal", True, None, None), ("window32", True, 32, None),
        ("softcap15", True, None, 15.0), ("full", False, None, None))
}
CASES["decode"] = _case(2, 4, 4, 1, 256, 32, qk_scale=1.0, causal=True,
                        block_q=1, block_k=64)
# SMOKE_ARCHS["gemma2-27b"]: 4 heads over 2 kv heads, D 16, window 8,
# softcap 50, query scale 16 ** -0.5
CASES["gemma2-smoke"] = _case(2, 4, 2, 32, 32, 16, causal=True, window=8,
                              softcap=50.0, scale=16.0 ** -0.5)
CASES["mqa-d256"] = _case(1, 4, 1, 32, 32, 256, causal=True)
CASES["sq48-sk128"] = _case(1, 4, 2, 48, 128, 32, causal=True, window=40)
CASES["odd-37x101"] = _case(1, 2, 1, 37, 101, 16, causal=True, window=50)
CASES["bf16-softcap"] = _case(1, 4, 2, 64, 64, 32, dtype="bfloat16",
                              causal=True, softcap=15.0)


def _inputs(shape, qk_scale, seed=0):
    b, h, kv, sq, sk, d = shape
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((b, h, sq, d)) * qk_scale).astype(np.float32)
    k = (rng.standard_normal((b, kv, sk, d)) * qk_scale).astype(np.float32)
    v = rng.standard_normal((b, kv, sk, d)).astype(np.float32)
    return q, k, v


def _to(a, dtype):
    jd, td, _ = DTYPES[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x.astype(jnp.float32))


def _expanded(q, k, v, g):
    """(B, S, H, D) views for attention_ref, kv heads repeated g times."""
    return (q.transpose(0, 2, 1, 3),
            np.repeat(k, g, axis=1).transpose(0, 2, 1, 3),
            np.repeat(v, g, axis=1).transpose(0, 2, 1, 3))


@pytest.mark.parametrize("name", list(CASES))
def test_flash_attention_matches_jax(name):
    c = CASES[name]
    b, h, kv, sq, sk, d = c["shape"]
    tol = DTYPES[c["dtype"]][2]
    q, k, v = _inputs(c["shape"], c["qk_scale"])
    (qj, qt), (kj, kt), (vj, vt) = (_to(a, c["dtype"]) for a in (q, k, v))
    kw = c["kw"]
    got = ops.flash_attention(qt, kt, vt, **kw)
    assert got.shape == (b, h, sq, d) and got.dtype == qt.dtype
    want = _np(jops.flash_attention(qj, kj, vj, interpret=True, **kw))
    np.testing.assert_allclose(_np(got), want, atol=tol, rtol=tol)

    mask_kw = {x: kw[x] for x in ("causal", "window", "softcap", "scale")
               if x in kw}
    jr = _np(jref.attention_ref(*(jnp.asarray(a).astype(qj.dtype)
                                  for a in _expanded(q, k, v, h // kv)),
                                **mask_kw)).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(_np(got), jr, atol=tol, rtol=tol)
    tr = ref.attention_ref(*(torch.from_numpy(np.ascontiguousarray(a))
                             .to(qt.dtype)
                             for a in _expanded(q, k, v, h // kv)), **mask_kw)
    np.testing.assert_allclose(_np(tr).transpose(0, 2, 1, 3), jr, atol=tol,
                               rtol=tol)
    if name == "odd-37x101":
        # requested blocks 16 and 32 halve to 1 and 1 on 37 and 101
        assert _blocks(sq, sk, 16, 32, attention_tile(d, qt.dtype, sq)) \
            == (1, 1)
        blocked = flash_attention_plain(qt, kt, vt, block_q=16, block_k=32,
                                        **mask_kw)
        np.testing.assert_allclose(_np(blocked), want, atol=tol, rtol=tol)


def test_rows_that_see_no_key():
    """Causal with Sq > Sk: query rows 0..Sk-1 see no key. The kernel and
    its port give exactly 0 there; attention_ref (JAX and port) gives the
    mean of v. Rows that see a key agree everywhere."""
    b, h, kv, sq, sk, d = shape = (1, 2, 1, 64, 32, 16)
    q, k, v = _inputs(shape, 0.4)
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    got = _np(ops.flash_attention(qt, kt, vt, causal=True))
    jk = _np(jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=True,
                                  interpret=True))
    empty = slice(0, sq - sk)
    assert np.array_equal(got[:, :, empty], np.zeros_like(got[:, :, empty]))
    assert np.array_equal(jk[:, :, empty], np.zeros_like(jk[:, :, empty]))

    ex = _expanded(q, k, v, h // kv)
    jr = _np(jref.attention_ref(*map(jnp.asarray, ex), causal=True))
    tr = _np(ref.attention_ref(*(torch.from_numpy(np.ascontiguousarray(a))
                                 for a in ex), causal=True))
    mean_v = v.astype(np.float64).mean(axis=2)[:, :, None, :]  # (B,KV,1,D)
    for r in (jr, tr):
        rows = r.transpose(0, 2, 1, 3)[:, :, empty]
        np.testing.assert_allclose(rows, np.broadcast_to(mean_v, rows.shape),
                                   atol=1e-6, rtol=0)
    seen = slice(sq - sk, sq)
    np.testing.assert_allclose(got[:, :, seen], jk[:, :, seen], atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_allclose(tr.transpose(0, 2, 1, 3)[:, :, seen],
                               got[:, :, seen], atol=2e-5, rtol=2e-5)


def test_cpu_tensors_count_no_launch():
    before = dict(launch_counts())
    q, k, v = (torch.from_numpy(a) for a in _inputs((1, 2, 1, 8, 16, 8), 1))
    ops.flash_attention(q, k, v, window=4, softcap=5.0)
    after = launch_counts()
    assert "flash_attention" in after
    assert after == before


@pytest.mark.parametrize("what,shapes,dtypes,err", [
    ("mixed dtypes", ((1, 2, 4, 16), (1, 2, 4, 16)),
     (torch.float32, torch.bfloat16), TypeError),
    ("float16", ((1, 2, 4, 16), (1, 2, 4, 16)),
     (torch.float16, torch.float16), TypeError),
    ("H % KV != 0", ((1, 3, 4, 16), (1, 2, 4, 16)),
     (torch.float32, torch.float32), ValueError),
    ("D = 12", ((1, 2, 4, 12), (1, 1, 4, 12)),
     (torch.float32, torch.float32), ValueError),
    ("D = 264", ((1, 2, 4, 264), (1, 1, 4, 264)),
     (torch.float32, torch.float32), ValueError),
    ("3-D", ((2, 4, 16), (2, 4, 16)),
     (torch.float32, torch.float32), ValueError),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(what, shapes, dtypes,
                                                       err):
    q = torch.zeros(shapes[0], dtype=dtypes[0])
    k = torch.zeros(shapes[1], dtype=dtypes[1])
    with pytest.raises(err):
        ops.flash_attention(q, k, k)


def test_wrapper_rejects_a_device_that_is_neither_cpu_nor_cuda():
    q = torch.zeros((1, 2, 4, 16))
    meta = torch.empty((1, 2, 4, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        ops.flash_attention(q, meta, meta)


@pytest.mark.parametrize("dtype,d,sq,tile", [
    (torch.float32, 128, 100, (128, 64)), (torch.float32, 256, 1, (8, 32)),
    (torch.bfloat16, 256, 100, (64, 64)), (torch.bfloat16, 40, 8, (8, 64)),
])
def test_plain_default_block_is_the_kernel_tile(dtype, d, sq, tile):
    """Without block arguments the plain version sums in key blocks of the
    kernel's own tile; any other block changes only the order of summation."""
    assert attention_tile(d, dtype, sq) == tile
    q, k, v = (torch.from_numpy(a).to(dtype)
               for a in _inputs((1, 2, 1, sq, 128, d), 0.4))
    kw = dict(causal=True, window=100, softcap=20.0)
    got = flash_attention_plain(q, k, v, **kw)
    assert torch.equal(got, flash_attention_plain(q, k, v, block_k=tile[1],
                                                  **kw))
    other = flash_attention_plain(q, k, v, block_k=16, **kw)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    np.testing.assert_allclose(_np(got), _np(other), atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# the decode route's split over keys (csrc/flash_decode.cu), in PyTorch
# ---------------------------------------------------------------------------
DECODE_CASES = {
    # name: (b, h, kv, sq, sk, d), dtype, mask kwargs, split (None: the
    # kernel's own; else (kbeg, chunk) over all keys)
    "gqa1": ((2, 4, 4, 1, 512, 32), "float32", dict(causal=True), (0, 64)),
    "gqa4-softcap": ((2, 4, 1, 4, 512, 32), "float32",
                     dict(causal=True, softcap=15.0), (0, 128)),
    # window 100 at the last of 2 rows: chunks 0-13 of 64 keys see nothing
    "window-empty-chunks": ((1, 4, 2, 2, 1024, 16), "float32",
                            dict(causal=True, window=100), (0, 64)),
    "kernel-split": ((2, 4, 2, 1, 700, 16), "float32",
                     dict(causal=True, window=300), None),
    "bf16-gqa4": ((1, 8, 2, 2, 384, 32), "bfloat16", dict(causal=True),
                  (0, 64)),
}


def _split(shape, kw, split):
    from repro_torch.kernels.flash_attention import decode_split
    b, h, kv, sq, sk, _ = shape
    rt = decode_split(b, kv, h // kv, sq, sk, kw.get("window"))[0]
    kbeg, chunk = split
    return rt, kbeg, chunk, -(-(sk - kbeg) // chunk)


@pytest.mark.parametrize("name", list(DECODE_CASES))
def test_decode_split_matches_jax(name):
    """Partials per key chunk, then the combine, equal the JAX kernel's
    attention; a chunk that sees no key adds exactly 0."""
    from repro_torch.kernels.flash_attention import (decode_partials_plain,
                                                     flash_decode_plain)
    shape, dtype, kw, split = DECODE_CASES[name]
    tol = DTYPES[dtype][2]
    q, k, v = _inputs(shape, 0.4, seed=3)
    (qj, qt), (kj, kt), (vj, vt) = (_to(a, dtype) for a in (q, k, v))
    sp = None if split is None else _split(shape, kw, split)
    got = flash_decode_plain(qt, kt, vt, split=sp, **kw)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    want = _np(jops.flash_attention(qj, kj, vj, interpret=True, **kw))
    np.testing.assert_allclose(_np(got), want, atol=tol, rtol=tol)
    if name == "window-empty-chunks":
        m, l_, acc = decode_partials_plain(qt, kt, vt, sp, **kw)
        assert sp[3] == 16
        assert bool((m[..., :14] == -2e38).all())
        assert not l_[..., :14].any() and not acc[..., :14, :].any()


def test_decode_split_rows_that_see_no_key():
    """Causal with Sq > Sk at the decode shape: rows 0..3 see no key, so all
    their chunks hold m = -2e38, l = 0, acc = 0 and the combine gives
    exactly 0, as the JAX kernel does."""
    from repro_torch.kernels.flash_attention import (decode_split,
                                                     flash_decode_plain)
    b, h, kv, sq, sk, d = shape = (1, 4, 2, 8, 4, 16)
    q, k, v = _inputs(shape, 0.4)
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    got = _np(flash_decode_plain(qt, kt, vt, causal=True))
    assert decode_split(b, kv, h // kv, sq, sk, None)[0] == 8
    jk = _np(jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=True,
                                  interpret=True))
    assert np.array_equal(got[:, :, :4], np.zeros_like(got[:, :, :4]))
    assert np.array_equal(jk[:, :, :4], np.zeros_like(jk[:, :, :4]))
    np.testing.assert_allclose(got, jk, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("b,kv,g,sq,sk,window,want", [
    # the phase-5 decode shapes of chip_smoke.py: ~8 blocks per H100 SM
    (8, 16, 2, 1, 32768, None, (2, 0, 3648, 9)),
    (8, 8, 2, 1, 32768, None, (2, 0, 1984, 17)),
    (8, 16, 2, 1, 4096, 4096, (2, 0, 512, 8)),
    (2, 4, 1, 1, 256, None, (1, 0, 256, 1)),
    # 4 rows against a window: only keys [4093, 8192) are read
    (8, 16, 2, 4, 8192, 4096, (8, 4093, 512, 9)),
])
def test_decode_split_rule(b, kv, g, sq, sk, window, want):
    from repro_torch.kernels.flash_attention import decode_split
    got = decode_split(b, kv, g, sq, sk, window)
    assert got == want
    rt, kbeg, chunk, chunks = got
    assert chunk % 64 == 0 and kbeg + chunks * chunk >= sk
    assert kbeg + (chunks - 1) * chunk < sk


@pytest.mark.parametrize("dtype,sq,route", [
    (torch.float32, 1, "decode"), (torch.bfloat16, 8, "decode"),
    (torch.bfloat16, 9, "mma"), (torch.bfloat16, 8192, "mma"),
    (torch.float32, 9, "tf32x3"), (torch.float32, 8192, "tf32x3"),
])
def test_attention_route(dtype, sq, route):
    from repro_torch.kernels.flash_attention import attention_route
    assert attention_route(dtype, sq) == route


# ---------------------------------------------------------------------------
# the bf16 prefill route's numerics (csrc/flash_attention_mma.cu), emulated
# ---------------------------------------------------------------------------
def _cut_to_bf16(x):
    """x with the low 16 bits of each f32 cleared: a bf16 value, cut toward
    zero."""
    return (x.view(torch.int32) & -65536).view(torch.float32)


def _emulated_mma(q, k, v, scale, split_p, bk=32):
    """Causal attention as the tensor-core kernel computes it: bf16 q . k
    summed in f32, scaled after the product; online softmax over bk-key
    tiles in f32; P into P V as bf16, either split in two (``split_p``
    "cut": hi = p cut to bf16 and lo = p - hi cut the same way, as the
    kernel does, or "nearest": both rounded to nearest; two products into
    one f32 sum) or, for ``None``, rounded once to bf16; the row sum l of
    the same bf16 terms (the kernel takes it as P times a column of ones);
    the output rounded to bf16. hi + lo is exact in f32, so summing it
    before the product stands for the kernel's two products."""
    qf, kf, vf = (t.to(torch.float32) for t in (q, k, v))
    sq, sk = q.shape[-2], k.shape[-2]
    qpos = torch.arange(sq).view(sq, 1) + (sk - sq)
    m = torch.full(q.shape[:-1] + (1,), -2e38)
    l_ = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    for j in range(0, sk, bk):
        s = (qf @ kf[..., j:j + bk, :].transpose(-1, -2)) * scale
        mask = torch.arange(j, min(j + bk, sk)).view(1, -1) <= qpos
        s = torch.where(mask, s, -2e38)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.where(mask, torch.exp(s - m_new), 0.0)
        corr = torch.exp(m - m_new)
        vb = vf[..., j:j + bk, :]
        if split_p == "cut":
            hi = _cut_to_bf16(p)
            lo = _cut_to_bf16(p - hi)
        else:
            hi = p.to(torch.bfloat16).to(torch.float32)
            lo = (p - hi).to(torch.bfloat16).to(torch.float32)
        pb = hi if split_p is None else hi + lo
        l_ = l_ * corr + pb.sum(dim=-1, keepdim=True)
        acc = acc * corr + pb @ vb
        m = m_new
    return (acc / torch.clamp(l_, min=1e-30)).to(torch.bfloat16)


def test_prefill_p_split_meets_the_bf16_limit():
    """chip_smoke.py's bf16 limit, element by element against float64: the
    plain version's error there + 2^-7 |plain| + 2^-7 * 1e-2 of the row's
    largest |float64| value. P split as bf16 hi + lo meets it at Sk 1024,
    D 64, causal, whether hi and lo are cut to bf16 (as in the kernel) or
    rounded to nearest; P rounded once to bf16 does not."""
    b, h, s, d = 1, 2, 1024, 64
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _inputs((b, h, h, s, s, d), 0.4, seed=5))
    scale = d ** -0.5
    qd, kd, vd = (t.to(torch.float64) for t in (q, k, v))
    sc = (qd * scale) @ kd.transpose(-1, -2)
    causal = torch.ones(s, s, dtype=torch.bool).tril()
    w = torch.softmax(sc.masked_fill(~causal, float("-inf")), dim=-1)
    r64 = w @ vd
    plain = flash_attention_plain(q, k, v, causal=True).to(torch.float64)
    ep = (plain - r64).abs()
    limit = (ep + 2.0 ** -7 * plain.abs()
             + 2.0 ** -7 * 1e-2 * r64.abs().amax(dim=-1, keepdim=True))
    over = {}
    for split_p in ("cut", "nearest", None):
        got = _emulated_mma(q, k, v, scale, split_p).to(torch.float64)
        over[split_p] = int(((got - r64).abs() > limit).sum())
    assert over["cut"] == 0 and over["nearest"] == 0
    assert over[None] > 0


# ---------------------------------------------------------------------------
# the f32 prefill route's numerics (csrc/flash_attention.cu, 3xTF32), emulated
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["random", "tiny", "huge"])
def test_tf32_split_plain(kind):
    """hi and lo are TF32 values (low 13 bits zero), hi is x rounded to
    nearest TF32 (within half its ulp, 2^-11 |x|), and hi + lo stands for
    x within 2^-22 |x|."""
    rng = np.random.default_rng(11)
    if kind == "random":
        x = rng.standard_normal(100_000).astype(np.float32)
    else:   # tiny: lo stays a normal f32 down to |x| ~ 2^-115
        lo, hi = (-34, -30) if kind == "tiny" else (30, 37)
        x = (rng.choice([-1.0, 1.0], 100_000)
             * 10.0 ** rng.uniform(lo, hi, 100_000)).astype(np.float32)
    xt = torch.from_numpy(x)
    hi, lo = tf32_split_plain(xt)
    for t in (hi, lo):
        assert not bool((t.view(torch.int32) & 0x1FFF).any())
    x64 = xt.double()
    assert bool(((x64 - hi.double()).abs() <= 2.0 ** -11 * x64.abs()).all())
    rest = (x64 - hi.double() - lo.double()).abs()
    assert bool((rest <= 2.0 ** -22 * x64.abs()).all())


def test_tf32_split_rounds_ties_away_from_zero():
    """cvt.rna: a value halfway between two TF32 values goes to the one of
    larger magnitude."""
    x = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 2.0 ** -12],
                     dtype=torch.float32)
    hi, lo = tf32_split_plain(x)
    assert hi.tolist() == [1 + 2.0 ** -10, -(1 + 2.0 ** -10), 1.0]
    assert lo.tolist() == [-(2.0 ** -11), 2.0 ** -11, 2.0 ** -12]


def _products(a, b, terms):
    """a @ b as the kernel's tensor cores take it: both split in TF32 hi +
    lo, lo.hi + hi.lo + hi.hi (or hi.hi alone for one term), each product
    of TF32 values exact in f32 and summed in f32."""
    ah, al = tf32_split_plain(a)
    bh, bl = tf32_split_plain(b)
    if terms == 1:
        return ah @ bh
    return (al @ bh + ah @ bl) + ah @ bh


def _emulated_tf32(q, k, v, scale, softcap, terms, bk):
    """Causal attention (bottom-right aligned, GQA) as the f32 prefill
    kernel computes it: q scaled and rounded in f32, the score and P V each
    from ``_products``, the online softmax over ``bk``-key tiles in f32."""
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    qs = (q * scale).reshape(b, kv, h // kv, sq, d)
    qpos = torch.arange(sq).view(sq, 1) + (sk - sq)
    m = torch.full(qs.shape[:-1] + (1,), -2e38)
    l_ = torch.zeros_like(m)
    acc = torch.zeros_like(qs)
    for j in range(0, sk, bk):
        kb = k[:, :, j:j + bk].unsqueeze(2)
        vb = v[:, :, j:j + bk].unsqueeze(2)
        s = _products(qs, kb.transpose(-1, -2), terms)
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        mask = torch.arange(j, min(j + bk, sk)).view(1, -1) <= qpos
        s = torch.where(mask, s, -2e38)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.where(mask, torch.exp(s - m_new), 0.0)
        corr = torch.exp(torch.clamp(m - m_new, max=0.0))
        l_ = l_ * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + _products(p, vb, terms)
        m = m_new
    return (acc / torch.clamp(l_, min=1e-30)).reshape(b, h, sq, d)


@pytest.mark.parametrize("h,kv,sq,sk,d,softcap", [
    (2, 1, 128, 128, 32, None), (2, 1, 128, 128, 32, 15.0),
    (4, 2, 512, 1024, 128, 50.0), (1, 1, 256, 2048, 256, None)])
def test_prefill_3xtf32_meets_the_f32_limit(h, kv, sq, sk, d, softcap):
    """chip_smoke.py's f32 limit against float64 (2x the plain version's
    largest error + 1e-6): three TF32 terms a product meet it, one term
    (q, k, p and v each rounded to TF32) does not."""
    q, k, v = (torch.from_numpy(a)
               for a in _inputs((1, h, kv, sq, sk, d), 0.4, seed=7))
    scale = d ** -0.5
    qd = (q.double() * scale).reshape(1, kv, h // kv, sq, d)
    sc = qd @ k.double().unsqueeze(2).transpose(-1, -2)
    if softcap is not None:
        sc = softcap * torch.tanh(sc / softcap)
    qpos = torch.arange(sq).view(sq, 1) + (sk - sq)
    sc = sc.masked_fill(torch.arange(sk).view(1, sk) > qpos, float("-inf"))
    r64 = (torch.softmax(sc, dim=-1) @ v.double().unsqueeze(2)).reshape(
        1, h, sq, d)
    plain = flash_attention_plain(q, k, v, causal=True, softcap=softcap)
    limit = 2 * float((plain.double() - r64).abs().max()) + 1e-6
    bk = attention_tf32_plan(d)[2]
    err = {t: float((_emulated_tf32(q, k, v, scale, softcap, t, bk).double()
                     - r64).abs().max()) for t in (3, 1)}
    assert err[3] <= limit
    assert err[1] > limit


@pytest.mark.parametrize("d", range(8, 257, 8))
def test_attention_tf32_plan(d):
    """The f32 prefill kernel's tile at every head_dim it takes: within
    the H100's shared memory a block, whole 16-row MMA tiles a warp, a key
    tile of whole 8-key MMA steps, and the bytes its staging takes (Q, as
    TF32 hi and lo up to head-dim class 64, and the K + V ring, rows padded
    to the class + 4 floats)."""
    warps, rows, bk, stages, smem = attention_tf32_plan(d)
    assert smem <= SMEM_LIMIT
    assert bk % 8 == 0 and rows % 16 == 0 and stages >= 2
    assert 1 <= warps <= 32
    dp = tf32_head_class(d)
    assert d <= dp < 2 * d or dp == 16
    q_tiles = 2 if dp <= 64 else 1
    assert smem == (q_tiles * warps * rows + 2 * stages * bk) * (dp + 4) * 4
    # the plain version's default block is the kernel's tile
    assert attention_tile(d, torch.float32, 9) == (warps * rows, bk)
