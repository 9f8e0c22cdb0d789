"""The tile plans of the port's f32 GEMM and depthwise kernels, on the CPU.

``kernels/gemm.py::gemm_float_plan`` and ``kernels/depthwise.py::
depthwise_plan`` give ``csrc/gemm_f32.cu`` and ``csrc/depthwise.cu`` their
tiles; the kernels run only on the card, so these tests hold the plans'
arithmetic here: the K splits cover K once and in order, the split-K order
of summation stays inside phase 4's GEMM limit (2x the plain version's error
against float64, plus 1e-6 K), every depthwise output is stored by one
thread and reads all its taps from its tile's halo, and the halo fits the
kernel's shared memory. Shapes are the port's MobileNet-1.0 and ResNet-18
layer tables at batch 8. The split-K decomposition is also held to the JAX
package's ``gemm`` (Pallas, interpret mode) at tests/test_kernels.py's
epilogue tolerance, 1e-4.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import depthwise as dwk
from repro_torch.kernels import gemm as gk
from repro_torch.vta.workloads import mobilenet_graph, resnet_graph

BATCH = 8


def _layers():
    return {ly.wl.name: ly for ly in (mobilenet_graph(BATCH).layers()
                                      + resnet_graph(18, BATCH).layers())}


def _gemm_shape(name):
    """(M, N, K) of a pointwise conv or fc layer at batch 8."""
    wl = _layers()[name].wl
    return BATCH * wl.h * wl.w, wl.fo, wl.fi


# ---------------------------------------------------------------------------
# gemm_float_plan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("k", [1, 16, 63, 64, 65, 128, 257, 512, 1000, 1020,
                               1024, 4096])
def test_splits_cover_k_once_in_order(k):
    for splits in range(1, gk.MAX_SPLITS + 1):
        bounds = gk.gemm_float_splits(k, splits)
        assert len(bounds) == splits
        assert bounds[0][0] == 0 and bounds[-1][1] == k
        for (a0, a1), (b0, _) in zip(bounds, bounds[1:]):
            assert a1 == b0
        assert all(a <= b for a, b in bounds)
        # every split but the last starts and ends on a 16-deep K tile
        assert all(a % gk.SPLIT_UNIT == 0 for a, _ in bounds)


@pytest.mark.parametrize("mnk", [
    (100352, 64, 32), (25088, 128, 64), (1568, 512, 512), (392, 1024, 1024),
    (8, 1008, 1024), (8, 1008, 512), (392, 1008, 1020), (1001, 999, 257),
    (3, 1001, 1024), (5, 7, 0), (300, 300, 64), (64, 64, 65), (1, 1, 128)])
def test_gemm_float_plan_rules(mnk):
    m, n, k = mnk
    bm, bn, splits = gk.gemm_float_plan(m, n, k)
    assert (bm, bn) == (gk.THIN_TILE if m <= 16 else gk.TILE)
    assert 1 <= splits <= gk.MAX_SPLITS
    if k <= 64:
        assert splits == 1
    bounds = gk.gemm_float_splits(k, splits)
    if splits > 1:
        assert min(b - a for a, b in bounds) >= gk.MIN_SPLIT


@pytest.mark.parametrize("layer", ["mbn.fc", "resnet18.fc", "mbn.pw6",
                                   "mbn.pw12"])
def test_gemm_float_plan_fills_the_card(layer):
    """The grid of the fc layers (M = 8) and of the mid-sized pointwise
    convs reaches one block for each of the H100's 132 SMs."""
    m, n, k = _gemm_shape(layer)
    bm, bn, splits = gk.gemm_float_plan(m, n, k)
    assert -(-m // bm) * -(-n // bn) * splits >= gk.SMS


def _err64(out, x, w, bias, act, clip):
    r = x.double() @ w.double()
    if bias is not None:
        r = r + bias.double()
    if act == "relu":
        r = torch.relu(r)
    if clip is not None:
        r = torch.clamp(r, -clip, clip)
    return float((out.double() - r).abs().max())


def _epilogue(out, bias, act, clip):
    if bias is not None:
        out = out + bias
    if act == "relu":
        out = torch.relu(out)
    elif act == "gelu":
        out = torch.nn.functional.gelu(out, approximate="tanh")
    if clip is not None:
        out = torch.clamp(out, -clip, clip)
    return out


def _split_emulation(x, w, bias, act, clip, splits, *, per_split=False):
    """csrc/gemm_f32.cu's order in f32: one partial sum per split, summed
    in split order, then bias, activation and clip once (``per_split``:
    the wrong order, bias and epilogue applied to each split)."""
    parts = [x[:, a:b] @ w[a:b] for a, b in gk.gemm_float_splits(
        x.shape[1], splits)]
    if per_split:
        parts = [_epilogue(p, bias, act, clip) for p in parts]
        bias = act = clip = None
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return _epilogue(out, bias, act, clip)


@pytest.mark.parametrize("layer,act,clip,bias", [
    ("mbn.fc", None, None, True), ("mbn.pw12", "relu", 6.0, False),
    ("resnet18.fc", None, None, True)])
def test_split_k_order_within_the_gemm_limit(layer, act, clip, bias):
    m, n, k = _gemm_shape(layer)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((m, k), dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal((k, n), dtype=np.float32)
                         * np.float32(3 / k ** 0.5))
    b = torch.from_numpy(rng.standard_normal(n, dtype=np.float32)) \
        if bias else None
    limit = 2 * _err64(gk.gemm_plain(x, w, b, act=act, clip=clip), x, w, b,
                       act, clip) + 1e-6 * k
    plan = gk.gemm_float_plan(m, n, k)
    assert plan[2] > 1
    for splits in sorted({plan[2], gk._max_splits(k)}):
        got = _split_emulation(x, w, b, act, clip, splits)
        assert _err64(got, x, w, b, act, clip) <= limit
    # an epilogue per split (and the bias added once per split) fails it
    bad = _split_emulation(x, w, b, act, clip, plan[2], per_split=True)
    assert _err64(bad, x, w, b, act, clip) > limit


@pytest.mark.parametrize("act,clip", [(None, None), ("relu", 6.0),
                                      ("gelu", 4.0)])
def test_split_k_plain_matches_jax(act, clip):
    """The split-K decomposition at the mbn.fc shape against the JAX
    package's gemm, at tests/test_kernels.py's epilogue tolerance; the
    reduce kernel's wrapper (its plain version on the CPU) takes the same
    steps on the same partial sums."""
    m, n, k = 8, 1000, 1024
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((m, k)) * 0.5).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.5 / 16).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    splits = gk.gemm_float_plan(m, n, k)[2]
    assert splits > 1
    xt, wt, bt = (torch.from_numpy(a) for a in (x, w, b))
    got = _split_emulation(xt, wt, bt, act, clip, splits)
    parts = torch.stack([xt[:, a0:a1] @ wt[a0:a1]
                         for a0, a1 in gk.gemm_float_splits(k, splits)])
    assert torch.equal(gk.gemm_float_reduce(parts, bt, act, clip,
                                            torch.float32), got)
    want = jops.gemm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), act=act,
                     clip=clip)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


# ---------------------------------------------------------------------------
# depthwise_plan
# ---------------------------------------------------------------------------
def _dw_cases():
    out = []
    for ly in mobilenet_graph(BATCH).layers():
        if ly.kind == "depthwise":
            wl = ly.wl
            for dt in (torch.float32, torch.bfloat16):
                out.append((wl.name, wl.h, wl.w, wl.fi, wl.kh, wl.kw, wl.sh,
                            wl.ph, dt))
    for dt in (torch.float32, torch.bfloat16):      # ragged: C % 8 != 0
        out.append(("ragged", 15, 15, 36, 5, 5, 2, 2, dt))
    return out


DW_CASES = _dw_cases()


def test_dw_cases_are_the_mobilenet_layers():
    assert len(DW_CASES) == 2 * 13 + 2


def _threads(plan, oh, ow, c):
    """Every (block, thread, run position, lane) of csrc/depthwise.cu under
    ``plan``, as broadcast index arrays: the output row, column and channel
    each one computes, whether its thread runs past the early return, and
    its halo row and column of the tap (0, 0)."""
    th, tw, cb, vec = plan
    g_n, runs = cb // vec, tw // dwk.RUN
    tr, tc, ch, g, pos, r, v = np.ix_(
        np.arange(-(-oh // th)), np.arange(-(-ow // tw)),
        np.arange(-(-c // cb)), np.arange(g_n), np.arange(th * runs),
        np.arange(dwk.RUN), np.arange(vec))
    py, px = pos // runs, pos % runs
    oy, ox0 = tr * th + py, tc * tw + px * dwk.RUN
    cn = np.minimum(cb, c - ch * cb)
    live = (oy < oh) & (ox0 < ow) & (g * vec < cn)
    return (oy, ox0 + r, ch * cb + g * vec + v, live, ox0 + r < ow,
            (py, px * dwk.RUN + r))


@pytest.mark.parametrize("case", DW_CASES,
                         ids=[f"{c[0]}-{str(c[-1])[6:]}" for c in DW_CASES])
def test_depthwise_plan(case):
    name, h, w, c, kh, kw, s, pad, dtype = case
    th, tw, cb, vec = plan = dwk.depthwise_plan(h, w, c, kh, kw, s, pad,
                                                dtype)
    oh = (h + 2 * pad - kh) // s + 1
    ow = (w + 2 * pad - kw) // s + 1
    esize = 2 if dtype == torch.bfloat16 else 4
    # vec: 16 bytes of channels where C allows it, else the scalar path
    assert vec == (16 // esize if c % (16 // esize) == 0 else 1)
    assert cb == c if c < 32 else cb in (32, 64, 128)
    assert tw % dwk.RUN == 0 and th >= 1
    assert cb // vec * th * (tw // dwk.RUN) <= dwk.MAX_THREADS
    assert dwk.plan_smem(th, tw, cb, kh, kw, s, esize) <= dwk.SMEM_BUDGET
    oy, ox, ch, live, in_row, (hy0, hx0) = _threads(plan, oh, ow, c)
    shape = np.broadcast_shapes(oy.shape, ox.shape, ch.shape, live.shape,
                                in_row.shape)
    oy, ox, ch = (np.broadcast_to(a, shape) for a in (oy, ox, ch))
    stored = np.broadcast_to(live & in_row, shape)
    # every output is stored once, by one lane of one thread
    counts = np.zeros((oh, ow, c), np.int64)
    np.add.at(counts, (oy[stored], ox[stored], ch[stored]), 1)
    assert counts.min() == 1 and counts.max() == 1
    # every tap of every live lane lies in its tile's halo and is the
    # input pixel the plain version reads there
    hh, hw = dwk.halo_hw(th, tw, kh, kw, s)
    run = np.broadcast_to(live, shape)
    hy0 = np.broadcast_to(hy0 * s, shape)[run]
    hx0 = np.broadcast_to(hx0 * s, shape)[run]
    assert hy0.min() >= 0 and hy0.max() + kh - 1 < hh
    assert hx0.min() >= 0 and hx0.max() + kw - 1 < hw
    tile_y0 = (oy[run] // th) * th * s - pad
    tile_x0 = (ox[run] // tw) * tw * s - pad
    assert np.array_equal(tile_y0 + hy0, oy[run] * s - pad)
    assert np.array_equal(tile_x0 + hx0, ox[run] * s - pad)
    # the halo copy: thread position p takes pixels p, p + NP, ..., once each
    n_pos = th * (tw // dwk.RUN)
    pixels = np.concatenate([np.arange(p, hh * hw, n_pos)
                             for p in range(n_pos)])
    assert np.array_equal(np.sort(pixels), np.arange(hh * hw))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ragged_depthwise_matches_jax(dtype):
    """The ragged plan case (C = 36, 15x15, 5x5, stride 2, pad 2) through
    the port and the JAX kernel, at test_kernels.py's tolerance (bf16: the
    inputs are bf16 and both accumulate in f32)."""
    from repro_torch.kernels import ops
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 15, 15, 36)).astype(np.float32)
    w = rng.standard_normal((5, 5, 36)).astype(np.float32)
    jd, td = ((jnp.float32, torch.float32) if dtype == "float32"
              else (jnp.bfloat16, torch.bfloat16))
    got = ops.depthwise_conv(torch.from_numpy(x).to(td),
                             torch.from_numpy(w).to(td), stride=2, pad=2)
    want = jops.depthwise_conv(jnp.asarray(x).astype(jd),
                               jnp.asarray(w).astype(jd), stride=2, pad=2)
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


# ---------------------------------------------------------------------------
# alu_plan: the ALU kernel's scalar head, 16-byte vectors and scalar tail
# ---------------------------------------------------------------------------
ALU_NS = sorted(set(range(1, 257)) | set(range(257, 10 ** 6, 9973))
                | {1001, 100003, 401408, 10 ** 6 - 1, 10 ** 6})


@pytest.mark.parametrize("itemsize,misalign", [(4, m) for m in range(0, 16, 4)]
                         + [(2, m) for m in range(0, 16, 2)])
def test_alu_plan_covers_every_element_once(itemsize, misalign):
    """head + vectors * vec + tail = n; the vectors start on a 16-byte
    boundary, head and tail are fewer than a vector, and the grid is at
    most one wave of resident blocks yet covers the vectors in one step
    where it can."""
    from repro_torch.kernels import alu
    for n in ALU_NS:
        head, vec, unroll, blocks, tail = alu.alu_plan(n, itemsize, misalign)
        assert vec * itemsize == 16 and unroll == alu.UNROLL
        body = n - head - tail
        assert body >= 0 and body % vec == 0
        assert 0 <= head < vec and 0 <= tail < vec
        if body:
            assert (misalign + head * itemsize) % 16 == 0
        assert 1 <= blocks <= alu.WAVE
        assert blocks * alu.THREADS * unroll >= body // vec or \
            blocks == alu.WAVE


def test_alu_plan_rejects_a_misalignment_inside_an_element():
    from repro_torch.kernels import alu
    with pytest.raises(ValueError):
        alu.alu_plan(10, 4, 2)


@pytest.mark.parametrize("misalign", [0, 4, 8, 12])
def test_alu_output_takes_the_input_misalignment(misalign):
    """The wrapper's output (and a y it must copy) lie as far past a
    16-byte boundary as x, so one plan fits all three."""
    from repro_torch.kernels import alu
    base = torch.zeros(64)
    x = base[(misalign - base.data_ptr()) % 16 // 4:][:40]
    assert x.data_ptr() % 16 == misalign
    out = alu._empty_at(x, misalign)
    assert out.shape == x.shape and out.data_ptr() % 16 == misalign


# ---------------------------------------------------------------------------
# the build: the plans' tables reach the kernels' templates as macros
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["alu", "flash_attention", "gemm_f32"])
def test_kernel_macros_are_the_wrapper_tables(name):
    """nvcc gets ``kernels/<name>.py::nvcc_defines()`` for a source in
    ``_build.DEFINES`` and ``NVCC_FLAGS`` alone for any other; the macros
    spell the wrapper's own table (no commas, at which nvcc splits a
    macro), and the source has none of its own."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import alu
    from repro_torch.kernels import flash_attention as fa
    flags = _build.nvcc_flags(name)
    assert flags[:len(_build.NVCC_FLAGS)] == _build.NVCC_FLAGS
    macros = flags[len(_build.NVCC_FLAGS):]
    assert not any("," in m for m in macros)
    source = (_build.CSRC / f"{name}.cu").read_text()
    if name == "alu":
        assert macros == (f"-DALU_THREADS={alu.THREADS}",
                          f"-DALU_UNROLL={alu.UNROLL}")
        assert "#error" in source and "THREADS = 256" not in source
    elif name == "flash_attention":
        values = dict(m[2:].split("=") for m in macros)
        assert values.pop("TF32_STAGES") == str(fa.TF32_STAGES)
        assert len(values) == 5 * len(fa.TF32_TILES)
        for dp, (warps, rows, bk, q_tiles) in fa.TF32_TILES.items():
            tile = [int(values[f"TF32_{k}_{dp}"])
                    for k in ("WARPS", "ROWS", "BK", "QTILES", "SMEM")]
            assert tile[:4] == [warps, rows, bk, q_tiles]
            assert fa.attention_tf32_plan(dp) == (warps, rows, bk,
                                                  fa.TF32_STAGES, tile[4])
        assert "struct Tile<16>" not in source and "#error" in source
    else:
        assert macros == ()


def test_build_target_follows_the_table(monkeypatch):
    """A changed table is a changed library: the build's file name hashes
    the macros with the source, so a library built for another tile is
    never loaded."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    src = _build.CSRC / "flash_attention.cu"
    before = _build._target(src)
    monkeypatch.setitem(fa.TF32_TILES, 256, (8, 16, 8, 1))
    assert _build._target(src) != before
