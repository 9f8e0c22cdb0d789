"""The tile plans of the port's f32 GEMM, depthwise, ALU and pooling kernels,
on the CPU.

``kernels/gemm.py::gemm_float_plan``, ``kernels/depthwise.py::
depthwise_plan``, ``kernels/alu.py::alu_plan`` and ``kernels/pool2d.py::
pool_plan`` give ``csrc/gemm_f32.cu``, ``csrc/depthwise.cu``, ``csrc/alu.cu``
and ``csrc/pool2d.cu`` their tiles; the kernels run only on the card, so
these tests hold the plans' arithmetic here: the K splits cover K once and
in order, the split-K order of summation stays inside phase 4's GEMM limit
(2x the plain version's error against float64, plus 1e-6 K), every
depthwise and pooling output is stored by one thread and reads all its taps
from its tile's halo, the halo fits the kernel's shared memory, and a
pooling run tiled by its plan equals the plain version by bits. Shapes are
the port's MobileNet-1.0 and ResNet-18
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
from repro_torch.kernels import pool2d as pk
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
@pytest.mark.parametrize("name", ["alu", "flash_attention", "gemm_f32",
                                  "pool2d"])
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
    elif name == "pool2d":
        values = dict(m[2:].split("=") for m in macros)
        assert values.pop("POOL_THREADS") == str(pk.THREADS)
        assert len(values) == 6 * len(pk.POOL_TILES)
        for kind, (k, st, th, tw) in pk.POOL_TILES.items():
            tile = [int(values[f"POOL_{kind.upper()}_{key}"])
                    for key in ("K", "S", "TH", "TW", "GMAX", "SMEM")]
            g = pk.kind_groups(kind)
            assert tile == [k, st, th, tw, g,
                            pk.plan_smem(th, tw, k, st, g, 16)]
            assert tile[5] <= pk.SMEM_BUDGET and tw * g <= pk.THREADS
        assert "#error" in source and "THREADS = 256" not in source
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


# ---------------------------------------------------------------------------
# pool_plan: the pooling kernel's tile, halo and grid
# ---------------------------------------------------------------------------
def _pool_cases():
    """(name, batch, h, w, c, k, stride, pad, itemsize, misalignment): the
    phase-4 pools at batch 8 in both dtypes, then the edge shapes."""
    out = []
    for ly in _layers().values():
        if ly.kind in ("maxpool", "avgpool"):
            wl = ly.wl
            for size in (4, 2):
                out.append((wl.name, BATCH, wl.h, wl.w, wl.fi, wl.kh, wl.sh,
                            wl.ph, size, 0))
    for size in (4, 2):
        out += [("C36", 2, 15, 15, 36, 3, 2, 1, size, 0),
                ("C3", 2, 15, 15, 3, 3, 2, 1, size, 0),
                ("k3s2p1", 2, 15, 15, 32, 3, 2, 1, size, 0),
                ("k2s2p0", 2, 15, 15, 32, 2, 2, 0, size, 0),
                ("k3s1p1", 2, 15, 15, 32, 3, 1, 1, size, 0),
                ("pad-only", 2, 15, 15, 32, 2, 2, 2, size, 0),
                ("off", 2, 15, 15, 32, 3, 2, 1, size, 4 if size == 4 else 6),
                ("any 5x5", 3, 15, 15, 16, 5, 1, 2, size, 0),
                ("gap b1", 1, 7, 7, 512, 7, 7, 0, size, 0),
                ("gap 14x14 k14", 2, 14, 14, 64, 14, 1, 0, size, 0),
                ("window 70", 1, 70, 70, 8, 70, 1, 0, size, 0)]
    return out


POOL_CASES = _pool_cases()
GLOBAL_POOLS = [c for c in POOL_CASES if c[0].endswith(".gap")]


def _pool_out_hw(h, w, k, s, pad):
    return (h + 2 * pad - k) // s + 1, (w + 2 * pad - k) // s + 1


def _pool_plan(case):
    _, b, h, w, c, k, s, pad, size, mis = case
    return pk.pool_plan(b, h, w, c, k, s, pad, *_pool_out_hw(h, w, k, s, pad),
                        size, mis)


def test_pool_cases_hold_the_phase4_pools():
    names = {c[0] for c in POOL_CASES if c[1] == BATCH}
    assert names == {"resnet18.pool1", "resnet18.gap", "mbn.gap"}
    assert len(GLOBAL_POOLS) == 4


@pytest.mark.parametrize("case", POOL_CASES,
                         ids=[f"{c[0]}-{c[8]}B" for c in POOL_CASES])
def test_pool_plan(case):
    """Every output element is computed by one lane of one thread, from
    taps inside its tile's halo at the input pixel the plain version
    reads; the halo fits its budget; the vector path only where C and the
    alignment allow it; whole warps, within the block."""
    name, b, h, w, c, k, s, pad, size, mis = case
    plan = _pool_plan(case)
    oh, ow = _pool_out_hw(h, w, k, s, pad)
    kind = pk.KINDS[plan.kind]
    assert kind == pk.pool_kind(k, s, oh, ow)
    if kind != "any":
        kk, ks, th, tw = pk.POOL_TILES[kind]
        assert (plan.th, plan.tw, k) == (th, tw, kk)
        assert kind == "k7g" or s == ks
    vec = 16 // size
    assert plan.vec == (vec if c % vec == 0 and mis == 0 else 1)
    g = plan.groups
    assert g & (g - 1) == 0
    assert plan.threads % 32 == 0
    assert plan.tw * g <= plan.threads <= pk.THREADS
    gbytes = plan.vec * size
    assert plan.smem == pk.plan_smem(plan.th, plan.tw, k, s, g, gbytes)
    if kind != "any":
        assert plan.smem <= pk.plan_smem(plan.th, plan.tw, k, s,
                                         pk.kind_groups(kind), 16)
    if plan.smem > pk.SMEM_BUDGET:      # only a window one group overflows
        assert g == 1 and plan.th * plan.tw == 1
        assert plan.smem <= pk.MAX_SMEM
    cg = -(-c // plan.vec)
    assert (plan.tiles_h, plan.tiles_w, plan.chunks) == (
        -(-oh // plan.th), -(-ow // plan.tw), -(-cg // g))
    # one image's blocks, threads (a column group each, down the tile's
    # rows) and lanes, as csrc/pool2d.cu maps them
    tr, tc, ch, o, py, v = np.ix_(np.arange(plan.tiles_h),
                                  np.arange(plan.tiles_w),
                                  np.arange(plan.chunks),
                                  np.arange(plan.threads),
                                  np.arange(plan.th), np.arange(plan.vec))
    gi, px = o % g, o // g
    oy, ox = tr * plan.th + py, tc * plan.tw + px
    chan = (ch * g + gi) * plan.vec + v
    live = (o < plan.tw * g) & (oy < oh) & (ox < ow) & \
        ((ch * g + gi) * plan.vec < c)
    shape = np.broadcast_shapes(oy.shape, ox.shape, chan.shape, live.shape)
    oy, ox, chan, live = (np.broadcast_to(a, shape) for a in
                          (oy, ox, chan, live))
    assert (chan[live] < c).all()       # a live group lies inside C
    counts = np.zeros((oh, ow, c), np.int64)
    np.add.at(counts, (oy[live], ox[live], chan[live]), 1)
    assert counts.min() == 1 and counts.max() == 1
    # the taps (0, 0) and (k-1, k-1) of every live output in the halo, at
    # the pixel the plain version reads
    hh, hw = pk.halo_hw(plan.th, plan.tw, k, s)
    hy = np.broadcast_to(py * s, shape)[live]
    hx = np.broadcast_to(px * s, shape)[live]
    assert hy.min() >= 0 and hy.max() + k - 1 < hh
    assert hx.min() >= 0 and hx.max() + k - 1 < hw
    tile_y0 = np.broadcast_to(tr * plan.th * s - pad, shape)[live]
    tile_x0 = np.broadcast_to(tc * plan.tw * s - pad, shape)[live]
    assert np.array_equal(tile_y0 + hy, oy[live] * s - pad)
    assert np.array_equal(tile_x0 + hx, ox[live] * s - pad)


@pytest.mark.parametrize("case", GLOBAL_POOLS,
                         ids=[f"{c[0]}-{c[8]}B" for c in GLOBAL_POOLS])
def test_global_pool_plan_fills_the_card(case):
    """A global pool's grid gives every SM a block, where one tile per
    image and 256 channels would give 16 or 32 blocks."""
    plan = _pool_plan(case)
    assert pk.KINDS[plan.kind] == "k7g"
    blocks = case[1] * plan.tiles_h * plan.tiles_w * plan.chunks
    assert pk.WAVE <= blocks <= 4 * pk.WAVE


def _tiled_pool(x, k, s, pad, mode, plan):
    """The kernel's tile loop in PyTorch: for each tile and channel chunk,
    the halo filled with the mode's pad value outside the image (and past
    C), then the taps in order from the seed, cropped to the output."""
    b, h, w, c = x.shape
    oh, ow = _pool_out_hw(h, w, k, s, pad)
    fill = float("-inf") if mode == "max" else 0.0
    hh, hw = pk.halo_hw(plan.th, plan.tw, k, s)
    cb = plan.groups * plan.vec
    out = torch.full((b, oh, ow, c), float("nan"))
    xf = x.to(torch.float32)
    for tr in range(plan.tiles_h):
        for tc in range(plan.tiles_w):
            for ch in range(plan.chunks):
                y0, x0, c0 = (tr * plan.th * s - pad, tc * plan.tw * s - pad,
                              ch * cb)
                halo = torch.full((b, hh, hw, cb), fill)
                ys, xs = slice(max(y0, 0), min(y0 + hh, h)), \
                    slice(max(x0, 0), min(x0 + hw, w))
                src = xf[:, ys, xs, c0:c0 + cb]
                halo[:, ys.start - y0:ys.stop - y0,
                     xs.start - x0:xs.stop - x0, :src.shape[3]] = src
                acc = torch.full((b, plan.th, plan.tw, cb),
                                 float("-inf") if mode == "max" else -0.0)
                for dy in range(k):
                    for dx in range(k):
                        sub = halo[:, dy:dy + s * (plan.th - 1) + 1:s,
                                   dx:dx + s * (plan.tw - 1) + 1:s]
                        acc = pk.max_ordered(acc, sub) if mode == "max" \
                            else acc + sub
                if mode == "avg":
                    acc = acc * torch.tensor(pk.avg_scale(k))
                oy0, ox0 = tr * plan.th, tc * plan.tw
                tile = out[:, oy0:oy0 + plan.th, ox0:ox0 + plan.tw,
                           c0:c0 + cb]
                tile.copy_(acc[:, :tile.shape[1], :tile.shape[2],
                               :tile.shape[3]])
    return out.to(x.dtype)


TILED = [c for c in POOL_CASES if c[0] not in ("window 70",)]


@pytest.mark.parametrize("case", TILED, ids=[f"{c[0]}-{c[8]}B" for c in TILED])
def test_pool_run_tiled_by_its_plan_is_the_plain_version(case):
    """On signed zeros and normal values (max: and NaN), at batch 1 for the
    phase-4 shapes: bit for bit, NaN by position."""
    name, b, h, w, c, k, s, pad, size, mis = case
    rng = np.random.default_rng(c + k + s + pad)
    b = min(b, 2)
    a = rng.standard_normal((b, h, w, c)).astype(np.float32)
    u = rng.random(a.shape)
    a[u < 0.3] = -0.0
    a[(u >= 0.3) & (u < 0.4)] = 0.0
    dtype = torch.float32 if size == 4 else torch.bfloat16
    for mode in ("max", "avg"):
        if mode == "max":
            a[rng.random(a.shape) < 0.02] = np.nan
        x = torch.from_numpy(a).to(dtype)
        plan = pk.pool_plan(b, h, w, c, k, s, pad,
                            *_pool_out_hw(h, w, k, s, pad), size, mis)
        got = _tiled_pool(x, k, s, pad, mode, plan).to(torch.float32)
        want = pk.pool2d_plain(x, k=k, stride=s, pad=pad,
                               mode=mode).to(torch.float32)
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        keep = ~torch.isnan(want)
        assert torch.equal(got.view(torch.int32)[keep],
                           want.view(torch.int32)[keep])


def test_pool_plan_rejects_a_window_past_shared_memory():
    with pytest.raises(ValueError, match="shared memory"):
        pk.pool_plan(1, 130, 130, 4, 130, 1, 0, 1, 1, 4, 0)
