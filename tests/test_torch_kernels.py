"""Parity of the port's kernels (``repro_torch.kernels``) with the JAX
package's, on the CPU.

Tolerance: 0 everywhere — the results are integers and are compared bit for
bit. Each test makes its inputs with numpy from a seed and hands the same
arrays to the JAX function (its lax version and its Pallas kernel in
interpret mode, as the JAX package's own tests run them) and to the port's
plain version. On CPU tensors the kernels' wrappers take the plain versions
and count no launch.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.tps import ConvWorkload
from repro.kernels.alu_sweep import (eval_chain, eval_sweep, pallas_chain,
                                     pallas_sweep)
from repro.kernels.vta_gemm import _einsum_gemm, blocked_gemm
from repro.vta.fsim_jax import _gemm_product
from repro.vta.isa import DEFAULT_VTA, PIPELINED_VTA
from repro.vta.lowering import lower
from repro.vta.scheduler import schedule_depthwise
from repro_torch.core import tps as ttps
from repro_torch.kernels import launch_counts
from repro_torch.kernels.alu_sweep import (FILL_THREADS, SweepProgram,
                                           _affine_positions, alu_chain,
                                           alu_sweep, eval_chain_plain,
                                           eval_sweep_plain,
                                           last_writer_positions, max_split,
                                           sweep_plan)
from repro_torch.kernels.vta_gemm import gemm_acc_plain, gemm_plain, vta_gemm
from repro_torch.vta import isa as tisa
from repro_torch.vta import lowering as tlowering
from repro_torch.vta import scheduler as tsched
from repro_torch.vta.fsim_torch import _device_ops, _sweep_program

RNG = np.random.default_rng(29)


def _t(a):
    return torch.from_numpy(np.array(a))


def _ix(a):
    return torch.from_numpy(np.asarray(a, np.int64).copy())


# ---------------------------------------------------------------------------
# GEMM
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("m,k,n", [(24, 48, 16), (97, 130, 37), (1, 16, 1),
                                   (3, 5, 7), (49, 576, 16)])
def test_gemm_plain_matches_jax(m, k, n):
    """Odd and prime shapes: the plain GEMM equals the JAX einsum and the
    Pallas kernel (interpret) on int8 extremes."""
    x = RNG.integers(-128, 128, (m, k)).astype(np.int8)
    w = RNG.integers(-128, 128, (k, n)).astype(np.int8)
    xf, wf = jnp.asarray(x, jnp.float32), jnp.asarray(w, jnp.float32)
    ref = np.asarray(_einsum_gemm(xf, wf))
    np.testing.assert_array_equal(
        np.asarray(blocked_gemm(xf, wf, interpret=True)), ref)
    got = gemm_plain(_t(x)[None, None], _t(w)[None, None])[0, 0]
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.int32))


def test_gemm_plain_batched_blocks_and_long_k():
    """(N, w_d, M, K) x (Nw, w_d, K, 16), shared and per-image weights, and
    K above the 1024-term f32 split, against int64 numpy."""
    x = RNG.integers(-128, 128, (3, 2, 19, 4608)).astype(np.int8)
    for nw in (1, 3):
        w = RNG.integers(-128, 128, (nw, 2, 4608, 16)).astype(np.int8)
        ref = np.einsum("njmk,njkc->njmc", x.astype(np.int64),
                        np.broadcast_to(w, (3,) + w.shape[1:])
                        .astype(np.int64))
        got = gemm_plain(_t(x), _t(w))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), ref)
    x = np.full((1, 1, 5, 4608), -128, np.int8)
    w = np.full((1, 1, 4608, 16), -128, np.int8)
    assert int(gemm_plain(_t(x), _t(w)).max()) == 4608 * 128 * 128


def _scratchpads(hw, n, nw=1, near_wrap=True):
    """Random int8 inp/wgt scratchpads of ``hw`` and an int32 acc within
    2^24 of +-2^31 (so adding a product wraps), numpy."""
    inp = RNG.integers(-128, 128, (n, hw.inp_depth, hw.batch, hw.block_in),
                       dtype=np.int8)
    wgt = RNG.integers(-128, 128, (nw, hw.wgt_depth, hw.block_out,
                                   hw.block_in), dtype=np.int8)
    shape = (n, hw.acc_depth, hw.batch, hw.block_out)
    if near_wrap:
        mag = 2**31 - RNG.integers(1, 2**24, shape, dtype=np.int64)
        acc = np.where(RNG.random(shape) < 0.5, mag, -mag).astype(np.int32)
    else:
        acc = RNG.integers(-2**20, 2**20, shape, dtype=np.int32)
    return acc, inp, wgt


def _entry_args(e):
    """(uidx, inp_idx, wrows, R, w_d, unique) of a ``_device_ops`` entry."""
    return e[3], e[4], e[5], e[1], e[2], e[6]


def test_gemm_wrapper_on_cpu_takes_plain_and_counts_nothing():
    """The fused entry's wrapper on CPU tensors is ``gemm_acc_plain``, counts
    no launch and refuses what the contract does not take."""
    hw = DEFAULT_VTA
    acc, inp, wgt = (_t(a) for a in _scratchpads(hw, 2))
    uidx = _t(np.array([5, 1, 9], np.int32))
    inp_idx = _t(RNG.integers(0, hw.inp_depth, 3 * 2).astype(np.int32))
    wrows = _t(np.array([3, 4], np.int32))
    before = launch_counts()["gemm"]
    got = vta_gemm(acc.clone(), inp, wgt, uidx, inp_idx, wrows, 2, 1)
    want = gemm_acc_plain(acc.clone(), inp, wgt, uidx, inp_idx, wrows, 2, 1)
    assert torch.equal(got, want) and not torch.equal(got, acc)
    assert launch_counts()["gemm"] == before
    with pytest.raises(TypeError):
        vta_gemm(acc, inp.to(torch.int32), wgt, uidx, inp_idx, wrows, 2, 1)
    with pytest.raises(ValueError):
        vta_gemm(acc, inp, wgt, uidx, inp_idx[:5], wrows, 2, 1)
    with pytest.raises(ValueError):
        vta_gemm(acc, inp, wgt, uidx, inp_idx, wrows, 2, 2)


def _layer_entries(kind, hw):
    """The port's GEMM entries of one small layer lowered at ``hw``: a 3x3
    conv, a pointwise conv, or an fc whose 17 output blocks exceed the 16
    weight blocks one entry shares (the per-group form, w_d = g)."""
    b = hw.batch
    if kind == "conv3x3":
        wl = ttps.ConvWorkload("c", b, 6, 6, 3, 3, 64, 64, 1, 1, 1, 1)
        kw = {}
    elif kind == "pointwise":
        wl = ttps.ConvWorkload("pw", b, 6, 6, 1, 1, 64, 128, 0, 0, 1, 1)
        kw = {}
    else:
        wl = ttps.ConvWorkload("fc", b, 1, 1, 1, 1, 64, 17 * hw.block_out, 0,
                               0, 1, 1)
        kw = dict(post_op="none", bias=True)
    res = ttps.tps_search(wl, hw, require_db=True)
    if not res.feasible:
        res = ttps.tps_search(wl, hw)
    prog = tsched.schedule_conv(wl, res.tiling, hw, **kw).program
    shapes = {"inp": (b, wl.fi, wl.h, wl.w), "wgt": (wl.fo, wl.fi, 1, 1)
              if kind != "conv3x3" else (wl.fo, wl.fi, 3, 3),
              "out": (b, wl.fo, wl.oh, wl.ow)}
    if kw:
        shapes["bias"] = (wl.fo,)
    trace = tlowering.lower(prog, hw, shapes)
    return [e for e in _device_ops(trace, "cpu") if e[0] == "gemm"]


@pytest.mark.parametrize("log_batch", [0, 1])
@pytest.mark.parametrize("log_block", [4, 5, 6])
@pytest.mark.parametrize("kind", ["conv3x3", "pointwise", "fc"])
def test_gemm_acc_plain_matches_jax_product_and_add(kind, log_block,
                                                    log_batch):
    """Lowered GEMM entries at every block size and both batch widths: the
    fused entry's plain version equals the JAX package's ``_gemm_product``
    (the Pallas kernel in interpret mode) followed by the same add into acc
    in numpy, bit for bit, with acc near the int32 wrap."""
    hw = dataclasses.replace(tisa.DEFAULT_VTA, log_block_in=log_block,
                             log_block_out=log_block, log_batch=log_batch)
    entries = _layer_entries(kind, hw)
    assert entries
    if kind == "fc":
        e = entries[0]
        assert e[2] == len(e[3]) == 17      # one weight block per group
    e = entries[0]
    uidx, inp_idx, wrows, R, w_d, unique = _entry_args(e)
    assert unique and uidx.dtype == torch.int32
    acc, inp, wgt = _scratchpads(hw, 1)
    got = gemm_acc_plain(_t(acc), _t(inp), _t(wgt), uidx, inp_idx, wrows, R,
                         w_d, unique)
    g = uidx.numel()
    prod = _gemm_product(jnp.asarray(inp[0][inp_idx.numpy()]),
                         jnp.asarray(wgt[0][wrows.numpy()]), g, R, w_d,
                         "pallas_interpret")
    want = acc[0].copy()
    np.add.at(want, uidx.numpy(), np.asarray(prod))
    np.testing.assert_array_equal(got[0].numpy(), want)
    assert np.any(want != acc[0])


def test_gemm_acc_plain_sums_duplicate_targets():
    """An entry whose acc targets repeat (the kernel's atomic path) and
    whose weights differ per image: every contribution lands, as an int64
    numpy sum narrowed to int32."""
    hw = DEFAULT_VTA
    acc, inp, wgt = _scratchpads(hw, 3, nw=3)
    g, R, w_d = 12, 5, 3
    uidx = np.array([7, 2, 7, 7, 2, 9, 0, 9, 2, 7, 0, 0], np.int32)
    inp_idx = RNG.integers(0, hw.inp_depth, g * R).astype(np.int32)
    wrows = RNG.integers(0, hw.wgt_depth, w_d * R).astype(np.int32)
    got = gemm_acc_plain(_t(acc), _t(inp), _t(wgt), _t(uidx), _t(inp_idx),
                         _t(wrows), R, w_d, unique=False)
    want = acc.astype(np.int64)
    gb = g // w_d
    for n in range(3):
        for q in range(g):
            j = q // gb
            x = inp[n, inp_idx[q * R:(q + 1) * R]].astype(np.int64)
            w = wgt[n, wrows[j * R:(j + 1) * R]].astype(np.int64)
            want[n, uidx[q]] += np.einsum("rvi,roi->vo", x, w)
    want = ((want + 2**31) % 2**32 - 2**31).astype(np.int32)
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# ALU chains and sweeps
# ---------------------------------------------------------------------------
def _depthwise(hw, h, c):
    wl = ConvWorkload("dw", 1, h, h, 3, 3, c, c, 1, 1, 1, 1, depthwise=True)
    prog = schedule_depthwise(wl, hw).program
    dram = {"inp": RNG.integers(-128, 128, (1, c, h, h), dtype=np.int8),
            "dw_wgt": RNG.integers(-8, 8, (c, 3, 3), dtype=np.int8),
            "out": np.zeros((1, c, h, h), np.int8)}
    return prog, dram


def _acc(hw):
    return RNG.integers(-2**24, 2**24, (hw.acc_depth, hw.batch, hw.block_out),
                        dtype=np.int32)


def test_eval_chain_plain_matches_lax_and_pallas():
    """Every real chain of a small depthwise trace: the plain chain equals
    the JAX lax composite and the Pallas kernel (interpret)."""
    hw = DEFAULT_VTA
    prog, dram = _depthwise(hw, 8, 16)
    trace = lower(prog, hw, {k: v.shape for k, v in dram.items()})
    assert trace.alu_chains
    acc = _acc(hw)
    for c in trace.alu_chains[:4]:
        args = [jnp.asarray(a) for a in c.args]
        o_lax = np.asarray(eval_chain(jnp.asarray(acc), jnp.asarray(c.dst),
                                      c.stages, args, unique=c.unique))
        o_pl = np.asarray(pallas_chain(jnp.asarray(acc), jnp.asarray(c.dst),
                                       c.stages, args, unique=c.unique,
                                       interpret=True))
        np.testing.assert_array_equal(o_lax, o_pl)
        got = eval_chain_plain(_t(acc)[None], _ix(c.dst), c.stages,
                               [_ix(a) for a in c.args], unique=c.unique)
        np.testing.assert_array_equal(got[0].numpy(), o_lax)
        # the encoded program, through the kernel's CPU wrapper
        a2 = alu_chain(_t(acc)[None], SweepProgram(
            c.stages, c.dst, [("acc", a) for a in c.args],
            lane_shape=(hw.batch, hw.block_out)))
        np.testing.assert_array_equal(a2[0].numpy(), o_lax)


def _jax_sweep(fn, acc, c, dram, *, force_scatter=False, **extra):
    slabs = []
    for s in c.slabs:
        mask = jnp.asarray(s.mask) if s.mask is not None else None
        slabs.append((jnp.asarray(dram[s.tensor].reshape(-1)),
                      jnp.asarray(s.index), mask, s.fill))
    oa = [("acc", jnp.asarray(a)) if isinstance(src, str)
          else (src[0], jnp.asarray(src[1]))
          for src, a in zip(c.arg_src, c.args)]
    kw = {}
    st = c.store
    if st is not None:
        kw["out_flat"] = jnp.asarray(dram[st.tensor].reshape(-1))
        kw["store_unique"], kw["store_sorted"] = st.unique, st.sorted
        if st.affine is not None and not force_scatter:
            kw["store_affine"] = st.affine[:3]
            kw["store_idx"] = jnp.asarray(np.asarray(st.affine[3], np.int32))
        else:
            kw["store_idx"] = jnp.asarray(st.index)
            if st.mask is not None:
                kw["store_mask"] = jnp.asarray(st.mask)
    a2, o2 = fn(jnp.asarray(acc), jnp.asarray(c.dst), c.stages, oa,
                slabs=slabs, write_acc=c.write_acc, unique=c.unique,
                sorted_=c.sorted, **kw, **extra)
    return np.asarray(a2), None if o2 is None else np.asarray(o2)


def _plain_sweep(acc, c, dram, *, force_scatter=False, shared=()):
    slabs = []
    for s in c.slabs:
        flat = _t(dram[s.tensor].reshape(-1))
        if s.tensor not in shared:
            flat = flat[None]
        mask = None if s.mask is None else torch.from_numpy(s.mask.copy())
        slabs.append((flat, _ix(s.index), mask, s.fill))
    oa = [("acc", _ix(a)) if isinstance(src, str) else ("local", _ix(src[1]))
          for src, a in zip(c.arg_src, c.args)]
    kw = {}
    st = c.store
    if st is not None:
        kw["out_flat"] = _t(dram[st.tensor].reshape(-1))[None]
        kw["store_unique"] = st.unique
        if st.affine is not None and not force_scatter:
            kw["store_affine"] = st.affine[:3]
            kw["store_idx"] = list(st.affine[3])
        else:
            kw["store_idx"] = _ix(st.index)
            if st.mask is not None:
                kw["store_mask"] = torch.from_numpy(st.mask.copy())
    a2, o2 = eval_sweep_plain(_t(acc)[None], _ix(c.dst), c.stages, oa,
                              slabs=slabs, write_acc=c.write_acc,
                              unique=c.unique, **kw)
    return a2[0].numpy(), None if o2 is None else o2[0].numpy()


def test_eval_sweep_plain_matches_lax_pallas_and_scatter():
    """DRAM-direct depthwise sweeps: the plain sweep (affine store, forced
    scatter, shared weight slab) equals the JAX lax sweep, its forced
    scatter and the Pallas kernel (interpret)."""
    hw = PIPELINED_VTA
    prog, dram = _depthwise(hw, 14, 64)
    trace = lower(prog, hw, {k: v.shape for k, v in dram.items()})
    direct = [c for c in trace.alu_chains if c.slabs and c.store is not None
              and c.store.affine is not None]
    assert direct
    acc = _acc(hw)
    for c in direct[:2]:
        a_ref, o_ref = _jax_sweep(eval_sweep, acc, c, dram)
        a_sc, o_sc = _jax_sweep(eval_sweep, acc, c, dram, force_scatter=True)
        a_pl, o_pl = _jax_sweep(pallas_sweep, acc, c, dram, interpret=True)
        for a, o in ((a_sc, o_sc), (a_pl, o_pl)):
            np.testing.assert_array_equal(a, a_ref)
            np.testing.assert_array_equal(o, o_ref)
        for kw in ({}, {"force_scatter": True}, {"shared": ("dw_wgt",)}):
            a, o = _plain_sweep(acc, c, dram, **kw)
            np.testing.assert_array_equal(a, a_ref)
            np.testing.assert_array_equal(o, o_ref)
        assert np.any(o_ref != dram[c.store.tensor].reshape(-1))
        # the encoded program through the kernel's CPU wrapper, shared slab
        p = _sweep_program(c, hw)
        flats = [_t(dram[t].reshape(-1)) if t == "dw_wgt"
                 else _t(dram[t].reshape(-1))[None] for t in p.slab_tensors]
        a, o = alu_sweep(_t(acc)[None], p, flats,
                         _t(dram["out"].reshape(-1))[None])
        np.testing.assert_array_equal(a[0].numpy(), a_ref)
        np.testing.assert_array_equal(o[0].numpy(), o_ref)


def test_encoded_store_positions_match_the_index_maps():
    """What the CUDA kernel writes through: the affine block decoded to flat
    positions is the store's own index map; masked and non-winning
    duplicate lanes are -1."""
    hw = PIPELINED_VTA
    prog, dram = _depthwise(hw, 14, 64)
    trace = lower(prog, hw, {k: v.shape for k, v in dram.items()})
    checked = 0
    for c in trace.alu_chains:
        st = c.store
        if st is None or st.affine is None:
            continue
        pos = _affine_positions(st.affine[:3], st.affine[3],
                                (len(c.dst), hw.batch, hw.block_out))
        np.testing.assert_array_equal(pos, st.index)
        checked += 1
    assert checked
    idx = np.array([[3, 1, 3, 0, 1, 3]])
    mask = np.array([[True, True, True, True, False, False]])
    np.testing.assert_array_equal(last_writer_positions(idx, mask, False),
                                  [-1, 1, 3, 0, -1, -1])
    np.testing.assert_array_equal(last_writer_positions(idx, None, False),
                                  [-1, -1, -1, 0, 1, 3])


def test_integer_edge_cases_match_jax():
    """int32 wraparound, SHR counts outside [0, 31] (sign fill), CLIP with a
    negative immediate (clamps to its abs), a MAC + reduce chain, and a
    masked store with duplicate positions (last writer wins, as numpy)."""
    hw = DEFAULT_VTA
    g = 24
    acc = RNG.integers(-2**31, 2**31, (hw.acc_depth, hw.batch, hw.block_out),
                       dtype=np.int64).astype(np.int32)
    acc[180:204] = RNG.integers(-40, 41, (g, hw.batch, hw.block_out))
    dst = np.arange(g, dtype=np.int32)

    def rows(k):
        return np.arange(100 + 40 * k, 100 + 40 * k + g, dtype=np.int32)

    programs = [
        ((("seed_copy",), ("src", "mul"), ("src", "shr"), ("src", "add"),
          ("imm", "clip", -70000), ("imm", "mul", 3)),
         [rows(0), rows(1), rows(2), rows(3)]),
        ((("read_dst",), ("mac", 3), ("red", "max", 2), ("imm", "shr", 35),
          ("imm", "add", -5)),
         [np.stack([rows(k) for k in range(3)]),
          np.array([90, 91, 92], np.int32),
          np.stack([rows(k) for k in (4, 5)])]),
        ((("seed_imm", -7), ("imm", "shr", -3), ("red", "add", 3)),
         [np.stack([rows(k) for k in range(3)])]),
    ]
    for stages, args in programs:
        ref = np.asarray(eval_chain(jnp.asarray(acc), jnp.asarray(dst),
                                    stages, [jnp.asarray(a) for a in args],
                                    unique=True))
        got = eval_chain_plain(_t(acc)[None], _ix(dst), stages,
                               [_ix(a) for a in args], unique=True)
        np.testing.assert_array_equal(got[0].numpy(), ref)
        p = SweepProgram(stages, dst, [("acc", a) for a in args],
                         lane_shape=(hw.batch, hw.block_out))
        np.testing.assert_array_equal(
            alu_chain(_t(acc)[None], p)[0].numpy(), ref)
    # masked store with duplicate positions, no acc write
    index = RNG.integers(0, 60, (g, hw.batch, hw.block_out)).astype(np.int32)
    mask = RNG.random(index.shape) < 0.7
    out = RNG.integers(-128, 128, 300, dtype=np.int8)
    stages = (("seed_copy",), ("imm", "shr", 20))
    _, o_ref = eval_sweep(jnp.asarray(acc), jnp.asarray(dst), stages,
                          [("acc", jnp.asarray(rows(0)))], write_acc=False,
                          out_flat=jnp.asarray(out),
                          store_idx=jnp.asarray(index),
                          store_mask=jnp.asarray(mask))
    v = np.clip(acc[rows(0)] >> 20, -128, 127).astype(np.int8)
    o_np = out.copy()
    o_np[index[mask]] = v[mask]                  # numpy: last writer wins
    np.testing.assert_array_equal(np.asarray(o_ref), o_np)
    _, o_pl = eval_sweep_plain(
        _t(acc)[None], _ix(dst), stages, [("acc", _ix(rows(0)))],
        write_acc=False, out_flat=_t(out)[None], store_idx=_ix(index),
        store_mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(o_pl[0].numpy(), o_np)
    p = SweepProgram(stages, dst, [("acc", rows(0))], write_acc=False,
                     lane_shape=(hw.batch, hw.block_out),
                     store=("out", index, mask, False, None, None))
    a2, o2 = alu_sweep(_t(acc)[None], p, [], _t(out)[None])
    np.testing.assert_array_equal(o2[0].numpy(), o_np)
    np.testing.assert_array_equal(a2[0].numpy(), acc)


def test_sweep_launch_validates_inputs_before_building():
    """The CUDA wrapper refuses what the kernel cannot take — dtype, acc
    depth, slab count and length, store length, a store aliasing a slab —
    before any pointer is passed (checked here on CPU tensors; the build
    is never reached)."""
    from repro_torch.kernels import alu_sweep as ks
    hw = DEFAULT_VTA
    lanes = (hw.batch, hw.block_out)
    index = np.arange(2 * 16).reshape(2, 1, 16).astype(np.int32)
    p = SweepProgram((("seed_copy",), ("red", "max", 1)), np.arange(2),
                     [("local", np.array([0, 1])),
                      ("local", np.array([[1, 0]]))],
                     lane_shape=lanes, write_acc=False,
                     slabs=(("inp", index, None, 0),),
                     store=("out", index, None, True, None, None))
    acc = torch.zeros((2, 4, 1, 16), dtype=torch.int32)
    flat = torch.zeros((2, 32), dtype=torch.int8)
    out = torch.zeros((2, 32), dtype=torch.int8)
    bad = [
        (acc.to(torch.int64), [flat], out),
        (torch.zeros((2, 4, 1, 8), dtype=torch.int32), [flat], out),
        (acc, [], out),
        (acc, [flat[:, :16].contiguous()], out),
        (acc, [flat], out[:, :16].contiguous()),
        (acc, [flat], None),
        (acc, [out], out),
    ]
    for a, f, o in bad:
        with pytest.raises(ValueError):
            ks._launch(a, p, f, o)
    chain = SweepProgram((("seed_copy",),), np.array([300]),
                         [("acc", np.array([301]))], lane_shape=lanes)
    with pytest.raises(ValueError, match="depth"):
        ks._launch(acc, chain, (), None)


# ---------------------------------------------------------------------------
# The tap split of the ALU stage-program kernel
# ---------------------------------------------------------------------------
def _chain(stages, args, g=4):
    return SweepProgram(stages, np.arange(g, dtype=np.int32),
                        [("acc", a) for a in args],
                        lane_shape=(DEFAULT_VTA.batch, DEFAULT_VTA.block_out))


def _taps(t, g=4, base=100):
    return np.arange(base, base + t * g, dtype=np.int32).reshape(t, g)


@pytest.mark.parametrize("stages,cap", [
    ((("seed_copy",), ("red", "add", 48), ("imm", "shr", 6)), 32),
    ((("seed_copy",), ("red", "max", 8)), 8),
    ((("read_dst",), ("red", "min", 3)), 2),
    ((("read_dst",), ("mac", 9)), 8),
    ((("seed_copy",), ("red", "shr", 8)), 1),
    ((("seed_copy",), ("red", "mul", 16)), 1),
    ((("read_dst",), ("mac", 9), ("red", "mul", 4)), 1),
    ((("read_dst",), ("imm", "shr", 8), ("imm", "clip", 127)), 1),
])
def test_sweep_plan_splits_only_order_free_taps(stages, cap):
    """``max_split`` is the largest power of two up to the longest tap stage
    (at most a warp), and 1 wherever a ``red`` op depends on the order of
    its taps; ``sweep_plan`` stays within it and grows S only while the
    launch does not fill the card."""
    args = []
    for st in stages:
        if st[0] == "seed_copy":
            args.append(np.arange(50, 54, dtype=np.int32))
        elif st[0] == "red":
            args.append(_taps(int(st[2])))
        elif st[0] == "mac":
            args += [_taps(int(st[1])), np.arange(40, 40 + int(st[1]),
                                                  dtype=np.int32)]
    p = _chain(stages, args)
    assert max_split(p) == cap
    for n in (1, 2, 8, 4096):
        s = sweep_plan(p, n)
        assert 1 <= s <= cap and s & (s - 1) == 0
        items = n * p.g * p.lanes
        if s < cap:
            assert items * s >= FILL_THREADS
        if s > 1:
            assert items * s // 2 < FILL_THREADS


def test_sweep_plan_fills_the_card_for_the_global_average_pool():
    """The trunk's GAP sweep (one row, 48 taps) at batch 8 runs as at least
    16 blocks of 256 threads; one thread an item would be a single block."""
    p = _chain((("seed_copy",), ("red", "add", 48), ("imm", "shr", 6)),
               [np.array([0], np.int32), _taps(48, g=1)], g=1)
    items = 8 * p.g * p.lanes
    assert items <= 256
    assert items * sweep_plan(p, 8) // 256 >= 16


def _wrap(x):
    return ((np.asarray(x, np.int64) + 2**31) % 2**32 - 2**31).astype(
        np.int64)


def _split_order(op, v, taps, S):
    """The kernel's order for one item: thread ``sub`` folds taps sub,
    sub + S, ... from the op's identity, the S partials meet by xor
    butterfly (offsets S/2 ... 1), then the stage's value takes the sum.
    int32 wrapping throughout; ``taps`` (T, ...) int64 values."""
    fold = {"add": lambda a, b: _wrap(a + b), "max": np.maximum,
            "min": np.minimum}[op]
    ident = {"add": 0, "max": -2**31, "min": 2**31 - 1}[op]
    parts = []
    for sub in range(S):
        p = np.full(taps.shape[1:], ident, np.int64)
        for t in range(sub, len(taps), S):
            p = fold(p, taps[t])
        parts.append(p)
    o = S // 2
    while o:
        parts = [fold(parts[i], parts[i ^ o]) for i in range(S)]
        o //= 2
    assert all(np.array_equal(parts[0], q) for q in parts)
    return fold(v, parts[0])


@pytest.mark.parametrize("op", ["add", "max", "min", "mac"])
def test_split_order_equals_plain_near_the_int32_wrap(op):
    """Every split the kernel may take (S = 1 ... 32) reduces a tap stage
    to the plain version's result, bit for bit, with operands near +-2^31
    where the int32 sums wrap."""
    hw = DEFAULT_VTA
    T, g = 37, 4
    acc = RNG.integers(-2**31, 2**31, (hw.acc_depth, hw.batch, hw.block_out),
                       dtype=np.int64)
    acc[RNG.random(acc.shape) < 0.5] |= 0x7FFF0000
    acc = acc.astype(np.int32)
    rows = _taps(T, g)
    if op == "mac":
        src2 = np.arange(40, 40 + T, dtype=np.int32)
        stages = (("read_dst",), ("mac", T))
        args = [rows, src2]
        taps = _wrap(acc[rows].astype(np.int64)
                     * acc[src2][:, None].astype(np.int64))
    else:
        stages = (("read_dst",), ("red", op, T))
        args = [rows]
        taps = acc[rows].astype(np.int64)
    want = eval_chain_plain(_t(acc)[None], _ix(np.arange(g)), stages,
                            [_ix(a) for a in args], unique=True)[0][:g]
    v = acc[:g].astype(np.int64)
    for S in (1, 2, 4, 8, 16, 32):
        got = _split_order("add" if op == "mac" else op, v, taps, S)
        np.testing.assert_array_equal(got, want.numpy())
    assert max_split(_chain(stages, args)) == 32
