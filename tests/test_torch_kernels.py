"""Parity of the port's kernels (``repro_torch.kernels``) with the JAX
package's, on the CPU.

Tolerance: 0 everywhere — the results are integers and are compared bit for
bit. Each test makes its inputs with numpy from a seed and hands the same
arrays to the JAX function (its lax version and its Pallas kernel in
interpret mode, as the JAX package's own tests run them) and to the port's
plain version. On CPU tensors the kernels' wrappers take the plain versions
and count no launch.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.tps import ConvWorkload
from repro.kernels.alu_sweep import (eval_chain, eval_sweep, pallas_chain,
                                     pallas_sweep)
from repro.kernels.vta_gemm import _einsum_gemm, blocked_gemm
from repro.vta.isa import DEFAULT_VTA, PIPELINED_VTA
from repro.vta.lowering import lower
from repro.vta.scheduler import schedule_depthwise
from repro_torch.kernels import launch_counts
from repro_torch.kernels.alu_sweep import (SweepProgram, _affine_positions,
                                           alu_chain, alu_sweep,
                                           eval_chain_plain, eval_sweep_plain,
                                           last_writer_positions)
from repro_torch.kernels.vta_gemm import gemm_plain, vta_gemm
from repro_torch.vta.fsim_torch import _sweep_program

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


def test_gemm_wrapper_on_cpu_takes_plain_and_counts_nothing():
    x = _t(RNG.integers(-128, 128, (2, 3, 7, 32)).astype(np.int8))
    w = _t(RNG.integers(-128, 128, (1, 3, 32, 16)).astype(np.int8))
    before = launch_counts()["gemm"]
    assert torch.equal(vta_gemm(x, w), gemm_plain(x, w))
    assert launch_counts()["gemm"] == before
    with pytest.raises(TypeError):
        vta_gemm(x.to(torch.int32), w)
    with pytest.raises(ValueError):
        vta_gemm(x, w[:, :2])


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
