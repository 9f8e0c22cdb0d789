"""The port's executor, ``TorchBackend(device="cpu")``, against the JAX
package's ``"numpy"`` (the oracle) and ``"jax"`` backends, on the CPU.

Tolerance: 0 everywhere — int8 outputs compared bit for bit. Each case
builds its program and inputs in the JAX package from a numpy seed; the
port lowers and runs the same program built by its own copy of the
scheduler (the drift tests prove the two builds identical) on copies of the
same arrays.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core.tps import ConvWorkload as JConvWorkload
from repro.core.tps import tps_search as j_tps_search
from repro.vta import backend as jbackend
from repro.vta import compiler as jcompiler
from repro.vta import graph as jgraph
from repro.vta import isa as jisa
from repro.vta import scheduler as jsched
from repro.vta import workloads as jworkloads
from repro_torch.core.tps import ConvWorkload, tps_search
from repro_torch.vta import compiler, graph, isa, scheduler, workloads
from repro_torch.vta.backend import available_backends, get_backend
from repro_torch.vta.fsim_torch import TorchBackend

RNG = np.random.default_rng(31)


def _both(build):
    """(JAX program, port program): ``build(ConvWorkload, tps_search, isa,
    scheduler, graph, compiler, workloads)`` run against each package."""
    return (build(JConvWorkload, j_tps_search, jisa, jsched, jgraph,
                  jcompiler, jworkloads),
            build(ConvWorkload, tps_search, isa, scheduler, graph, compiler,
                  workloads))


def _run_all(progs, hw_name, dram, *, jax_too=True):
    """Run numpy, (jax), and torch-cpu; assert equal; return numpy's dram."""
    jprog, tprog = progs
    jhw, thw = getattr(jisa, hw_name), getattr(isa, hw_name)
    d_np = {k: v.copy() for k, v in dram.items()}
    jbackend.get_backend("numpy").run(jprog, jhw, d_np)
    d_t = {k: v.copy() for k, v in dram.items()}
    get_backend("torch-cpu").run(tprog, thw, d_t)
    for k in dram:
        np.testing.assert_array_equal(d_t[k], d_np[k])
    if jax_too:
        d_jx = {k: v.copy() for k, v in dram.items()}
        jbackend.get_backend("jax").run(jprog, jhw, d_jx)
        for k in dram:
            np.testing.assert_array_equal(d_t[k], d_jx[k])
    return d_np


def _conv_build(wl_args, post_op, bias, dedup, hw_name):
    def build(CW, tps, isa_, sched, *_):
        wl = CW(*wl_args)
        hw = getattr(isa_, hw_name)
        res = tps(wl, hw, require_db=True)
        if not res.feasible:
            res = tps(wl, hw)
        return sched.schedule_conv(wl, res.tiling, hw, post_op=post_op,
                                   dedup_loads=dedup, bias=bias).program
    return build


@pytest.mark.parametrize("wl,kw", [
    (("r18.C8", 1, 14, 14, 3, 3, 256, 256, 1, 1, 1, 1), dict(dedup=True)),
    (("r18.C10", 1, 14, 14, 1, 1, 256, 512, 0, 0, 2, 2), {}),
    (("r18.fc", 1, 1, 1, 1, 1, 512, 1008, 0, 0, 1, 1),
     dict(post_op="none", bias=True)),
    (("mbn.pw3", 1, 28, 28, 1, 1, 256, 256, 0, 0, 1, 1),
     dict(post_op="relu_shift")),
])
def test_conv_matches_numpy_and_jax(wl, kw):
    progs = _both(_conv_build(wl, kw.get("post_op", "clip_shift"),
                              kw.get("bias", False), kw.get("dedup", False),
                              "PIPELINED_VTA"))
    w = JConvWorkload(*wl)
    dram = {"inp": RNG.integers(-32, 32, (1, w.fi, w.h, w.w), dtype=np.int8),
            "wgt": RNG.integers(-8, 8, (w.fo, w.fi, w.kh, w.kw),
                                dtype=np.int8),
            "out": np.zeros((1, w.fo, w.oh, w.ow), np.int8)}
    if kw.get("bias"):
        dram["bias"] = RNG.integers(-100, 100, (w.fo,), dtype=np.int32)
    out = _run_all(progs, "PIPELINED_VTA", dram, jax_too=wl[0] != "r18.C8")
    assert np.any(out["out"])


@pytest.mark.parametrize("log_block,log_batch", [(5, 0), (5, 1), (6, 0)])
def test_wide_block_conv_matches_numpy(log_block, log_batch):
    """A whole 3x3 conv trace at block 32 or 64 (and batch 2): torch-cpu,
    whose GEMM entries take the fused gather-product-add contract at these
    widths, equals the JAX package's numpy backend."""
    wl = ("c", 1 << log_batch, 8, 8, 3, 3, 64, 128, 1, 1, 1, 1)

    def build(CW, tps, isa_, sched, *_):
        hw = dataclasses.replace(isa_.DEFAULT_VTA, log_block_in=log_block,
                                 log_block_out=log_block, log_batch=log_batch)
        w = CW(*wl)
        res = tps(w, hw, require_db=True)
        if not res.feasible:
            res = tps(w, hw)
        return sched.schedule_conv(w, res.tiling, hw).program, hw
    (jprog, jhw), (tprog, thw) = _both(build)
    assert repr(jhw) == repr(thw)
    w = JConvWorkload(*wl)
    dram = {"inp": RNG.integers(-32, 32, (w.b, w.fi, w.h, w.w), dtype=np.int8),
            "wgt": RNG.integers(-8, 8, (w.fo, w.fi, w.kh, w.kw),
                                dtype=np.int8),
            "out": np.zeros((w.b, w.fo, w.oh, w.ow), np.int8)}
    d_np = {k: v.copy() for k, v in dram.items()}
    jbackend.get_backend("numpy").run(jprog, jhw, d_np)
    d_t = {k: v.copy() for k, v in dram.items()}
    get_backend("torch-cpu").run(tprog, thw, d_t)
    np.testing.assert_array_equal(d_t["out"], d_np["out"])
    assert np.any(d_np["out"])


@pytest.mark.parametrize("wl,mode", [
    (("mbn.dw4", 1, 28, 28, 3, 3, 256, 256, 1, 1, 1, 1), "dw"),
    (("mbn.dw1", 1, 56, 56, 3, 3, 128, 128, 1, 1, 2, 2), "dw"),
    (("r18.pool1", 1, 112, 112, 3, 3, 64, 64, 1, 1, 2, 2), "max"),
    (("gap", 1, 7, 7, 7, 7, 512, 512, 0, 0, 7, 7), "avg"),
])
def test_alu_programs_match_numpy(wl, mode):
    """Depthwise and pool programs: the fused chain and sweep paths."""
    def build(CW, tps, isa_, sched, *_):
        hw = isa_.PIPELINED_VTA
        if mode == "dw":
            return sched.schedule_depthwise(CW(*wl, depthwise=True),
                                            hw).program
        return sched.schedule_pool(CW(*wl), hw, mode=mode).program
    w = JConvWorkload(*wl, depthwise=mode == "dw")
    dram = {"inp": RNG.integers(-128, 127, (1, w.fi, w.h, w.w),
                                dtype=np.int8),
            "out": np.zeros((1, w.fo, w.oh, w.ow), np.int8)}
    if mode == "dw":
        dram["dw_wgt"] = RNG.integers(-8, 8, (w.fi, 3, 3), dtype=np.int8)
    out = _run_all(_both(build), "PIPELINED_VTA", dram, jax_too=False)
    assert np.any(out["out"])


def _fused_build(CW, tps, isa_, sched, graph_, compiler_, wls):
    g = graph_.Graph(name="t")
    g.input("image", (1, 16, 8, 8))
    g.layer(wls._conv("a", 1, 8, 16, 16, 3, 1, 1), "image")
    g.layer(wls._conv("b", 1, 8, 16, 16, 3, 1, 1), "a")
    g.residual_add("add", "b", "a", layer=wls._add("add", 1, 8, 16))
    return [s for s in compiler_.compile_graph(g, isa_.DEFAULT_VTA)
            if s.multi][0].program


def test_fused_segment_matches_numpy_and_jax():
    """conv -> add -> clip compiled as one segment (multi-tensor DRAM)."""
    dram = {"a": RNG.integers(-64, 64, (1, 16, 8, 8), dtype=np.int8),
            "b.wgt": RNG.integers(-8, 8, (16, 16, 3, 3), dtype=np.int8),
            "add": np.zeros((1, 16, 8, 8), np.int8)}
    out = _run_all(_both(_fused_build), "DEFAULT_VTA", dram)
    assert np.any(out["add"])


def test_resident_chain_spill_matches_numpy_and_jax():
    """Resident two-conv chain: on-chip spill stores + loadless consumer."""
    def build(CW, tps, isa_, sched, graph_, compiler_, wls):
        g = graph_.Graph(name="chain")
        g.input("image", (1, 16, 8, 8))
        g.layer(wls._conv("c1", 1, 8, 16, 16, 3, 1, 1), "image")
        g.layer(wls._conv("c2", 1, 8, 16, 32, 1, 0, 1), "c1")
        segs = compiler_.compile_graph(g, isa_.DEFAULT_VTA)
        assert len(segs) == 1 and segs[0].resident_edges == ("c1->c2",)
        return segs[0].program
    dram = {"image": RNG.integers(-32, 32, (1, 16, 8, 8), dtype=np.int8),
            "c1.wgt": RNG.integers(-8, 8, (16, 16, 3, 3), dtype=np.int8),
            "c2.wgt": RNG.integers(-8, 8, (32, 16, 1, 1), dtype=np.int8),
            "c2": np.zeros((1, 32, 8, 8), np.int8)}
    out = _run_all(_both(build), "DEFAULT_VTA", dram)
    assert np.any(out["c2"])


def test_run_batched_matches_sequential_and_jax():
    """N = 4 images with shared weights: torch-cpu batched equals numpy's
    sequential per-image runs and the jax backend's batch, and leaves the
    caller's arrays untouched."""
    jprog, tprog = _both(_conv_build(
        ("c", 1, 14, 14, 3, 3, 32, 32, 1, 1, 1, 1), "clip_shift", False,
        False, "DEFAULT_VTA"))
    shared = {"wgt": RNG.integers(-8, 8, (32, 32, 3, 3), dtype=np.int8)}
    batched = {"inp": RNG.integers(-32, 32, (4, 1, 32, 14, 14),
                                   dtype=np.int8),
               "out": np.zeros((4, 1, 32, 14, 14), np.int8)}
    keep = {k: v.copy() for k, v in {**shared, **batched}.items()}
    o_t = get_backend("torch-cpu").run_batched(
        tprog, isa.DEFAULT_VTA, shared=shared, batched=batched)
    for k, v in {**shared, **batched}.items():
        np.testing.assert_array_equal(v, keep[k])
    o_np = jbackend.get_backend("numpy").run_batched(
        jprog, jisa.DEFAULT_VTA, shared=shared,
        batched={k: v.copy() for k, v in batched.items()})
    o_jx = jbackend.get_backend("jax").run_batched(
        jprog, jisa.DEFAULT_VTA, shared=shared,
        batched={k: v.copy() for k, v in batched.items()})
    assert isinstance(o_t["out"], torch.Tensor)
    np.testing.assert_array_equal(o_t["out"].numpy(), o_np["out"])
    np.testing.assert_array_equal(o_t["out"].numpy(), o_jx["out"])
    # torch tensors in, on the backend's device
    o_t2 = get_backend("torch-cpu").run_batched(
        tprog, isa.DEFAULT_VTA,
        shared={k: torch.from_numpy(v) for k, v in shared.items()},
        batched={k: torch.from_numpy(v) for k, v in batched.items()})
    assert torch.equal(o_t2["out"], o_t["out"])
    np.testing.assert_array_equal(batched["out"], keep["out"])


def test_masked_edge_store_clamps():
    """14x14 pool s2 -> 7x7: shrink-tiled edge stores write only in-bounds
    lanes; untouched positions keep their prior value."""
    def build(CW, tps, isa_, sched, *_):
        return sched.schedule_pool(CW("p", 1, 14, 14, 3, 3, 16, 16, 1, 1,
                                      2, 2), isa_.DEFAULT_VTA,
                                   mode="max").program
    dram = {"inp": RNG.integers(-128, 127, (1, 16, 14, 14), dtype=np.int8),
            "out": np.full((1, 16, 7, 7), 77, np.int8)}
    _run_all(_both(build), "DEFAULT_VTA", dram)


@pytest.mark.parametrize("stride", [1, 2])
def test_depthwise_small_matches_jax(stride):
    """Padded depthwise with full int8-range activations (the JAX fusion
    tests' case), on the jax backend too."""
    def build(CW, tps, isa_, sched, *_):
        wl = CW("dw", 1, 14, 14, 3, 3, 32, 32, 1, 1, stride, stride,
                depthwise=True)
        return sched.schedule_depthwise(wl, isa_.PIPELINED_VTA).program
    wl = JConvWorkload("dw", 1, 14, 14, 3, 3, 32, 32, 1, 1, stride, stride,
                       depthwise=True)
    dram = {"inp": RNG.integers(-128, 128, (1, 32, 14, 14), dtype=np.int8),
            "dw_wgt": RNG.integers(-8, 8, (32, 3, 3), dtype=np.int8),
            "out": np.zeros((1, 32, wl.oh, wl.ow), np.int8)}
    _run_all(_both(build), "PIPELINED_VTA", dram)


def test_card_entry_points_raise_without_cuda(monkeypatch):
    """No fallback: the card backend refuses to run where there is no CUDA
    device; the CPU is used only when asked for."""
    from repro_torch.vta import backend as tbackend
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tbackend, "_INSTANCES", {})
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchBackend()
    with pytest.raises(RuntimeError, match="CUDA"):
        get_backend("torch")
    with pytest.raises(RuntimeError, match="CUDA"):
        get_backend(None)
    cpu = TorchBackend(device="cpu")
    assert cpu.name == "torch-cpu" and cpu.gemm_impl == "torch"
    assert {"torch", "torch-cpu"} <= set(available_backends())
    with pytest.raises(KeyError):
        get_backend("verilog")
