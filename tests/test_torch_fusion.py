"""The port's fusion levels, dispatch counters, captures and stepped
execution against the JAX package's, on the CPU.

Mirrors tests/test_pallas_fusion.py (segment fusion, ALU-chain fusion,
divergence localization) and tests/test_serve.py's compile-reuse test with
``"torch-cpu"``: the port's ``kernel_launch_log()`` must equal
``fsim_jax.kernel_launch_log()`` under the same ``chunk_cap``,
``alu_fusion`` and ``segment_fusion``, and every output must equal the
numpy oracle (the JAX package's and the port's copy) and the ``jax``
backend bit for bit. Tolerance: 0. Each program is built twice from the
same arguments, once by each package (the drift tests prove the builds
identical); inputs come from a numpy seed.
"""
import copy

import numpy as np
import pytest
import torch

from repro.core.tps import ConvWorkload as JConvWorkload
from repro.serve import model as jmodel
from repro.vta import backend as jbackend
from repro.vta import compiler as jcompiler
from repro.vta import fsim_jax
from repro.vta import graph as jgraph
from repro.vta import isa as jisa
from repro.vta import scheduler as jsched
from repro.vta import workloads as jworkloads
from repro_torch.core.tps import ConvWorkload
from repro_torch.kernels import registry
from repro_torch.serve.engine import VTAServeEngine
from repro_torch.serve.model import load_params, served_model
from repro_torch.vta import backend as tbackend
from repro_torch.vta import compiler, fsim_torch, graph, isa, scheduler
from repro_torch.vta import workloads
from repro_torch.vta.fsim_torch import TorchBackend
from repro_torch.vta.lowering import enclosing_kernel, lower_cached
from repro_torch.vta.runtime import Program
from repro_torch.vta.trace import (diff_backends, first_divergence,
                                   record_trace)

RNG = np.random.default_rng(41)
JAX_PKG = (JConvWorkload, jisa, jsched, jgraph, jcompiler, jworkloads)
PORT = (ConvWorkload, isa, scheduler, graph, compiler, workloads)


def _segment(pkg):
    """conv -> residual add -> clip compiled as one multi-node segment."""
    _, isa_, _, graph_, compiler_, wls = pkg
    g = graph_.Graph(name="t")
    g.input("image", (1, 16, 8, 8))
    g.layer(wls._conv("a", 1, 8, 16, 16, 3, 1, 1), "image")
    g.layer(wls._conv("b", 1, 8, 16, 16, 3, 1, 1), "a")
    g.residual_add("add", "b", "a", layer=wls._add("add", 1, 8, 16))
    return [s for s in compiler_.compile_graph(g, isa_.DEFAULT_VTA)
            if s.multi][0].program


def _segment_dram():
    return {"a": RNG.integers(-64, 64, (1, 16, 8, 8), dtype=np.int8),
            "b.wgt": RNG.integers(-8, 8, (16, 16, 3, 3), dtype=np.int8),
            "add": np.zeros((1, 16, 8, 8), np.int8)}


def _resident(pkg):
    """Two convs with the c1 -> c2 edge resident (an on-chip spill)."""
    _, isa_, _, graph_, compiler_, wls = pkg
    g = graph_.Graph(name="chain")
    g.input("image", (1, 16, 8, 8))
    g.layer(wls._conv("c1", 1, 8, 16, 16, 3, 1, 1), "image")
    g.layer(wls._conv("c2", 1, 8, 16, 32, 1, 0, 1), "c1")
    seg = compiler_.compile_graph(g, isa_.DEFAULT_VTA)[0]
    assert seg.resident_edges == ("c1->c2",)
    return seg.program


def _depthwise(stride):
    def build(pkg):
        CW, isa_, sched, *_ = pkg
        wl = CW("dw", 1, 14, 14, 3, 3, 32, 32, 1, 1, stride, stride,
                depthwise=True)
        return sched.schedule_depthwise(wl, isa_.PIPELINED_VTA).program
    return build


def _pool(mode):
    wl = {"max": ("pool", 1, 14, 14, 3, 3, 16, 16, 1, 1, 2, 2),
          "avg": ("gap", 1, 7, 7, 7, 7, 64, 64, 0, 0, 7, 7)}[mode]

    def build(pkg):
        CW, isa_, sched, *_ = pkg
        return sched.schedule_pool(CW(*wl), isa_.PIPELINED_VTA,
                                   mode=mode).program
    return build, wl


def _accumulate(pkg):
    """A residual add whose loads of operand ``a`` are dropped: its ADD
    accumulates ``b`` into acc rows that only the scratchpads' zeroing at
    the start of a run clears. The numpy FSim answers ``clip(b)``."""
    CW, isa_, sched, *_ = pkg
    wl = CW("acc", 1, 8, 8, 1, 1, 32, 32, 0, 0, 1, 1)
    prog = sched.schedule_add(wl, isa_.DEFAULT_VTA, tensors={
        "add_a": "a", "add_b": "b", "out": "out"}).program
    order = [i for i in prog.order if not (
        isinstance(i, isa_.LoadInsn) and i.buffer == isa_.Buffer.ACC
        and getattr(i, "meta", {}).get("tensor") == "a")]
    assert len(order) < len(prog.order)
    return type(prog)(hw=prog.hw, order=order, uop_mem=prog.uop_mem,
                      n_ctx=prog.n_ctx)


def _resident_dram():
    return {"image": RNG.integers(-128, 128, (1, 16, 8, 8), np.int8),
            "c1.wgt": RNG.integers(-8, 8, (16, 16, 3, 3), np.int8),
            "c2.wgt": RNG.integers(-8, 8, (32, 16, 1, 1), np.int8),
            "c2": np.zeros((1, 32, 8, 8), np.int8)}


def _both(build):
    return build(JAX_PKG), build(PORT)


def _run_pair(progs, hw_name, dram, *, chunk_cap=24, alu_fusion=True,
              segment_fusion=True):
    """Run the JAX package's program on ``numpy`` and a ``JaxBackend`` and
    the port's on ``numpy`` and ``TorchBackend(device="cpu")`` with the
    same knobs; assert every output equal; return (port's dram, port
    dispatches, jax dispatches)."""
    jprog, tprog = progs
    jhw, thw = getattr(jisa, hw_name), getattr(isa, hw_name)
    d_np = {k: v.copy() for k, v in dram.items()}
    jbackend.get_backend("numpy").run(jprog, jhw, d_np)
    d_jx = {k: v.copy() for k, v in dram.items()}
    fsim_jax.reset_kernel_launch_log()
    fsim_jax.JaxBackend(chunk_cap=chunk_cap, alu_fusion=alu_fusion,
                        segment_fusion=segment_fusion).run(jprog, jhw, d_jx)
    j_launches = fsim_jax.kernel_launch_log()
    d_tn = {k: v.copy() for k, v in dram.items()}
    tbackend.get_backend("numpy").run(tprog, thw, d_tn)
    d_t = {k: v.copy() for k, v in dram.items()}
    fsim_torch.reset_kernel_launch_log()
    TorchBackend(device="cpu", chunk_cap=chunk_cap, alu_fusion=alu_fusion,
                 segment_fusion=segment_fusion).run(tprog, thw, d_t)
    t_launches = fsim_torch.kernel_launch_log()
    for k in dram:
        np.testing.assert_array_equal(d_t[k], d_np[k])
        np.testing.assert_array_equal(d_t[k], d_jx[k])
        np.testing.assert_array_equal(d_tn[k], d_np[k])
    return d_t, t_launches, j_launches


KNOBS = [dict(), dict(alu_fusion=False, segment_fusion=False)]


# ---------------------------------------------------------------------------
# Whole-segment fusion: one dispatch per segment program
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("knobs", KNOBS, ids=["fused", "baseline"])
def test_fused_conv_add_clip_segment_is_one_dispatch(knobs):
    progs = _both(_segment)
    assert getattr(progs[1], "fused_segment", False)
    out, got, want = _run_pair(progs, "DEFAULT_VTA", _segment_dram(),
                               **knobs)
    assert got == want
    if knobs.get("segment_fusion", True):
        assert got == 1
    assert np.any(out["add"])


@pytest.mark.parametrize("knobs", KNOBS, ids=["fused", "baseline"])
def test_resident_spill_chain_is_one_dispatch(knobs):
    progs = _both(_resident)
    assert getattr(progs[1], "fused_segment", False)
    out, got, want = _run_pair(progs, "DEFAULT_VTA",
                               _resident_dram(), **knobs)
    assert got == want
    if knobs.get("segment_fusion", True):
        assert got == 1
    assert np.any(out["c2"])


def test_segment_fusion_falls_back_over_the_op_cap(monkeypatch):
    """Programs longer than SEGMENT_FUSION_MAX_OPS run chunked, as many
    chunks as the reference's, and stay bit-exact."""
    monkeypatch.setattr(fsim_jax, "SEGMENT_FUSION_MAX_OPS", 2)
    monkeypatch.setattr(fsim_torch, "SEGMENT_FUSION_MAX_OPS", 2)
    progs = _both(_segment)                  # fresh programs: empty memos
    _, got, want = _run_pair(progs, "DEFAULT_VTA", _segment_dram(),
                             chunk_cap=4)
    assert got == want and got > 1


def test_segment_fusion_batched_run_is_one_dispatch():
    jprog, tprog = _both(_segment)
    dram = _segment_dram()
    n = 3
    shared = {"b.wgt": dram["b.wgt"]}
    batched = {"a": RNG.integers(-128, 128, (n,) + dram["a"].shape,
                                 dtype=np.int8),
               "add": np.zeros((n,) + dram["add"].shape, np.int8)}
    fsim_torch.reset_kernel_launch_log()
    got = TorchBackend(device="cpu").run_batched(
        tprog, isa.DEFAULT_VTA, shared=shared,
        batched={k: v.copy() for k, v in batched.items()})
    assert fsim_torch.kernel_launch_log() == 1    # one dispatch, the batch
    want = jbackend.get_backend("numpy").run_batched(
        jprog, jisa.DEFAULT_VTA, shared=shared,
        batched={k: v.copy() for k, v in batched.items()})
    np.testing.assert_array_equal(got["add"].numpy(), want["add"])
    fsim_jax.reset_kernel_launch_log()
    jx = fsim_jax.JaxBackend().run_batched(
        jprog, jisa.DEFAULT_VTA, shared=shared,
        batched={k: v.copy() for k, v in batched.items()})
    assert fsim_jax.kernel_launch_log() == 1
    np.testing.assert_array_equal(got["add"].numpy(), jx["add"])


# ---------------------------------------------------------------------------
# ALU-chain fusion: depthwise and pool sweeps, fused and per op
# ---------------------------------------------------------------------------
def test_device_ops_follow_alu_fusion():
    tprog = _depthwise(1)(PORT)
    shapes = {"inp": (1, 32, 14, 14), "dw_wgt": (32, 3, 3),
              "out": (1, 32, 14, 14)}
    trace = lower_cached(tprog, isa.PIPELINED_VTA, shapes)
    dev = torch.device("cpu")
    fused = fsim_torch._device_ops(trace, dev)
    per_op = fsim_torch._device_ops(trace, dev, alu_fusion=False)
    assert {e[0] for e in fused} & {"aluchain", "alusweep"}
    assert not {e[0] for e in per_op} & {"aluchain", "alusweep"}
    jtrace = fsim_jax.lower_cached(_depthwise(1)(JAX_PKG), jisa.PIPELINED_VTA,
                                   shapes)
    for af, ops in ((True, fused), (False, per_op)):
        assert len(ops) == len(fsim_jax._spec_of(jtrace, alu_fusion=af))


@pytest.mark.parametrize("knobs", KNOBS, ids=["fused", "baseline"])
@pytest.mark.parametrize("stride", [1, 2])
def test_depthwise_dispatches_match_jax(stride, knobs):
    progs = _both(_depthwise(stride))
    wl = JConvWorkload("dw", 1, 14, 14, 3, 3, 32, 32, 1, 1, stride, stride,
                       depthwise=True)
    dram = {"inp": RNG.integers(-128, 128, (1, 32, 14, 14), dtype=np.int8),
            "dw_wgt": RNG.integers(-8, 8, (32, 3, 3), dtype=np.int8),
            "out": np.zeros((1, 32, wl.oh, wl.ow), np.int8)}
    out, got, want = _run_pair(progs, "PIPELINED_VTA", dram, **knobs)
    assert got == want and got >= 1
    assert np.any(out["out"])


@pytest.mark.parametrize("knobs", KNOBS, ids=["fused", "baseline"])
@pytest.mark.parametrize("mode", ["max", "avg"])
def test_pool_dispatches_match_jax(mode, knobs):
    build, wl = _pool(mode)
    w = JConvWorkload(*wl)
    dram = {"inp": RNG.integers(-128, 128, (1, w.fi, w.h, w.w),
                                dtype=np.int8),
            "out": np.zeros((1, w.fo, w.oh, w.ow), np.int8)}
    _, got, want = _run_pair(_both(build), "PIPELINED_VTA", dram, **knobs)
    assert got == want and got >= 1


def test_fusion_cuts_dispatches():
    """The fused depthwise program takes fewer dispatches than the per-op
    baseline, in both packages alike (a cap of 4 entries a chunk)."""
    progs = _both(_depthwise(1))
    dram = {"inp": RNG.integers(-128, 128, (1, 32, 14, 14), dtype=np.int8),
            "dw_wgt": RNG.integers(-8, 8, (32, 3, 3), dtype=np.int8),
            "out": np.zeros((1, 32, 14, 14), np.int8)}
    _, fused, j_fused = _run_pair(progs, "PIPELINED_VTA", dram, chunk_cap=4)
    _, base, j_base = _run_pair(progs, "PIPELINED_VTA", dram, chunk_cap=4,
                                **KNOBS[1])
    assert (fused, base) == (j_fused, j_base)
    assert fused < base


# ---------------------------------------------------------------------------
# Static buffers: state never leaks from one dispatch into the next
# ---------------------------------------------------------------------------
def test_back_to_back_dispatches_start_from_zeroed_scratchpads():
    """Two dispatches of one (trace, batch) with other inputs: each gives
    numpy's answer. The accumulate program reads acc rows no instruction
    of it wrote, so a stale acc from the first dispatch would show."""
    jprog, tprog = _both(_accumulate)
    be = TorchBackend(device="cpu")
    for seed in (1, 2, 3):
        rng = np.random.default_rng(seed)
        batched = {"b": rng.integers(-100, 100, (2, 1, 32, 8, 8), np.int8),
                   "out": np.zeros((2, 1, 32, 8, 8), np.int8)}
        got = be.run_batched(tprog, isa.DEFAULT_VTA, shared={},
                             batched=batched)["out"].numpy()
        want = jbackend.get_backend("numpy").run_batched(
            jprog, jisa.DEFAULT_VTA, shared={}, batched=batched)["out"]
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, batched["b"])


def test_skipped_zeroing_is_caught(monkeypatch):
    """The accumulate program tells a dispatch that skips the zeroing."""
    tprog = _accumulate(PORT)
    be = TorchBackend(device="cpu")
    monkeypatch.setattr(TorchBackend, "_run_chunk", lambda self, st, ch, i:
                        fsim_torch._exec(ch[i], st, self.gemm_impl,
                                         self.alu_impl))
    outs = []
    for seed in (1, 2):
        b = np.random.default_rng(seed).integers(-50, 50, (1, 1, 32, 8, 8),
                                                 np.int8)
        outs.append((b, be.run_batched(
            tprog, isa.DEFAULT_VTA, shared={},
            batched={"b": b, "out": np.zeros_like(b)})["out"].numpy()))
    assert not all(np.array_equal(o, b) for b, o in outs)


def test_outputs_are_not_the_static_buffers():
    tprog = _both(_segment)[1]
    dram = _segment_dram()
    be = TorchBackend(device="cpu")
    kw = dict(shared={"b.wgt": dram["b.wgt"]})
    first = be.run_batched(tprog, isa.DEFAULT_VTA, batched={
        "a": dram["a"][None], "add": dram["add"][None]}, **kw)["add"]
    keep = first.clone()
    be.run_batched(tprog, isa.DEFAULT_VTA, batched={
        "a": -dram["a"][None], "add": dram["add"][None]}, **kw)
    assert torch.equal(first, keep)


def test_served_model_back_to_back_matches_numpy():
    m = served_model("resnet18", "tiny")
    imgs = m.random_images(4, seed=9)
    ref = jmodel.served_model("resnet18", "tiny")
    for sl in (slice(0, 2), slice(2, 4)):
        np.testing.assert_array_equal(m.run_batch(imgs[sl], "torch-cpu"),
                                      ref.run_batch(imgs[sl], "numpy"))


def test_load_params_then_dispatch_gives_the_new_answer():
    m = served_model("resnet18", "tiny")
    imgs = m.random_images(2, seed=4)
    before = m.run_batch(imgs, "torch-cpu")
    a = jmodel.served_model("resnet18", "tiny")
    rng = np.random.default_rng(12)
    for k, v in a.weights.items():
        a.weights[k] = rng.integers(-8, 8, v.shape).astype(v.dtype)
    load_params(m, a.weights)
    after = m.run_batch(imgs, "torch-cpu")
    np.testing.assert_array_equal(after, a.run_batch(imgs, "numpy"))
    assert not np.array_equal(after, before)


# ---------------------------------------------------------------------------
# The capture log (mirrors test_serve.py::test_compile_reuse_across_buckets)
# ---------------------------------------------------------------------------
def test_capture_reuse_across_buckets():
    """Requests over two bucket sizes capture each (trace, chunk, bucket)
    once; a second identical wave captures nothing."""
    m = served_model("mobilenet", "tiny")
    eng = VTAServeEngine({"mobilenet": m}, backend="torch-cpu",
                         buckets=(3, 5))
    imgs = m.random_images(8, seed=11)
    fsim_torch.reset_capture_log()
    for i in range(5):
        eng.submit("a", "mobilenet", imgs[i])
    eng.drain()
    for i in range(5, 8):
        eng.submit("a", "mobilenet", imgs[i])
    eng.drain()
    log = fsim_torch.capture_log()
    assert log and all(count == 1 for count in log.values()), log
    assert {sig[3] for sig in log} == {3, 5}
    assert {sig[4] for sig in log} == {None}
    before = sum(log.values())
    tks = [eng.submit("b", "mobilenet", imgs[i]) for i in range(8)]
    eng.drain()
    assert sum(fsim_torch.capture_log().values()) == before
    ref = jmodel.served_model("mobilenet", "tiny").run_single(imgs[0],
                                                              "numpy")
    assert np.array_equal(tks[0].result(), ref)


def test_capture_scope_labels_new_captures():
    m = served_model("resnet18", "tiny")
    fsim_torch.reset_capture_log()
    prev = fsim_torch.set_capture_scope("worker1")
    try:
        assert fsim_torch.capture_scope() == "worker1"
        m.run_batch(m.random_images(6, seed=1), "torch-cpu")
    finally:
        fsim_torch.set_capture_scope(prev)
    log = fsim_torch.capture_log()
    assert log and {sig[4] for sig in log} == {"worker1"}
    assert {sig[3] for sig in log} == {6}
    assert fsim_torch.capture_scope() == prev


def test_host_shared_weights_keep_one_capture():
    """Weights passed as fresh host arrays on every call are copied into
    the key's buffers: one capture per chunk, however many calls."""
    tprog = _segment(PORT)
    dram = _segment_dram()
    be = TorchBackend(device="cpu")
    fsim_torch.reset_capture_log()
    for _ in range(3):
        be.run_batched(tprog, isa.DEFAULT_VTA,
                       shared={"b.wgt": dram["b.wgt"].copy()},
                       batched={"a": dram["a"][None],
                                "add": dram["add"][None]})
    log = fsim_torch.capture_log()
    assert len(log) == 1 and set(log.values()) == {1}


def test_dispatches_per_forward_equal_the_chunk_plan():
    m = served_model("resnet18", "small")
    be = tbackend.get_backend("torch-cpu")
    shapes = dict(m.shapes) | {k: v.shape for k, v in m.weights.items()}
    plan = sum(len(be.chunks(lower_cached(s.program, m.hw, shapes)))
               for s in m.segments)
    fsim_torch.reset_kernel_launch_log()
    m.run_batch(m.random_images(2, seed=3), be)
    assert fsim_torch.kernel_launch_log() == plan == len(m.segments)


# ---------------------------------------------------------------------------
# Stepped execution and divergence localization
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("build,hw_name,kind", [
    (_segment, "DEFAULT_VTA", "segment"),
    (_depthwise(2), "PIPELINED_VTA", "dw")])
def test_stepped_torch_cpu_matches_numpy_every_step(build, hw_name, kind):
    tprog = build(PORT)
    hw = getattr(isa, hw_name)
    if kind == "dw":
        dram = {"inp": RNG.integers(-128, 128, (1, 32, 14, 14), np.int8),
                "dw_wgt": RNG.integers(-8, 8, (32, 3, 3), np.int8),
                "out": np.zeros((1, 32, 7, 7), np.int8)}
    else:
        dram = _segment_dram()
    fsim_torch.reset_kernel_launch_log()
    diff = diff_backends(tprog, hw, dram, backends=("numpy", "torch-cpu"))
    assert diff.divergence is None and diff.outputs_equal
    assert diff.steps == len(tprog.order)
    assert fsim_torch.kernel_launch_log() == 0     # stepped: not counted


def test_trace_digests_match_the_jax_package():
    """The port's recorder digests numpy's stepped state exactly as the
    JAX package's does, step by step."""
    from repro.vta.trace import record_trace as j_record_trace
    jprog, tprog = _both(_segment)
    dram = _segment_dram()
    a = j_record_trace(jprog, jisa.DEFAULT_VTA,
                       {k: v.copy() for k, v in dram.items()})
    b = record_trace(tprog, isa.DEFAULT_VTA,
                     {k: v.copy() for k, v in dram.items()})
    c = record_trace(tprog, isa.DEFAULT_VTA,
                     {k: v.copy() for k, v in dram.items()},
                     backend="torch-cpu")
    assert [s.digests for s in a] == [s.digests for s in b] == \
        [s.digests for s in c]
    assert [s.insn for s in a] == [s.insn for s in c]
    with pytest.raises(KeyError):
        record_trace(tprog, isa.DEFAULT_VTA, dram, backend="jax")


def test_diff_backends_localizes_into_fused_segment_kernel(monkeypatch):
    """A broken GEMM impl inside a fused segment is blamed on the segment
    kernel that covers it."""
    tprog = _segment(PORT)
    dram = _segment_dram()

    def broken(acc, inp, wgt, uidx, inp_idx, wrows, R, w_d, unique=True):
        out = registry.get_kernel("gemm", "torch")(acc, inp, wgt, uidx,
                                                   inp_idx, wrows, R, w_d,
                                                   unique)
        out[:, uidx] += 1
        return out

    registry.register_kernel("gemm", "broken-for-test", broken, replace=True)

    def factory():
        be = TorchBackend(device="cpu")
        be.gemm_impl = "broken-for-test"
        return be

    monkeypatch.setattr(tbackend, "_INSTANCES", {})
    monkeypatch.setitem(tbackend._FACTORIES, "torch-cpu", factory)
    diff = diff_backends(tprog, isa.DEFAULT_VTA, dram,
                         backends=("numpy", "torch-cpu"))
    div = diff.divergence
    assert div is not None and not diff.outputs_equal
    assert div.kernel == ("segment", 0, len(tprog.order) - 1)
    assert div.kernel[1] <= div.step <= div.kernel[2]
    assert div.insn == "GemmInsn"
    assert "fused segment kernel" in div.describe()


def test_divergence_attributes_to_single_alu_chain():
    """An imm corruption inside a fused sweep, run stepped on torch-cpu,
    localizes to exactly one chain kernel."""
    hw = isa.DEFAULT_VTA
    wl = ConvWorkload("dw", 1, 8, 8, 3, 3, 16, 16, 1, 1, 1, 1,
                      depthwise=True)
    prog = scheduler.schedule_depthwise(wl, hw).program
    dram = {"inp": RNG.integers(-128, 128, (1, 16, 8, 8), dtype=np.int8),
            "dw_wgt": RNG.integers(-8, 8, (16, 3, 3), dtype=np.int8),
            "out": np.zeros((1, 16, 8, 8), np.int8)}
    a = record_trace(prog, hw, {k: v.copy() for k, v in dram.items()})
    bad = Program(hw=prog.hw, order=[copy.copy(i) for i in prog.order],
                  uop_mem=prog.uop_mem, n_ctx=prog.n_ctx)
    step = next(i for i, insn in enumerate(bad.order)
                if isinstance(insn, isa.AluInsn)
                and insn.alu_op == isa.AluOp.SHR)
    bad.order[step].imm = 7
    c = record_trace(bad, hw, {k: v.copy() for k, v in dram.items()},
                     backend="torch-cpu")
    div = first_divergence(a, c)
    assert div is not None and div.step == step
    trace = lower_cached(bad, hw, {k: v.shape for k, v in dram.items()})
    div.kernel = enclosing_kernel(trace, div.step)
    assert div.kernel is not None and div.kernel[0] == "aluchain"
    assert div.kernel[1] <= step <= div.kernel[2]
    owners = [ch for ch in trace.alu_chains
              if ch.members[0] <= step <= ch.members[-1]]
    assert len(owners) == 1
    assert "fused aluchain kernel" in div.describe()


def test_run_stepped_writes_outputs_like_run():
    tprog = _depthwise(1)(PORT)
    dram = {"inp": RNG.integers(-128, 128, (1, 32, 14, 14), np.int8),
            "dw_wgt": RNG.integers(-8, 8, (32, 3, 3), np.int8),
            "out": np.zeros((1, 32, 14, 14), np.int8)}
    d_run = {k: v.copy() for k, v in dram.items()}
    d_step = {k: v.copy() for k, v in dram.items()}
    be = TorchBackend(device="cpu")
    be.run(tprog, isa.PIPELINED_VTA, d_run)
    seen = []
    be.run_stepped(tprog, isa.PIPELINED_VTA, d_step,
                   lambda step, insn, st: seen.append(
                       (step, st.acc.shape, st.uop.shape)))
    np.testing.assert_array_equal(d_step["out"], d_run["out"])
    hw = isa.PIPELINED_VTA
    assert [s for s, _, _ in seen] == list(range(len(tprog.order)))
    assert seen[0][1] == (hw.acc_depth, hw.batch, hw.block_out)
    assert seen[0][2] == (hw.uop_depth, 3)


def test_numpy_backend_is_registered_and_serves():
    m = served_model("resnet18", "tiny")
    imgs = m.random_images(2, seed=5)
    be = tbackend.get_backend("numpy")
    assert be.name == "numpy" and tbackend.backend_kernel_impls(be) == ()
    np.testing.assert_array_equal(m.run_batch(imgs, "numpy"),
                                  m.run_batch(imgs, "torch-cpu"))
    assert "numpy" in tbackend.available_backends()
