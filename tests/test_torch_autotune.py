"""The port's autotuner, tests/test_autotune.py on ``repro_torch``:
determinism (cold vs warm), capacity pruning, never-worse invariants on
resnet18 + mobilenet, cache-schema rejection, DSE wiring; its tune records
against the JAX package's, tolerance 0; and a fault of the card in a fused
head's verification raised as ``CardFault``.

The port's ``LayerTuner`` verifies on the card (``"torch"``) by default;
these tests name ``"torch-cpu"`` or ``"numpy"``."""
import json
import os

import numpy as np
import pytest
import torch

from repro_torch.core.dse import (CACHE_SCHEMA_VERSION, DSEJob, ResultCache,
                            make_config)
from repro_torch.core.tile_search import (vta_alu_tile_candidates,
                                          vta_tile_candidates)
from repro_torch.core.tps import (ConvWorkload, _costs, _divisors,
                            heuristic_conv_tiling)
from repro_torch.vta.autotune import LayerTuner, TuneResult, make_tuner
from repro_torch.vta.network import run_network
from repro_torch.vta.scheduler import schedule_depthwise
from repro_torch.vta.workloads import network_graph, pad_for_blocking

HW = make_config()          # pipelined 1x16x16, mw8 — the reference config

# a layer with a known tuning win at HW (mobilenet pw11-shaped)
WL = ConvWorkload("pw", 1, 14, 14, 1, 1, 512, 512, 0, 0, 2, 2)
DW = ConvWorkload("dw", 1, 56, 56, 3, 3, 128, 128, 1, 1, 1, 1,
                  depthwise=True)


BACKEND = "torch-cpu"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The ``torch-cpu`` verifications run thousands of tiny PyTorch ops;
    where the suite's workers share the cores, several intra-op threads
    per worker make each op wait on the others' threads. One thread each
    runs them at their single-process speed."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _quick_tuner(**kw):
    kw.setdefault("k_traffic", 4)
    kw.setdefault("k_cycles", 2)
    kw.setdefault("backend", BACKEND)
    return LayerTuner(mode=kw.pop("mode", "full"), **kw)


# ---------------------------------------------------------------------------
# Candidate generation + capacity pruning
# ---------------------------------------------------------------------------
def test_candidates_capacity_pruned_analytically():
    """vta_tile_candidates never returns a tiling violating the analytic
    scratchpad capacities, even though the raw divisor grid contains many."""
    import dataclasses
    tiny = dataclasses.replace(HW, log_inp_buff=11, log_wgt_buff=12,
                               log_acc_buff=12)
    wl = pad_for_blocking(ConvWorkload("c", 1, 28, 28, 3, 3, 64, 128,
                                       1, 1, 1, 1), tiny)
    cands = vta_tile_candidates(wl, tiny)
    assert cands, "some tiling must fit even tiny scratchpads"
    for t in cands:
        _, _, _, s_inp, s_wgt, s_acc = _costs(
            wl, tiny, np.float64(t.tb_o), np.float64(t.th_o),
            np.float64(t.tw_o), np.float64(t.tco_o), np.float64(t.tci_o),
            t.oc_n, t.h_n)
        assert s_inp <= tiny.inp_elems and s_wgt <= tiny.wgt_elems \
            and s_acc <= tiny.acc_elems
    # the unconstrained grid does contain violators (the fallback tiling
    # keeps scratchpad use minimal; the opposite corner blows capacity)
    _, _, _, s_inp, s_wgt, s_acc = _costs(
        wl, tiny, np.float64(1), np.float64(1), np.float64(1),
        np.float64(1), np.float64(1), 1, 1)
    assert max(s_inp / tiny.inp_elems, s_wgt / tiny.wgt_elems,
               s_acc / tiny.acc_elems) > 1


def test_alu_candidates_pruned_by_scheduler_asserts():
    """The full-frame depthwise tile blows the acc budget at the default
    config: the emitter must refuse it (assert) and the tuner must count it
    as pruned while still committing a legal winner."""
    wl = pad_for_blocking(DW, HW)
    with pytest.raises(AssertionError):
        schedule_depthwise(wl, HW, tile=(wl.oh, wl.ow))
    assert (wl.oh, wl.ow) in vta_alu_tile_candidates(wl.oh, wl.ow)
    tr = _quick_tuner(verify=False).tune_alu_layer("depthwise", wl, HW,
                                                   post_op="relu_shift")
    assert tr.pruned > 0
    assert tr.tuning_gain >= 0
    # the committed tile schedules cleanly
    schedule_depthwise(wl, HW, tile=tuple(tr.tile))


# ---------------------------------------------------------------------------
# Determinism: same cache key -> same tile, cold vs warm
# ---------------------------------------------------------------------------
def test_determinism_cold_warm_and_full(tmp_path):
    wl = pad_for_blocking(WL, HW)
    cache = ResultCache(str(tmp_path / "tiles"))
    cold = LayerTuner(mode="cached", cache=cache, backend=BACKEND)
    a = cold.tune_conv(wl, HW, dedup_loads=True)
    assert not a.cached and a.verified
    assert a.tuning_gain > 0          # this shape has a known win

    # warm: a fresh tuner over the same directory serves the identical tile
    warm = LayerTuner(mode="cached",
                      cache=ResultCache(str(tmp_path / "tiles")),
                      backend=BACKEND)
    b = warm.tune_conv(wl, HW, dedup_loads=True)
    assert b.cached and warm.searches == 0
    assert b.tile == a.tile and b.cycles == a.cycles

    # full: ignores the cached tile, re-searches, converges on the same tile
    full = LayerTuner(mode="full", cache=ResultCache(str(tmp_path / "tiles")),
                      backend=BACKEND)
    c = full.tune_conv(wl, HW, dedup_loads=True)
    assert not c.cached and full.searches == 1
    assert c.tile == a.tile and c.cycles == a.cycles


def test_cache_schema_rejected(tmp_path):
    """A record with a foreign schema version is a miss, not a stale hit."""
    wl = pad_for_blocking(WL, HW)
    cache = ResultCache(str(tmp_path / "tiles"))
    t1 = LayerTuner(mode="cached", cache=cache, backend=BACKEND)
    a = t1.tune_conv(wl, HW, dedup_loads=True)
    key = t1.fingerprint("conv", wl, HW, post_op="clip_shift", bias=False,
                         prefer_db=True, dedup_loads=True)
    rec = json.load(open(cache.path(key)))
    assert rec["schema"] == CACHE_SCHEMA_VERSION
    rec["schema"] = CACHE_SCHEMA_VERSION + 1
    rec["tile"] = {"tb_o": 1, "th_o": 1, "tw_o": 1, "tco_o": 1, "tci_o": 1,
                   "oc_n": 1, "h_n": 1}        # poison: must not be served
    with open(cache.path(key), "w") as f:
        json.dump(rec, f)
    t2 = LayerTuner(mode="cached", cache=ResultCache(str(tmp_path / "tiles")),
                    backend=BACKEND)
    b = t2.tune_conv(wl, HW, dedup_loads=True)
    assert not b.cached and b.tile == a.tile


def test_search_knobs_change_fingerprint():
    wl = pad_for_blocking(WL, HW)
    t1 = LayerTuner(mode="full")
    t2 = LayerTuner(mode="full", k_traffic=4)
    kw = dict(post_op="clip_shift", bias=False, prefer_db=True,
              dedup_loads=True)
    assert t1.fingerprint("conv", wl, HW, **kw) != \
        t2.fingerprint("conv", wl, HW, **kw)
    assert t1.fingerprint("conv", wl, HW, **kw) == \
        LayerTuner(mode="cached").fingerprint("conv", wl, HW, **kw)


def test_tune_mode_in_job_key():
    on = DSEJob(network="resnet18", tune="cached")
    assert on.key() != DSEJob(network="resnet18", tune="off").key()
    # cached and full run the same deterministic search: interchangeable
    assert on.key() == DSEJob(network="resnet18", tune="full").key()
    with pytest.raises(AssertionError):
        DSEJob(network="resnet18", tune="bogus")


# ---------------------------------------------------------------------------
# Never worse than the heuristic, per layer and end to end
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("net", ["resnet18", "mobilenet"])
def test_never_worse_than_heuristic(net):
    tuner = _quick_tuner(verify=True)
    base = run_network(net, network_graph(net), HW, dedup_loads=True,
                       layer_cache={})
    tuned = run_network(net, network_graph(net), HW, dedup_loads=True,
                        layer_cache={}, tuner=tuner, backend=BACKEND)
    assert tuned.total_cycles <= base.total_cycles
    assert tuned.tuned_layers > 0
    assert tuned.tuning_cycles_saved >= 0
    # per-layer: the heuristic tiling is always a candidate, so every
    # committed plan reports a non-negative gain
    for lr in tuned.layers:
        assert lr.tuning_gain >= 0, lr.name


def test_tuned_layer_reports_surface_tiles():
    tuner = _quick_tuner(verify=False)
    rep = run_network("mobilenet", network_graph("mobilenet"), HW,
                      dedup_loads=True, layer_cache={}, tuner=tuner,
                      backend=None)
    tuned = [l for l in rep.layers if l.chosen_tile is not None]
    assert tuned, "mobilenet layers must carry committed tiles"
    for lr in tuned:
        d = lr.to_dict()
        assert d["chosen_tile"] == lr.chosen_tile
        assert set(lr.chosen_tile) in ({"tb_o", "th_o", "tw_o", "tco_o",
                                        "tci_o", "oc_n", "h_n"},
                                       {"th", "tw"})
    s = rep.summary()
    assert s["tuned_layers"] == len(tuned)
    assert s["tuning_cycles_saved"] == sum(l.tuning_gain for l in tuned)


# ---------------------------------------------------------------------------
# Fused-head tuning through the graph compiler
# ---------------------------------------------------------------------------
def test_fused_head_tuning_never_slower():
    """Fused conv→add heads are scored on the actual fused program; the
    compiler heuristic stays in the candidate set, so tuned segments never
    lose to the untuned compile."""
    from repro_torch.vta.compiler import compile_graph
    from repro_torch.vta.tsim import run_tsim
    g = network_graph("resnet18")
    plain = compile_graph(g, HW, dedup_loads=True)
    tuned = compile_graph(g, HW, dedup_loads=True, tuner=_quick_tuner())
    plain_fused = {tuple(s.names): s for s in plain if s.fused_adds}
    saw_tuned = 0
    for seg in tuned:
        if not seg.fused_adds:
            continue
        if seg.head_tune is not None:
            saw_tuned += 1
            assert seg.head_tune["tuning_gain"] >= 0
        ref = plain_fused.get(tuple(seg.names))
        if ref is not None:
            assert run_tsim(seg.program, HW).total_cycles <= \
                run_tsim(ref.program, HW).total_cycles
    assert saw_tuned > 0


# ---------------------------------------------------------------------------
# make_tuner factory / off mode
# ---------------------------------------------------------------------------
def test_make_tuner_off_and_dirs(tmp_path):
    assert make_tuner("off") is None
    assert make_tuner(None) is None
    t = make_tuner("cached", str(tmp_path / "tiles"))
    assert t is not None and t.cache is not None
    assert os.path.isdir(str(tmp_path / "tiles"))
    rec = TuneResult(kind="conv", tile=(2, 3), cycles=10,
                     heuristic_cycles=12)
    rt = TuneResult.from_record(json.loads(json.dumps(rec.to_record())))
    assert rt.tile == (2, 3) and rt.tuning_gain == 2 and rt.cached


# ---------------------------------------------------------------------------
# The port against the JAX package
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("net", ["resnet18", "mobilenet"])
def test_tune_records_match_the_original(net):
    """Every tile each package's tuner commits on ``net`` (conv, depthwise,
    pool and fused conv+add heads), the port verifying on ``"torch-cpu"``
    and the JAX package on its numpy FSim: the same fingerprints and the
    same records."""
    from repro.vta import autotune as jautotune
    from repro.vta import network as jnetwork
    from repro.vta import workloads as jworkloads
    from repro.core import dse as jdse
    tuner = _quick_tuner(verify=True)
    jtuner = jautotune.LayerTuner(mode="full", k_traffic=4, k_cycles=2,
                                  backend="numpy")
    run_network(net, network_graph(net), HW, dedup_loads=True,
                layer_cache={}, tuner=tuner, backend=BACKEND)
    jnetwork.run_network(net, jworkloads.network_graph(net),
                         jdse.make_config(), dedup_loads=True,
                         layer_cache={}, tuner=jtuner)
    got = {k: tr.to_record() for k, tr in tuner._memo.items()}
    want = {k: tr.to_record() for k, tr in jtuner._memo.items()}
    assert got == want
    assert {r["kind"] for r in got.values()} >= (
        {"conv", "conv+add"} if net == "resnet18"
        else {"conv", "depthwise", "avgpool"})
    assert tuner.verifications > 0


class _StubBackend:
    """A backend on ``device`` whose every run raises ``RuntimeError``, as a
    kernel that fails to launch does."""

    def __init__(self, device: str):
        self.name = f"stub-{device}"
        self.device = torch.device(device)
        self.calls = 0

    def run(self, prog, hw, dram):
        raise RuntimeError("CUDA error: stub")

    def run_batched(self, prog, hw, *, shared, batched):
        self.calls += 1
        raise RuntimeError("CUDA error: stub")


def test_card_fault_in_fused_head_verification_propagates():
    """The reference's ``tune_fused_conv`` turns a ``RuntimeError`` in its
    verification into "head not tuned". On the card the error is a
    ``CardFault``, which no handler of the tuner or the compiler catches;
    off the card the reference's behaviour stays."""
    from repro_torch.vta.backend import CardFault
    from repro_torch.vta.compiler import compile_graph
    assert not issubclass(CardFault, (RuntimeError, AssertionError,
                                      ValueError))
    g = network_graph("resnet18")
    card = _StubBackend("cuda")
    with pytest.raises(CardFault, match="CUDA error: stub"):
        compile_graph(g, HW, dedup_loads=True,
                      tuner=_quick_tuner(backend=card))
    assert card.calls == 1
    cpu = _StubBackend("cpu")
    segs = compile_graph(g, HW, dedup_loads=True,
                         tuner=_quick_tuner(backend=cpu))
    fused = [s for s in segs if s.fused_adds]
    assert fused and all(s.head_tune is None for s in fused)
    assert cpu.calls == len(fused)


# ---------------------------------------------------------------------------
# The uncaptured route the verification runs on
# ---------------------------------------------------------------------------
DEVICE_MEMOS = ("_torch_ops", "_torch_chunks", "_torch_plans", "_torch_key")


def _route_programs():
    """(program, hw, shared, batched) of a conv, a depthwise layer and a
    fused conv -> add -> clip segment, two images each."""
    from repro_torch.vta.isa import DEFAULT_VTA
    from repro_torch.vta.scheduler import schedule_conv
    from test_torch_fusion import PORT, _segment, _segment_dram
    rng = np.random.default_rng(3)
    i8 = lambda shape: rng.integers(-64, 64, shape, dtype=np.int8)
    wl = pad_for_blocking(ConvWorkload("c", 1, 14, 14, 3, 3, 32, 32,
                                       1, 1, 1, 1), HW)
    conv = schedule_conv(wl, heuristic_conv_tiling(wl, HW), HW,
                         post_op="clip_shift").program
    dw = pad_for_blocking(DW, HW)
    dwp = schedule_depthwise(dw, HW, post_op="relu_shift").program
    seg = _segment_dram()
    return [
        (conv, HW, {"wgt": i8((wl.fo, wl.fi, wl.kh, wl.kw))},
         {"inp": i8((2, wl.b, wl.fi, wl.h, wl.w)),
          "out": np.zeros((2, wl.b, wl.fo, wl.oh, wl.ow), np.int8)}),
        (dwp, HW, {"dw_wgt": i8((dw.fi, dw.kh, dw.kw))},
         {"inp": i8((2, dw.b, dw.fi, dw.h, dw.w)),
          "out": np.zeros((2, dw.b, dw.fo, dw.oh, dw.ow), np.int8)}),
        (_segment(PORT), DEFAULT_VTA, {"b.wgt": seg["b.wgt"]},
         {"a": i8((2,) + seg["a"].shape),
          "add": np.zeros((2,) + seg["add"].shape, np.int8)}),
    ]


def test_uncaptured_route_equals_captured_and_keeps_no_device_memo():
    from repro_torch.vta import fsim_torch
    from repro_torch.vta.backend import get_backend, lowered
    from repro_torch.vta.fsim_torch import TorchBackend
    be = TorchBackend(device="cpu")
    once = be.uncaptured()
    assert once.capture is False and be.capture is True
    assert once.uncaptured() is once
    for prog, hw, shared, batched in _route_programs():
        shapes = {k: v.shape for k, v in shared.items()}
        shapes.update({k: v.shape[1:] for k, v in batched.items()})
        before = {k: v.copy() for k, v in batched.items()}
        fsim_torch.reset_uncaptured_runs()
        fsim_torch.reset_kernel_launch_log()
        got = once.run_batched(prog, hw, shared=shared, batched=batched)
        trace = lowered(prog, hw, shapes)
        assert fsim_torch.uncaptured_runs() == 1
        assert not set(DEVICE_MEMOS) & set(trace.__dict__)
        assert fsim_torch.kernel_launch_log() == len(be.chunks(trace))
        assert all(np.array_equal(before[k], batched[k]) for k in batched)
        want = be.run_batched(prog, hw, shared=shared, batched=batched)
        assert "_torch_plans" in trace.__dict__
        ref = get_backend("numpy").run_batched(prog, hw, shared=shared,
                                               batched=batched)
        assert set(got) == set(want) == set(ref)
        for k in got:
            assert got[k].dtype == want[k].dtype
            assert got[k].numpy().tobytes() == want[k].numpy().tobytes()
            assert got[k].numpy().tobytes() == ref[k].numpy().tobytes()
