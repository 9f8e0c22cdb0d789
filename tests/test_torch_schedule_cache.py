"""The port's staged schedule sharing, tests/test_schedule_cache.py on
``repro_torch``: config projections, the vectorized cost model's
bit-identity to scalar ``run_tsim``, the LRU-bounded ScheduleStore and its
on-disk blob backing, and stage wall-time accounting; and the port's
``run_tsim`` against the JAX package's on the same Programs, tolerance 0."""
import pickle
from dataclasses import fields, replace

import pytest

from repro_torch.core import stages
from repro_torch.core.dse import LRUCache, ScheduleBlobCache
from repro_torch.vta.isa import VTAConfig, encode_insn
from repro_torch.vta.network import schedule_layer
from repro_torch.vta.schedule_cache import (KnownScheduleFailure,
                                            ScheduleStore, add_key, alu_key,
                                            conv_key)
from repro_torch.vta.tsim import (CostParams, HazardError, TsimCostModel,
                                  run_tsim)
from repro_torch.vta.workloads import NETWORKS, pad_for_blocking

COST_VARIANTS = [replace(VTAConfig(), mem_width_bytes=mw,
                         gemm_ii=1 if pip else 4, alu_ii=1 if pip else 4)
                 for mw in (8, 16, 32, 64) for pip in (True, False)]


# ---------------------------------------------------------------------------
# The projection partition: schedule_key + cost_key must cover VTAConfig
# ---------------------------------------------------------------------------
def test_schedule_and_cost_fields_partition_config():
    all_fields = {f.name for f in fields(VTAConfig)}
    sched = set(VTAConfig.SCHEDULE_FIELDS)
    cost = set(VTAConfig.COST_FIELDS)
    assert sched & cost == set()
    # any new config field must be assigned to one projection — otherwise
    # two configs could share a schedule entry while scheduling (or
    # costing) differently
    assert sched | cost == all_fields


def test_schedule_key_invariant_under_cost_fields():
    base = VTAConfig()
    for hw in COST_VARIANTS:
        assert hw.schedule_key() == base.schedule_key()
    assert replace(base, log_block_in=5).schedule_key() != base.schedule_key()
    assert replace(base, mem_width_bytes=64).cost_key() != base.cost_key()


# ---------------------------------------------------------------------------
# Cost-model replay is bit-identical to scalar run_tsim — every program of
# resnet18 / resnet50 / mobilenet, every cost variant. Programs that raise
# HazardError under some variant must raise identically from both models.
# ---------------------------------------------------------------------------
def _unique_programs():
    """One scheduled program per unique layer shape across the three nets
    (built once under the default geometry — cost variants share it)."""
    hw = VTAConfig()
    seen = set()
    progs = []
    for net in ("resnet18", "resnet50", "mobilenet1.0"):
        for layer in NETWORKS[net]():
            if layer.on_cpu:
                continue
            ident = (layer.kind, replace(layer.wl, name=""), layer.post_op,
                     layer.bias)
            if ident in seen:
                continue
            seen.add(ident)
            sched = schedule_layer(layer, hw, dedup_loads=True)
            progs.append(sched.program)
    return progs


def test_cost_model_bit_identical_to_scalar_tsim():
    hw0 = VTAConfig()
    progs = _unique_programs()
    assert len(progs) > 30
    checked = hazards = 0
    for prog in progs:
        model = TsimCostModel(prog, hw0)
        for hw in COST_VARIANTS:
            try:
                ref = run_tsim(prog, hw)
                ref_err = None
            except HazardError as e:
                ref_err = str(e)
            try:
                got = model.cost(hw)
                got_err = None
            except HazardError as e:
                got_err = str(e)
            # the hazard checker is timing-sensitive: a schedule clean
            # under its build config may overlap under another cost
            # variant — both models must agree on raise AND message
            assert ref_err == got_err, prog
            if ref_err is not None:
                hazards += 1
                continue
            assert got.total_cycles == ref.total_cycles
            assert got.dram_bytes == ref.dram_bytes
            assert got.stalls == ref.stalls
            assert got.mem_wait == ref.mem_wait
            assert got.busy == ref.busy
            assert got.counts == ref.counts
            checked += 1
    assert checked > 100


def test_cost_params_projection():
    hw = replace(VTAConfig(), mem_width_bytes=32, gemm_ii=1, alu_ii=1,
                 log_block_in=6, log_block_out=6)
    p = CostParams.of(hw)
    assert (p.mem_width_bytes, p.gemm_ii, p.alu_ii) == (32, 1, 1)
    # geometry twins cost identically: CostParams.of ignores schedule fields
    assert CostParams.of(replace(hw, log_block_in=4, log_block_out=4)) == p


# ---------------------------------------------------------------------------
# ScheduleStore: sharing, failure caching, LRU bound, disk backing
# ---------------------------------------------------------------------------
def _add_layer():
    for layer in NETWORKS["resnet18"]():
        if layer.kind == "add":
            return layer
    raise AssertionError("resnet18 has no add layer")


def _entry_for(store, hw, wl_scale=1):
    layer = _add_layer()
    wl = pad_for_blocking(replace(layer.wl, fi=layer.wl.fi * wl_scale,
                                  fo=layer.wl.fo * wl_scale), hw)
    key = add_key(replace(wl, name=""), hw.schedule_key(), False)
    build = lambda: schedule_layer(replace(layer, wl=wl), hw)
    return key, store.entry(key, build, hw)


def test_store_shares_entries_across_cost_variants():
    store = ScheduleStore()
    hw = VTAConfig()
    key, ent = _entry_for(store, hw)
    hw2 = replace(hw, mem_width_bytes=64, gemm_ii=1, alu_ii=1)
    key2, ent2 = _entry_for(store, hw2)
    assert key2 == key and ent2 is ent
    assert store.stats()["hits"] == 1 and store.stats()["misses"] == 1
    # the shared model replays both variants bit-identically
    assert ent.cost_model.cost(hw).total_cycles == \
        run_tsim(ent.program, hw).total_cycles
    assert ent.cost_model.cost(hw2).total_cycles == \
        run_tsim(ent.program, hw2).total_cycles


def test_store_caches_failures_by_type_only():
    store = ScheduleStore()
    hw = VTAConfig()

    def failing():
        raise AssertionError(f"capacity exceeded under {hw!r}")

    with pytest.raises(AssertionError):
        store.entry(("k",), failing, hw)
    # the hit raises the marker type, carrying only the exception class:
    # per-variant messages (which may embed a config repr) are regenerated
    # by consumers re-running the builder
    with pytest.raises(KnownScheduleFailure) as ei:
        store.entry(("k",), failing, hw)
    assert ei.value.exc_type == "AssertionError"


def test_store_lru_bound():
    store = ScheduleStore(maxsize=1)
    hw = VTAConfig()
    k1, e1 = _entry_for(store, hw, wl_scale=1)
    k2, e2 = _entry_for(store, hw, wl_scale=2)
    assert len(store) == 1 and store.evictions == 1
    # k1 was evicted: same key misses and rebuilds
    _, e1b = _entry_for(store, hw, wl_scale=1)
    assert e1b is not e1
    assert store.stats()["misses"] == 3 and store.stats()["hits"] == 0


def test_blob_cache_roundtrip_and_poisoning(tmp_path):
    blob = ScheduleBlobCache(str(tmp_path / "sched"))
    store = ScheduleStore()
    hw = VTAConfig()
    key, ent = _entry_for(store, hw)
    blob.put(key, ent)
    got = blob.get(key)
    assert got is not None
    assert got.cost_model.cost(hw).total_cycles == \
        ent.cost_model.cost(hw).total_cycles
    # a stale/colliding file whose stored key differs is a miss, not a hit
    other = ("other-key",)
    with open(blob.path(other), "wb") as f:
        pickle.dump((key, ent), f)
    assert blob.get(other) is None
    # corrupt blobs are misses, not crashes
    with open(blob.path(key), "wb") as f:
        f.write(b"\x80not a pickle")
    assert blob.get(key) is None


def test_store_disk_backing_survives_process_restart(tmp_path):
    blob = ScheduleBlobCache(str(tmp_path / "sched"))
    store = ScheduleStore(backing=blob)
    hw = VTAConfig()
    layer = _add_layer()
    wl = pad_for_blocking(layer.wl, hw)
    key = add_key(replace(wl, name=""), hw.schedule_key(), False)
    build = lambda: schedule_layer(replace(layer, wl=wl), hw)
    ent = store.entry(key, build, hw, persist=True)
    # a fresh store (new process) hits the disk blob instead of rebuilding
    fresh = ScheduleStore(backing=ScheduleBlobCache(str(tmp_path / "sched")))
    ent2 = fresh.entry(key, lambda: pytest.fail("rebuilt despite blob"),
                       hw)
    assert fresh.disk_hits == 1
    assert ent2.cost_model.cost(hw).total_cycles == \
        ent.cost_model.cost(hw).total_cycles


# ---------------------------------------------------------------------------
# Schedule-store keys distinguish what must never collide
# ---------------------------------------------------------------------------
def test_keys_distinguish_geometry_and_validate_flag():
    hw = VTAConfig()
    sk = hw.schedule_key()
    sk6 = replace(hw, log_block_in=6, log_block_out=6).schedule_key()
    layer = _add_layer()
    wl = replace(pad_for_blocking(layer.wl, hw), name="")
    assert add_key(wl, sk, True) != add_key(wl, sk, False)
    assert add_key(wl, sk, True) != add_key(wl, sk6, True)
    assert alu_key("depthwise", wl, "relu_shift", sk, None, True) != \
        alu_key("maxpool", wl, "relu_shift", sk, None, True)
    from repro_torch.core.tps import Tiling
    t = Tiling(1, 2, 3, 4, 5, 6, 7)
    t2 = Tiling(1, 2, 3, 4, 5, 6, 8)
    assert conv_key(wl, "clip_shift", False, True, sk, t, True) != \
        conv_key(wl, "clip_shift", False, True, sk, t2, True)


# ---------------------------------------------------------------------------
# LRU layer cache (core/dse)
# ---------------------------------------------------------------------------
def test_lru_cache_bound_and_recency():
    c = LRUCache(maxsize=2)
    c["a"] = 1
    c["b"] = 2
    assert c.get("a") == 1          # refresh "a": "b" is now oldest
    c["c"] = 3
    assert len(c) == 2 and c.evictions == 1
    assert c.get("b") is None and c.get("a") == 1 and c.get("c") == 3
    assert c.stats() == {"len": 2, "maxsize": 2, "evictions": 1}


# ---------------------------------------------------------------------------
# Stage wall-time accounting
# ---------------------------------------------------------------------------
def test_stage_timers_exclusive_nesting():
    before = stages.snapshot()
    with stages.stage("autotune"):
        with stages.stage("schedule"):
            pass
        with stages.stage("tsim_cost"):
            pass
    d = stages.delta(before)
    # children's elapsed time is carved out of the parent: the three
    # buckets sum to the outer elapsed, nothing is double-counted
    assert set(d) <= {"autotune", "schedule", "tsim_cost"}
    assert all(v >= 0 for v in d.values())
    merged = stages.merge(dict(before), d)
    for k, v in d.items():
        assert merged[k] == pytest.approx(before.get(k, 0.0) + v)


# ---------------------------------------------------------------------------
# The port's tsim against the JAX package's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("net", ["resnet18", "mobilenet1.0"])
def test_tsim_cycles_match_the_original(net):
    """Every unique layer program of ``net``, scheduled by each package under
    the default geometry: the two programs encode the same instructions,
    and each package's ``run_tsim`` and cost model give the same cycles,
    DRAM bytes, stalls and counts under every cost variant."""
    from repro.vta import isa as jisa
    from repro.vta import network as jnetwork
    from repro.vta import tsim as jtsim
    from repro.vta import workloads as jworkloads
    seen = set()
    checked = 0
    jlayers = jworkloads.NETWORKS[net]()
    for layer, jlayer in zip(NETWORKS[net](), jlayers):
        ident = (layer.kind, replace(layer.wl, name=""), layer.post_op,
                 layer.bias)
        if layer.on_cpu or ident in seen:
            continue
        seen.add(ident)
        prog = schedule_layer(layer, VTAConfig(), dedup_loads=True).program
        jprog = jnetwork.schedule_layer(jlayer, jisa.VTAConfig(),
                                        dedup_loads=True).program
        assert [encode_insn(i, prog.hw) for i in prog.order] == \
            [jisa.encode_insn(i, jprog.hw) for i in jprog.order]
        model = TsimCostModel(prog, VTAConfig())
        jmodel = jtsim.TsimCostModel(jprog, jisa.VTAConfig())
        for hw in COST_VARIANTS:
            jhw = jisa.VTAConfig(**{f.name: getattr(hw, f.name)
                                    for f in fields(hw)})
            try:
                want = jtsim.run_tsim(jprog, jhw)
            except jtsim.HazardError as e:
                with pytest.raises(HazardError) as ei:
                    run_tsim(prog, hw)
                assert str(ei.value) == str(e)
                continue
            for got in (run_tsim(prog, hw), model.cost(hw)):
                assert got.total_cycles == want.total_cycles
                assert got.dram_bytes == want.dram_bytes
                assert got.stalls == want.stalls
                assert got.counts == want.counts
            assert jmodel.cost(jhw).total_cycles == want.total_cycles
            checked += 1
    assert checked > 40
