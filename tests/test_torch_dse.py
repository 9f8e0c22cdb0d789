"""The port's DSE engine, tests/test_dse.py on ``repro_torch`` with the
verification backend ``"numpy"`` and ``"torch-cpu"``: cache behavior,
pareto correctness, parallel smoke sweep. Besides: the port's sweep report
against the JAX package's (tolerance 0, by bytes), the digest phase 9 of
chip_smoke.py pins, a fault of the card that ends the sweep instead of
becoming an infeasible point, and the pool's start method and size."""
import hashlib
import json
import os
import re

import pytest
import torch

from repro_torch.core.dse import (DSEJob, DSEPoint, ResultCache, eval_job,
                                  make_config, make_jobs, pareto,
                                  pareto_front, run_sweep)
from repro_torch.vta.isa import VTAConfig
from repro_torch.vta.network import run_network
from repro_torch.vta.workloads import (NETWORKS, network_fingerprint,
                                       resolve_network)

# tune="off": these tests exercise the sweep engine itself (cache, pareto,
# pool); the autotuner has its own suite (test_autotune.py) and would
# multiply runtime here
GRID = dict(log_blocks=(4,), mem_widths=(8, 64), spad_scales=(1,),
            tune="off")
BACKENDS = ["numpy", "torch-cpu"]
backends = pytest.mark.parametrize("backend", BACKENDS)


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


# ---------------------------------------------------------------------------
# Pareto frontier on a synthetic point set
# ---------------------------------------------------------------------------
def _pt(area, cycles, label):
    return DSEPoint(hw=make_config(), cycles=cycles, area=area, dram_bytes=0,
                    label=label)


def test_pareto_synthetic():
    pts = [_pt(1.0, 100, "ref"),       # frontier (cheapest)
           _pt(2.0, 50, "good"),       # frontier
           _pt(2.5, 60, "dominated"),  # worse on both axes than `good`
           _pt(3.0, 50, "tie"),        # same cycles as `good`, more area
           _pt(4.0, 10, "big"),        # frontier (fastest)
           _pt(4.0, 12, "big-slow")]   # same area as `big`, slower
    front = [p.label for p in pareto(pts)]
    assert front == ["ref", "good", "big"]


def test_pareto_front_generic_keys():
    items = [{"a": 1, "c": 9}, {"a": 2, "c": 5}, {"a": 3, "c": 7}]
    front = pareto_front(items, area=lambda d: d["a"], cycles=lambda d: d["c"])
    assert front == [{"a": 1, "c": 9}, {"a": 2, "c": 5}]


# ---------------------------------------------------------------------------
# Content-addressed job keys
# ---------------------------------------------------------------------------
def test_job_key_stable_and_config_sensitive():
    j = DSEJob(network="resnet18", mem_width=8)
    assert j.key() == DSEJob(network="resnet18", mem_width=8).key()
    assert j.key() != DSEJob(network="resnet18", mem_width=16).key()
    assert j.key() != DSEJob(network="mobilenet1.0", mem_width=8).key()
    assert j.key() != DSEJob(network="resnet18", mem_width=8,
                             per_layer=False).key()
    # aliases canonicalize at construction: same key, same evaluation
    assert DSEJob(network="mobilenet").network == "mobilenet1.0"
    assert DSEJob(network="mobilenet").key() == \
        DSEJob(network="mobilenet1.0").key()


def test_network_aliases_and_fingerprint():
    assert resolve_network("mobilenet") == "mobilenet1.0"
    assert resolve_network("ResNet-18") == "resnet18"
    with pytest.raises(KeyError):
        resolve_network("vgg16")
    assert network_fingerprint("resnet18") != network_fingerprint("resnet34")
    assert network_fingerprint("mobilenet") == \
        network_fingerprint("mobilenet1.0")


# ---------------------------------------------------------------------------
# Result cache
# ---------------------------------------------------------------------------
def test_result_cache_hit_miss_and_corruption(tmp_path):
    from repro_torch.core.dse import CACHE_SCHEMA_VERSION
    cache = ResultCache(str(tmp_path / "c"))
    assert cache.get("k" * 64) is None
    cache.put("k" * 64, {"feasible": True, "cycles": 7})
    assert cache.get("k" * 64) == {"feasible": True, "cycles": 7,
                                   "schema": CACHE_SCHEMA_VERSION}
    assert cache.hits == 1 and cache.misses == 1
    # corrupt records read as misses, not crashes
    with open(cache.path("k" * 64), "w") as f:
        f.write("{not json")
    assert cache.get("k" * 64) is None


@backends
def test_sweep_cache_roundtrip(tmp_path, backend):
    out = str(tmp_path / "dse")
    r1 = run_sweep(["resnet18"], out_dir=out, per_layer=False, workers=1,
                   backend=backend, **GRID)
    assert r1.cache_misses == 2 and r1.cache_hits == 0
    assert len(os.listdir(os.path.join(out, "cache"))) == 2
    r2 = run_sweep(["resnet18"], out_dir=out, per_layer=False, workers=1,
                   backend=backend, **GRID)
    assert r2.cache_hits == 2 and r2.cache_misses == 0
    assert [p.cycles for p in r2.points["resnet18"]] == \
        [p.cycles for p in r1.points["resnet18"]]
    # cached point JSON round-trips through DSEPoint
    rec = json.load(open(os.path.join(
        out, "cache", os.listdir(os.path.join(out, "cache"))[0])))
    pt = DSEPoint.from_dict(rec)
    assert pt.cycles == rec["cycles"] and pt.hw.validate() == []


# ---------------------------------------------------------------------------
# End-to-end smoke sweep: 2 configs x 2 networks, process pool
# ---------------------------------------------------------------------------
@backends
def test_smoke_sweep_two_configs_two_networks(tmp_path, backend):
    out = str(tmp_path / "dse")
    res = run_sweep(["resnet18", "mobilenet"], out_dir=out, per_layer=False,
                    workers=2, backend=backend, **GRID)
    assert set(res.points) == {"resnet18", "mobilenet1.0"}
    for net, pts in res.points.items():
        assert len(pts) == 2, net
        assert all(p.cycles > 0 and p.area > 0 for p in pts)
        # wider bus never slower at equal MAC shape / scratchpads
        by_mw = {p.hw.mem_width_bytes: p.cycles for p in pts}
        assert by_mw[64] <= by_mw[8]
    rep = res.report()
    assert rep["joint"]["n_points"] == 2
    assert len(rep["joint"]["pareto"]) >= 1
    assert os.path.exists(os.path.join(out, "report.json"))


@backends
def test_eval_job_infeasible_config_is_recorded(backend):
    # scratchpads big enough to blow the 128-bit GEMM instruction budget
    job = DSEJob(network="resnet18", log_block=6, spad_scale=4,
                 per_layer=False, backend=backend)
    rec = eval_job(job)
    assert rec["feasible"] is False
    assert "GEMM" in rec["reason"]


# ---------------------------------------------------------------------------
# Per-layer tsim reuse
# ---------------------------------------------------------------------------
def test_layer_cache_preserves_totals():
    hw = VTAConfig(gemm_ii=1, alu_ii=1)
    layers = NETWORKS["resnet18"]()
    cold = run_network("resnet18", layers, hw)
    cache: dict = {}
    warm = run_network("resnet18", layers, hw, layer_cache=cache)
    again = run_network("resnet18", layers, hw, layer_cache=cache)
    assert warm.total_cycles == cold.total_cycles
    assert again.total_cycles == cold.total_cycles
    assert warm.total_dram_bytes == cold.total_dram_bytes
    # repeat blocks mean strictly fewer unique evaluations than layers
    assert 0 < len(cache) < sum(1 for l in layers if not l.on_cpu)


# ---------------------------------------------------------------------------
# Joint pipelined+unpipelined sweeps and the --profile report section
# ---------------------------------------------------------------------------
@backends
def test_joint_pipelined_sweep_labels_and_reference(tmp_path, backend):
    out = str(tmp_path / "dse")
    res = run_sweep(["resnet18"], out_dir=out, per_layer=False, workers=1,
                    pipelined=(True, False), log_blocks=(4,),
                    mem_widths=(8,), spad_scales=(1,), tune="off",
                    backend=backend)
    pts = res.points["resnet18"]
    assert len(pts) == 2
    labels = {p.label for p in pts}
    # unpipelined points carry their own label (joint dedup + Fig-13 axis)
    assert any(l.endswith("/np") for l in labels)
    assert len(labels) == 2
    rep = res.report()
    # the reference stays the *pipelined* default
    assert not rep["per_network"]["resnet18"]["ref"][0].endswith("/np")
    assert rep["joint"]["n_points"] == 2
    # grouping is an engine detail: records match two scalar sweeps
    a = run_sweep(["resnet18"], out_dir=str(tmp_path / "a"), workers=1,
                  per_layer=False, pipelined=True, log_blocks=(4,),
                  mem_widths=(8,), spad_scales=(1,), tune="off",
                  backend=backend)
    b = run_sweep(["resnet18"], out_dir=str(tmp_path / "b"), workers=1,
                  per_layer=False, pipelined=False, log_blocks=(4,),
                  mem_widths=(8,), spad_scales=(1,), tune="off",
                  backend=backend)
    by_pip = {p.hw.gemm_ii == 1: p for p in pts}
    assert by_pip[True].cycles == a.points["resnet18"][0].cycles
    assert by_pip[False].cycles == b.points["resnet18"][0].cycles


def _reset_worker_state():
    """Serial sweeps share this process's layer/schedule caches and tuners;
    profiling tests, and tests that must see a verification run, need a
    cold worker."""
    from repro_torch.core import dse
    dse._LAYER_CACHE.clear()
    dse._SCHEDULE_STORES.clear()
    dse._TUNERS.clear()


@backends
def test_profile_report_section(tmp_path, backend):
    _reset_worker_state()
    kw = dict(per_layer=False, workers=1, log_blocks=(4,), mem_widths=(8,),
              spad_scales=(1,), tune="off", backend=backend)
    res = run_sweep(["resnet18"], out_dir=str(tmp_path / "p"), profile=True,
                    **kw)
    rep = res.report()
    prof = rep["profile"]
    assert set(prof) == {"stages", "schedule_store", "layer_cache"}
    assert prof["stages"].get("schedule", 0) > 0
    assert prof["stages"].get("tsim_cost", 0) > 0
    assert prof["schedule_store"]["misses"] > 0
    assert prof["layer_cache"]["maxsize"] > 0
    # without the flag the report stays byte-compatible with older engines
    res2 = run_sweep(["resnet18"], out_dir=str(tmp_path / "q"), **kw)
    assert "profile" not in res2.report()


@backends
def test_mem_width_variants_share_schedules(tmp_path, backend):
    _reset_worker_state()
    res = run_sweep(["resnet18"], out_dir=str(tmp_path / "s"), profile=True,
                    per_layer=False, workers=1, log_blocks=(4,),
                    mem_widths=(8, 64), spad_scales=(1,), tune="off",
                    backend=backend)
    prof = res.profile
    # the second mem-width variant replays the first one's schedules
    assert prof["schedule_store"]["hits"] >= prof["schedule_store"]["misses"]
    assert [p.cycles for p in res.points["resnet18"]]


# ---------------------------------------------------------------------------
# The port's sweep against the JAX package's
# ---------------------------------------------------------------------------
# sha256 of the JAX package's numpy-backend report.json (without wall_s,
# cache and profile; JSON with sorted keys) on phase 9's grid of
# chip_smoke.py: resnet18 and mobilenet, log blocks 4 and 5, memory widths
# 8 and 32, scratchpad scale 1, --tune full
DSE_DIGEST = \
    "88321c259756792203249701f2542fe63c937255d931b2bb0fbcfae9a3a9a1e2"
PHASE9_GRID = dict(log_blocks=(4, 5), mem_widths=(8, 32), spad_scales=(1,),
                   tune="full")
# the same digest of mobilenet alone on the grid of phase 9's CLI run
# through its spawned pool (chip_smoke.DSE_POOL_GRID): log blocks 4 and 5,
# memory width 8, scratchpad scale 1, --tune full
DSE_POOL_DIGEST = \
    "c13cf63505a2448de8c30e4e2c2cfa706eed5c3e05bb13a19119e67dde1923a4"
POOL_GRID = dict(log_blocks=(4, 5), mem_widths=(8,), spad_scales=(1,),
                 tune="full")


def _report_text(path) -> str:
    """A report.json as compared across backends (the rule of the CI's
    backend-equivalence job): timing, cache and profile fields dropped,
    JSON with sorted keys."""
    with open(path) as f:
        rep = json.load(f)
    for k in ("wall_s", "cache", "profile"):
        rep.pop(k, None)
    return json.dumps(rep, sort_keys=True)


def test_torch_cpu_cli_report_equals_the_jax_packages(tmp_path):
    """``python -m repro_torch.core.dse --backend torch-cpu`` and
    ``python -m repro.core.dse --backend numpy`` on one grid, with every
    winner verified: byte-identical reports."""
    from repro.core import dse as jdse
    from repro_torch.core import dse as tdse
    from repro_torch.vta import fsim_torch
    _reset_worker_state()
    grid = ["--networks", "resnet18", "--log-blocks", "4", "--mem-widths",
            "8", "--spad-scales", "1", "--tune", "full", "--workers", "1"]
    fsim_torch.reset_uncaptured_runs()
    assert tdse.main(grid + ["--backend", "torch-cpu", "--out",
                             str(tmp_path / "port")]) == 0
    assert fsim_torch.uncaptured_runs() > 0
    assert jdse.main(grid + ["--backend", "numpy", "--out",
                             str(tmp_path / "jax")]) == 0
    assert _report_text(tmp_path / "port" / "report.json") == \
        _report_text(tmp_path / "jax" / "report.json")


def test_phase9_grid_digest_of_the_jax_package(tmp_path):
    from repro.core import dse as jdse
    jdse.run_sweep(["resnet18", "mobilenet"], out_dir=str(tmp_path),
                   workers=4, backend="numpy", **PHASE9_GRID)
    text = _report_text(tmp_path / "report.json")
    assert hashlib.sha256(text.encode()).hexdigest() == DSE_DIGEST


def test_chip_smoke_pins_the_same_dse_digest():
    path = os.path.join(os.path.dirname(__file__), os.pardir,
                        "chip_smoke.py")
    with open(path) as f:
        text = f.read()
    m = re.search(r'DSE_DIGEST = \\\s*"([0-9a-f]{64})"', text)
    assert m and m.group(1) == DSE_DIGEST


def test_pool_grid_digest_of_the_jax_package(tmp_path):
    """The JAX package's numpy report of mobilenet on the pool CLI's grid,
    which phase 9 holds the CLI's card report to by its sha256."""
    from repro.core import dse as jdse
    jdse.run_sweep(["mobilenet"], out_dir=str(tmp_path), workers=2,
                   backend="numpy", **POOL_GRID)
    text = _report_text(tmp_path / "report.json")
    assert hashlib.sha256(text.encode()).hexdigest() == DSE_POOL_DIGEST


def test_chip_smoke_pins_the_same_pool_digest():
    path = os.path.join(os.path.dirname(__file__), os.pardir,
                        "chip_smoke.py")
    with open(path) as f:
        text = f.read()
    m = re.search(r'DSE_POOL_DIGEST = \\\s*"([0-9a-f]{64})"', text)
    assert m and m.group(1) == DSE_POOL_DIGEST
    assert "DSE_POOL_GRID = dict(log_blocks=(4, 5), mem_widths=(8,), " \
        "spad_scales=(1,))" in text


# ---------------------------------------------------------------------------
# A fault of the card ends the sweep
# ---------------------------------------------------------------------------
class _CardStub:
    """A backend that says it runs on the card and whose every run raises
    ``RuntimeError``, as a kernel that fails to launch does."""

    name = "card-stub"
    device = torch.device("cuda")

    def run(self, prog, hw, dram):
        raise RuntimeError("CUDA error: stub launch failure")

    def run_batched(self, prog, hw, *, shared, batched):
        raise RuntimeError("CUDA error: stub launch failure")


@pytest.fixture
def card_stub():
    from repro_torch.vta import backend
    backend.register_backend("card-stub", _CardStub)
    try:
        yield "card-stub"
    finally:
        backend._FACTORIES.pop("card-stub", None)
        backend._INSTANCES.pop("card-stub", None)


def test_card_fault_ends_the_sweep_and_is_not_cached(tmp_path, card_stub,
                                                     capsys):
    """The reference records a ``RuntimeError`` of a verification as an
    infeasible point and caches it. A fault on the card is raised as
    ``CardFault`` out of ``eval_job``, ``run_sweep`` and the CLI, which
    exits nonzero with its text, and nothing of it is cached."""
    from repro_torch.core.dse import main
    from repro_torch.vta.backend import CardFault
    _reset_worker_state()
    out = tmp_path / "dse"
    with pytest.raises(CardFault, match="stub launch failure"):
        run_sweep(["resnet18"], out_dir=str(out), log_blocks=(4,),
                  mem_widths=(8,), spad_scales=(1,), tune="full",
                  backend=card_stub)
    assert os.listdir(out / "cache") == []
    assert os.listdir(out / "autotune") == []
    with pytest.raises(CardFault):
        eval_job(DSEJob(network="resnet18", tune="full", backend=card_stub))
    _reset_worker_state()
    rc = main(["--networks", "resnet18", "--log-blocks", "4",
               "--mem-widths", "8", "--spad-scales", "1", "--tune", "full",
               "--backend", card_stub, "--out", str(tmp_path / "cli")])
    assert rc != 0
    assert "stub launch failure" in capsys.readouterr().err
    assert os.listdir(tmp_path / "cli" / "cache") == []


def test_torch_without_a_card_raises_before_any_point(tmp_path):
    """Where there is no CUDA device, ``"torch"`` raises at once; no point
    is evaluated or cached as infeasible."""
    from repro_torch.core.dse import pool_settings
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        pool_settings("torch", None)
    out = tmp_path / "dse"
    with pytest.raises(RuntimeError, match="CUDA"):
        run_sweep(["resnet18"], out_dir=str(out), log_blocks=(4,),
                  mem_widths=(8,), spad_scales=(1,), backend="torch")
    assert os.listdir(out / "cache") == []
    with pytest.raises(RuntimeError, match="CUDA"):
        eval_job(DSEJob(network="resnet18", backend="torch"))


# ---------------------------------------------------------------------------
# The pool
# ---------------------------------------------------------------------------
def test_pool_start_method_and_size_per_backend(card_stub):
    from repro_torch.core.dse import pool_settings
    cpus = max(1, os.cpu_count() or 1)
    for backend in BACKENDS:
        assert pool_settings(backend, None) == (cpus, None)
        assert pool_settings(backend, 3) == (3, None)
    for workers, want in ((None, 1), (2, 2)):
        n, ctx = pool_settings(card_stub, workers)
        assert n == want and ctx.get_start_method() == "spawn"


def test_spawned_pool_sweep_equals_serial(tmp_path, monkeypatch):
    """The pool the card uses (spawned workers, which start from a fresh
    import) on the CPU: the same points as the serial sweep."""
    import multiprocessing
    from repro_torch.core import dse
    monkeypatch.setattr(dse, "pool_settings", lambda backend, workers: (
        workers, multiprocessing.get_context("spawn")))
    kw = dict(per_layer=False, log_blocks=(4, 5), mem_widths=(8,),
              spad_scales=(1,), tune="off", backend="torch-cpu")
    pooled = run_sweep(["mobilenet"], out_dir=str(tmp_path / "p"),
                       workers=2, **kw)
    serial = run_sweep(["mobilenet"], out_dir=str(tmp_path / "s"),
                       workers=1, **kw)
    assert _report_text(tmp_path / "p" / "report.json") == \
        _report_text(tmp_path / "s" / "report.json")
    assert len(pooled.points["mobilenet1.0"]) == 2
