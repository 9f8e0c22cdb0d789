"""Parallel, cached, multi-network design-space exploration (paper §IV.F).

The paper's headline artifact is the area–performance Pareto curve (Fig 13)
over VTA configurations spanning GEMM shape (4x4/5x5/6x6 log2 "MAC shape"),
memory-interface width (8..64 B/cycle) and scratchpad sizing. This module
turns the original serial single-network sweep into a job-based engine:

  * ``DSEJob`` = one (hardware config, network) pair; the full sweep is the
    cross product of the config grid and the requested networks;
  * jobs execute across a process pool (the subprocess-cell pattern of
    ``analysis/sweep.py``, with warm workers instead of cold interpreters);
  * every result — feasible or not — lands in a content-addressed on-disk
    cache (sha256 of config + network fingerprint -> ``DSEPoint`` JSON), so
    sweeps are resumable and incremental: re-running is ~100% cache hits,
    and editing a workload table invalidates exactly the points that used it;
  * within a worker, repeated layer shapes share one schedule + tsim run via
    the ``run_network`` layer cache (deep ResNets are mostly repeat blocks);
  * the report gives per-network frontiers plus a *joint* frontier over
    configs feasible on every network (joint cycles = sum across networks).

The port's copy of the JAX package's ``core/dse.py``. Verification runs on
the card by default (``backend="torch"``): every winning tile of
``tune="full"`` runs through the hand-written kernels. Three departures
keep the card visible: a ``CardFault`` of a verification propagates out of
``eval_job`` and ``run_sweep`` and is never recorded as an infeasible
point; a backend that cannot run at all raises before any point is
evaluated; and on the card the pool's workers start by ``spawn`` (a forked
child cannot use the parent's CUDA context), one by default.

CLI:

  PYTHONPATH=src python -m repro_torch.core.dse --networks resnet18,mobilenet \
      --out results/dse
"""
from __future__ import annotations

import argparse
import hashlib
import json
import math
import multiprocessing
import os
import pickle
import sys
import time
from collections import OrderedDict
from concurrent.futures import FIRST_COMPLETED, ProcessPoolExecutor, wait
from dataclasses import dataclass, field
from typing import Callable, Optional

from repro_torch.core import stages
from repro_torch.core.area_model import scaled_area
from repro_torch.vta.backend import CardFault, get_backend, on_card
from repro_torch.vta.isa import VTAConfig
from repro_torch.vta.network import run_network
from repro_torch.vta.schedule_cache import ScheduleStore
from repro_torch.vta.workloads import (network_fingerprint, network_graph,
                                       resolve_network)

ENGINE_VERSION = 5       # bump to invalidate every cached point
                         # v2: graph compiler (residual adds modeled, fused
                         # segments, scratchpad residency)
                         # v3: vectorized ALU macro-ops (MAC/overwrite),
                         # double-buffered ALU-layer pipelines, pad-aware
                         # patch loads, dedup_loads on by default
                         # v4: tsim-in-the-loop per-layer tile autotuner is
                         # the default lowering policy (tune=off|cached|full)
                         # v5: hazard-free token protocol (same-ctx release
                         # tokens, interleaved reduction loops, per-thread
                         # merged-dedup halves) + the typed-trace execution
                         # backend layer (run_tsim check_hazards, fsim on
                         # the lowered trace, batched jax backend)
CACHE_SCHEMA_VERSION = 3  # on-disk record layout; get() rejects other versions
                          # (v3: points carry tuned_layers /
                          # tuning_cycles_saved; autotune tile records share
                          # this stamp)

TUNE_MODES = ("off", "cached", "full")

DEFAULT_LOG_BLOCKS = (4, 5, 6)
DEFAULT_MEM_WIDTHS = (8, 16, 32, 64)
DEFAULT_SPAD_SCALES = (1, 2, 4)


# ---------------------------------------------------------------------------
# Points and configs
# ---------------------------------------------------------------------------
@dataclass
class DSEPoint:
    hw: VTAConfig
    cycles: int
    area: float                 # scaled to reference
    dram_bytes: int
    label: str = ""
    network: str = ""
    macs: int = 0
    dram_bytes_saved: int = 0   # DRAM bytes the graph compiler avoided
    tuned_layers: int = 0       # layers whose tile the autotuner committed
    tuning_cycles_saved: int = 0  # cycles the autotuner saved vs heuristics
    layers: list = field(default_factory=list)   # per-layer dicts (optional)
    segments: list = field(default_factory=list)  # per-segment dicts (optional)

    @property
    def mac_shape(self) -> str:
        return f"{self.hw.log_block_in}x{self.hw.log_block_out}"

    def to_dict(self) -> dict:
        return {"feasible": True, "network": self.network, "label": self.label,
                "cycles": self.cycles, "area": self.area,
                "dram_bytes": self.dram_bytes, "macs": self.macs,
                "dram_bytes_saved": self.dram_bytes_saved,
                "tuned_layers": self.tuned_layers,
                "tuning_cycles_saved": self.tuning_cycles_saved,
                "mac_shape": self.mac_shape,
                "config": json.loads(self.hw.to_json()),
                "layers": self.layers, "segments": self.segments}

    @staticmethod
    def from_dict(d: dict) -> "DSEPoint":
        return DSEPoint(hw=VTAConfig.from_json(json.dumps(d["config"])),
                        cycles=d["cycles"], area=d["area"],
                        dram_bytes=d["dram_bytes"], label=d["label"],
                        network=d.get("network", ""), macs=d.get("macs", 0),
                        dram_bytes_saved=d.get("dram_bytes_saved", 0),
                        tuned_layers=d.get("tuned_layers", 0),
                        tuning_cycles_saved=d.get("tuning_cycles_saved", 0),
                        layers=d.get("layers", []),
                        segments=d.get("segments", []))


def make_config(log_block: int = 4, mem_width: int = 8, spad_scale: int = 1,
                batch_log: int = 0, pipelined: bool = True) -> VTAConfig:
    """One DSE candidate. spad_scale multiplies every scratchpad (pow2)."""
    s = int(math.log2(spad_scale))
    # scale wgt/acc with block area so depth (tiles held) stays comparable
    blk = log_block - 4
    return VTAConfig(
        log_batch=batch_log,
        log_block_in=log_block,
        log_block_out=log_block,
        log_inp_buff=15 + s + blk + batch_log,
        log_wgt_buff=18 + s + 2 * blk,
        log_acc_buff=17 + s + blk + batch_log,
        log_uop_buff=15 + s,
        mem_width_bytes=mem_width,
        gemm_ii=1 if pipelined else 4,
        alu_ii=1 if pipelined else 4,
    )


# ---------------------------------------------------------------------------
# Jobs
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class DSEJob:
    """One unit of sweep work: a hardware candidate evaluated on one network."""
    network: str
    log_block: int = 4
    mem_width: int = 8
    spad_scale: int = 1
    batch_log: int = 0
    pipelined: bool = True
    per_layer: bool = True      # include per-layer breakdowns in the record
    residency: bool = True      # graph compiler: fusion + on-chip residency
    tune: str = "cached"        # autotuner policy: off | cached | full
    backend: str = "torch"      # execution backend for fsim verification
                                # (vta/backend.py registry; results are
                                # bit-identical across backends, so the
                                # cache key excludes it)

    def __post_init__(self):
        # canonicalize aliases so key() and evaluation always agree
        object.__setattr__(self, "network", resolve_network(self.network))
        assert self.tune in TUNE_MODES, self.tune

    def config(self) -> VTAConfig:
        return make_config(self.log_block, self.mem_width, self.spad_scale,
                           self.batch_log, self.pipelined)

    @property
    def config_label(self) -> str:
        base = (f"b{1 << self.batch_log}x{1 << self.log_block}"
                f"x{1 << self.log_block}/mw{self.mem_width}"
                f"/sp{self.spad_scale}")
        # unpipelined points need their own label: joint_points dedups by
        # label, and a joint pipelined+unpipelined sweep would collide
        return base if self.pipelined else base + "/np"

    @property
    def label(self) -> str:
        return f"{self.network}:{self.config_label}"

    def key(self) -> str:
        """Content address: engine version + config + workload fingerprint.

        ``tune`` enters as on/off only: "cached" and "full" run the same
        deterministic search, so their points are interchangeable.
        """
        ident = {"v": ENGINE_VERSION,
                 "config": json.loads(self.config().to_json()),
                 "network": self.network,
                 "workload": network_fingerprint(self.network,
                                                batch=1 << self.batch_log),
                 "pipelined": self.pipelined,
                 "per_layer": self.per_layer,
                 "residency": self.residency,
                 "autotune": self.tune != "off"}
        blob = json.dumps(ident, sort_keys=True).encode()
        return hashlib.sha256(blob).hexdigest()


def make_jobs(networks, *, log_blocks=DEFAULT_LOG_BLOCKS,
              mem_widths=DEFAULT_MEM_WIDTHS, spad_scales=DEFAULT_SPAD_SCALES,
              batch_logs=(0,), pipelined=True,
              per_layer: bool = True, residency: bool = True,
              tune: str = "cached", backend: str = "torch") -> list[DSEJob]:
    """``pipelined`` is a bool or a tuple of bools (joint on/off sweeps)."""
    pls = tuple(pipelined) if isinstance(pipelined, (tuple, list)) \
        else (pipelined,)
    return [DSEJob(network=n, log_block=lb, mem_width=mw, spad_scale=ss,
                   batch_log=bl, pipelined=pl, per_layer=per_layer,
                   residency=residency, tune=tune, backend=backend)
            for n in networks for lb in log_blocks for mw in mem_widths
            for ss in spad_scales for bl in batch_logs for pl in pls]


# ---------------------------------------------------------------------------
# Content-addressed result cache
# ---------------------------------------------------------------------------
class ResultCache:
    """One JSON file per point under ``<dir>/<sha256>.json``.

    Every record is stamped with ``CACHE_SCHEMA_VERSION`` on put; ``get``
    rejects records carrying any other version (counted as a miss) instead
    of returning them — a schema bump can never surface stale-layout
    records, even when the content key happens to collide across engine
    generations.
    """

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.hits = 0
        self.misses = 0
        self.stale = 0

    def path(self, key: str) -> str:
        return os.path.join(self.root, key + ".json")

    def get(self, key: str) -> Optional[dict]:
        p = self.path(key)
        try:
            with open(p) as f:
                rec = json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            self.misses += 1
            return None
        if rec.get("schema") != CACHE_SCHEMA_VERSION:
            self.stale += 1
            self.misses += 1
            return None
        self.hits += 1
        return rec

    def put(self, key: str, record: dict) -> None:
        record = {**record, "schema": CACHE_SCHEMA_VERSION}
        # pid-unique tmp name: concurrent pool workers may race on one key
        # (identical content); a shared tmp path could vanish mid-replace
        tmp = f"{self.path(key)}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump(record, f, indent=1)
        os.replace(tmp, self.path(key))

    def __len__(self) -> int:
        return sum(1 for n in os.listdir(self.root) if n.endswith(".json"))


class ScheduleBlobCache:
    """On-disk pickle store for shared schedule entries (``<out>/schedules``).

    Keys are the structural build identities from ``vta/schedule_cache``
    (layer shape + schedule knobs + ``hw.schedule_key()`` + tile); the
    filename is sha256 over the engine/schema stamp plus the key repr. The
    blob stores ``(key, entry)`` and ``get`` requires the stored key to
    compare equal, so a filename collision or stale file can never surface
    the wrong program. Corrupt or unreadable blobs count as misses.
    """

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.hits = 0
        self.misses = 0

    def path(self, key) -> str:
        stamp = repr((ENGINE_VERSION, CACHE_SCHEMA_VERSION)) + repr(key)
        return os.path.join(
            self.root, hashlib.sha256(stamp.encode()).hexdigest() + ".pkl")

    def get(self, key):
        try:
            with open(self.path(key), "rb") as f:
                stored_key, ent = pickle.load(f)
        except Exception:
            self.misses += 1
            return None
        if stored_key != key:
            self.misses += 1
            return None
        self.hits += 1
        return ent

    def put(self, key, ent) -> None:
        p = self.path(key)
        # pid-unique tmp name: pool workers may race on identical content
        tmp = f"{p}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:
            pickle.dump((key, ent), f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, p)


# ---------------------------------------------------------------------------
# Job evaluation (runs inside pool workers)
# ---------------------------------------------------------------------------
class LRUCache:
    """Bounded mapping with the subset of the dict API the layer cache
    uses (``get`` / ``[]=`` / ``len``). Unbounded growth matters now that
    one sweep process hosts many (network x geometry) groups."""

    def __init__(self, maxsize: int = 4096):
        self.maxsize = maxsize
        self.evictions = 0
        self._d: OrderedDict = OrderedDict()

    def get(self, key, default=None):
        try:
            val = self._d[key]
        except KeyError:
            return default
        self._d.move_to_end(key)
        return val

    def __setitem__(self, key, val) -> None:
        self._d[key] = val
        self._d.move_to_end(key)
        while len(self._d) > self.maxsize:
            self._d.popitem(last=False)
            self.evictions += 1

    def __len__(self) -> int:
        return len(self._d)

    def clear(self) -> None:
        self._d.clear()

    def stats(self) -> dict:
        return {"len": len(self._d), "maxsize": self.maxsize,
                "evictions": self.evictions}


_LAYER_CACHE = LRUCache()   # per-process: repeated shapes share tsim runs
_TUNERS: dict = {}          # per-process: (mode, dirs) -> LayerTuner
_SCHEDULE_STORES: dict = {}  # per-process: schedule_dir -> ScheduleStore


def _schedule_store(schedule_dir: Optional[str]) -> ScheduleStore:
    """Per-process ScheduleStore, disk-backed when a dir is given."""
    if schedule_dir not in _SCHEDULE_STORES:
        backing = ScheduleBlobCache(schedule_dir) if schedule_dir else None
        _SCHEDULE_STORES[schedule_dir] = ScheduleStore(backing=backing)
    return _SCHEDULE_STORES[schedule_dir]


def _tuner_for(job: DSEJob, tune_dir: Optional[str],
               schedule_dir: Optional[str] = None):
    """Per-process LayerTuner (memo of searched tiles survives across jobs;
    the persistent cache at ``tune_dir`` survives across runs)."""
    if job.tune == "off":
        return None
    from repro_torch.vta.autotune import make_tuner
    key = (job.tune, tune_dir, schedule_dir)
    if key not in _TUNERS:
        _TUNERS[key] = make_tuner(job.tune, tune_dir,
                                  schedules=_schedule_store(schedule_dir))
    return _TUNERS[key]


def eval_job(job: DSEJob, tune_dir: Optional[str] = None,
             schedule_dir: Optional[str] = None) -> dict:
    """Evaluate one job to its cache record (feasible point or reason).
    A ``CardFault`` of a verification propagates: it is no reason."""
    hw = job.config()
    base = {"network": job.network, "label": job.config_label,
            "config": json.loads(hw.to_json())}
    errs = hw.validate()
    if errs:
        return {**base, "feasible": False, "reason": "; ".join(errs)}
    graph = network_graph(job.network, 1 << job.batch_log)
    tuner = _tuner_for(job, tune_dir, schedule_dir)
    if tuner is not None:
        # a backend that cannot run (no card) raises here, not as a reason
        get_backend(job.backend)
    try:
        # dedup_loads: the paper's §IV.D.2 redundant-load elimination is on
        # for every sweep point (it needs a double-buffered tiling to bite)
        rep = run_network(job.network, graph, hw, layer_cache=_LAYER_CACHE,
                          dedup_loads=True,
                          fusion=job.residency, residency=job.residency,
                          tuner=tuner, backend=job.backend,
                          schedules=_schedule_store(schedule_dir))
    except (AssertionError, RuntimeError, ValueError) as e:
        # infeasible point (sparse design space, §V)
        return {**base, "feasible": False,
                "reason": f"{type(e).__name__}: {e}"}
    pt = DSEPoint(hw=hw, cycles=rep.total_cycles,
                  area=scaled_area(hw, make_config()),
                  dram_bytes=rep.total_dram_bytes, label=job.config_label,
                  network=job.network, macs=rep.total_macs,
                  dram_bytes_saved=rep.dram_bytes_saved,
                  tuned_layers=rep.tuned_layers,
                  tuning_cycles_saved=rep.tuning_cycles_saved,
                  layers=rep.per_layer() if job.per_layer else [],
                  segments=rep.per_segment() if job.per_layer else [])
    return pt.to_dict()


def _group_jobs(jobs: list[DSEJob]) -> list[list[DSEJob]]:
    """Bucket jobs that differ only in *cost* knobs (mem width, pipelining).

    Members of one bucket schedule byte-identical programs — evaluating
    them on the same worker turns all but the first into cost-model
    replays against the shared ScheduleStore.
    """
    groups: dict = {}
    for job in jobs:
        gk = (job.network, job.log_block, job.spad_scale, job.batch_log,
              job.per_layer, job.residency, job.tune, job.backend)
        groups.setdefault(gk, []).append(job)
    return list(groups.values())


def pool_settings(backend: str, workers: Optional[int]) -> tuple:
    """(workers, multiprocessing context) of the sweep's process pool. On
    the card: ``spawn`` (a child forked after the parent set up CUDA cannot
    use the card) and 1 worker unless asked (each is a CUDA context on the
    one card). Elsewhere: the platform's default start method and one
    worker per CPU, as in the JAX package."""
    if on_card(backend):
        return workers or 1, multiprocessing.get_context("spawn")
    return workers or max(1, os.cpu_count() or 1), None


def _pool_eval(job: DSEJob, tune_dir: Optional[str] = None,
               schedule_dir: Optional[str] = None) -> dict:
    return eval_job(job, tune_dir, schedule_dir)


def _pool_eval_group(jobs: list[DSEJob], tune_dir: Optional[str] = None,
                     schedule_dir: Optional[str] = None) -> dict:
    """Evaluate one cost-variant group; returns records + profile deltas."""
    st0 = stages.snapshot()
    store = _schedule_store(schedule_dir)
    ss0 = store.stats()
    ev0 = _LAYER_CACHE.evictions
    recs = [eval_job(job, tune_dir, schedule_dir) for job in jobs]
    ss1 = store.stats()
    prof = {"stages": stages.delta(st0),
            "schedule_store": {
                **{k: ss1[k] - ss0[k]
                   for k in ("hits", "misses", "evictions", "disk_hits")},
                "len": ss1["len"], "maxsize": ss1["maxsize"]},
            "layer_cache": {"len": len(_LAYER_CACHE),
                            "maxsize": _LAYER_CACHE.maxsize,
                            "evictions": _LAYER_CACHE.evictions - ev0}}
    return {"records": recs, "profile": prof}


# ---------------------------------------------------------------------------
# Sweep engine
# ---------------------------------------------------------------------------
@dataclass
class SweepResult:
    points: dict                # network -> list[DSEPoint]
    infeasible: dict            # network -> list[record]
    cache_hits: int = 0
    cache_misses: int = 0
    wall_s: float = 0.0
    profile: Optional[dict] = None   # per-stage seconds + cache stats

    @property
    def networks(self) -> list[str]:
        return sorted(self.points)

    def frontier(self, network: str) -> list[DSEPoint]:
        return pareto(self.points[network])

    def joint_points(self) -> list[dict]:
        """Configs feasible on *every* network: joint cycles = sum."""
        by_label: dict = {}
        for net, pts in self.points.items():
            for p in pts:
                by_label.setdefault(p.label, {})[net] = p
        nets = set(self.points)
        out = []
        for label, per_net in sorted(by_label.items()):
            if set(per_net) != nets:
                continue
            any_pt = next(iter(per_net.values()))
            out.append({"label": label, "area": any_pt.area,
                        "cycles": sum(p.cycles for p in per_net.values()),
                        "per_network": {n: p.cycles
                                        for n, p in per_net.items()}})
        return out

    def joint_frontier(self) -> list[dict]:
        return pareto_front(self.joint_points(),
                            area=lambda d: d["area"],
                            cycles=lambda d: d["cycles"])

    def report(self) -> dict:
        rep = {"engine_version": ENGINE_VERSION,
               "networks": self.networks,
               "cache": {"hits": self.cache_hits, "misses": self.cache_misses},
               "wall_s": round(self.wall_s, 2),
               "per_network": {}, "joint": {}}
        for net in self.networks:
            pts = self.points[net]
            entry = {"n_points": len(pts),
                     "n_infeasible": len(self.infeasible.get(net, [])),
                     "pareto": [(p.label, p.area, p.cycles)
                                for p in self.frontier(net)],
                     "total_dram_bytes": sum(p.dram_bytes for p in pts),
                     "total_dram_bytes_saved": sum(p.dram_bytes_saved
                                                   for p in pts),
                     "total_tuning_cycles_saved": sum(p.tuning_cycles_saved
                                                      for p in pts)}
            if pts:
                ref = _reference_point(pts)
                best = min(pts, key=lambda p: p.cycles)
                entry.update(
                    ref=(ref.label, ref.area, ref.cycles),
                    best=(best.label, best.area, best.cycles),
                    ref_dram_bytes=ref.dram_bytes,
                    ref_dram_bytes_saved=ref.dram_bytes_saved,
                    ref_tuned_layers=ref.tuned_layers,
                    ref_tuning_cycles_saved=ref.tuning_cycles_saved,
                    cycle_gain_best=ref.cycles / best.cycles,
                    area_cost_best=best.area / ref.area,
                    area_span=max(p.area for p in pts) / min(p.area for p in pts),
                )
            rep["per_network"][net] = entry
        joint = self.joint_points()
        if joint:
            ref = min((d for d in joint if d["area"] <= 1.0 + 1e-9),
                      key=lambda d: d["area"], default=min(joint, key=lambda d: d["area"]))
            best = min(joint, key=lambda d: d["cycles"])
            rep["joint"] = {"n_points": len(joint),
                            "pareto": [(d["label"], d["area"], d["cycles"])
                                       for d in self.joint_frontier()],
                            "ref": (ref["label"], ref["area"], ref["cycles"]),
                            "best": (best["label"], best["area"], best["cycles"]),
                            "cycle_gain_best": ref["cycles"] / best["cycles"],
                            "area_cost_best": best["area"] / ref["area"]}
        if self.profile is not None:
            rep["profile"] = self.profile
        return rep


def _reference_point(pts: list[DSEPoint]) -> DSEPoint:
    """The pipelined default: smallest MAC array, narrowest bus (area 1.0x)."""
    cands = [p for p in pts if p.hw.log_block_in == 4
             and p.hw.mem_width_bytes == 8]
    # joint pipelined+unpipelined sweeps: the reference stays the
    # *pipelined* default (the paper's §V baseline), not its slowed twin
    pip = [p for p in cands if p.hw.gemm_ii == 1]
    return min(pip or cands or pts, key=lambda p: p.area)


def run_sweep(networks, *, out_dir: Optional[str] = None,
              log_blocks=DEFAULT_LOG_BLOCKS, mem_widths=DEFAULT_MEM_WIDTHS,
              spad_scales=DEFAULT_SPAD_SCALES, batch_logs=(0,),
              pipelined=True, workers: Optional[int] = None,
              per_layer: bool = True, use_cache: bool = True,
              residency: bool = True, tune: str = "cached",
              backend: str = "torch", profile: bool = False,
              progress: Optional[Callable[[str], None]] = None) -> SweepResult:
    """Run the full (config grid x networks) sweep across a process pool.

    ``out_dir`` holds the content-addressed cache at ``<out_dir>/cache``,
    the autotuner's tile cache at ``<out_dir>/autotune``, the shared
    schedule blobs at ``<out_dir>/schedules`` and the combined
    ``report.json``; omit it for a purely in-memory sweep.
    ``residency=False`` turns the graph compiler off (per-layer baseline);
    ``tune`` sets the autotuner policy (off | cached | full);
    ``pipelined`` may be a bool or a tuple of bools (joint on/off sweep);
    ``profile=True`` adds a per-stage wall-time + cache-stats section to
    the report.

    Jobs that differ only in cost knobs (memory width, pipelining) are
    grouped onto one worker: the group schedules each distinct program
    once and replays its cost model per variant (``vta/schedule_cache``).
    ``workers`` and the pool's start method come from ``pool_settings``.
    A ``CardFault`` ends the sweep; the faulted point is not cached.
    """
    t0 = time.time()
    jobs = make_jobs(networks, log_blocks=log_blocks, mem_widths=mem_widths,
                     spad_scales=spad_scales, batch_logs=batch_logs,
                     pipelined=pipelined, per_layer=per_layer,
                     residency=residency, tune=tune, backend=backend)
    keys = {job: job.key() for job in jobs}
    cache = None
    tune_dir = None
    schedule_dir = None
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        if use_cache:
            cache = ResultCache(os.path.join(out_dir, "cache"))
        if tune != "off":
            tune_dir = os.path.join(out_dir, "autotune")
        schedule_dir = os.path.join(out_dir, "schedules")

    records: dict[str, dict] = {}
    todo: list[DSEJob] = []
    for job in jobs:
        rec = cache.get(keys[job]) if cache is not None else None
        if rec is not None:
            records[keys[job]] = rec
        else:
            todo.append(job)

    prof = {"stages": {}, "schedule_store": {}, "layer_cache": {}}

    def absorb(p: dict) -> None:
        stages.merge(prof["stages"], p["stages"])
        for sect in ("schedule_store", "layer_cache"):
            d = prof[sect]
            for k, v in p[sect].items():
                if k in ("len", "maxsize"):     # gauges, not counters
                    d[k] = max(d.get(k, 0), v)
                else:
                    d[k] = d.get(k, 0) + v

    if todo:
        workers, mp_context = pool_settings(backend, workers)
        groups = _group_jobs(todo)

        def note(key: str, rec: dict):
            if cache is not None:
                cache.put(key, rec)
            if progress:
                status = "ok" if rec.get("feasible") else "infeasible"
                progress(f"[{len(records)}/{len(jobs)}] "
                         f"{rec['network']}:{rec['label']} {status}")

        def land(group: list[DSEJob], out: dict):
            for job, rec in zip(group, out["records"]):
                records[keys[job]] = rec
                note(keys[job], rec)
            absorb(out["profile"])

        if workers == 1 or len(groups) == 1:
            for group in groups:
                land(group, _pool_eval_group(group, tune_dir, schedule_dir))
        else:
            with ProcessPoolExecutor(max_workers=workers,
                                     mp_context=mp_context) as pool:
                futs = {pool.submit(_pool_eval_group, group, tune_dir,
                                    schedule_dir): group
                        for group in groups}
                pending = set(futs)
                while pending:
                    done, pending = wait(pending, return_when=FIRST_COMPLETED)
                    for fut in done:
                        land(futs[fut], fut.result())

    points: dict[str, list[DSEPoint]] = {}
    infeasible: dict[str, list[dict]] = {}
    for job in jobs:
        rec = records[keys[job]]
        if rec.get("feasible"):
            points.setdefault(job.network, []).append(DSEPoint.from_dict(rec))
        else:
            infeasible.setdefault(job.network, []).append(rec)
    for net in {j.network for j in jobs}:
        points.setdefault(net, [])

    prof["stages"] = {k: round(v, 3) for k, v in prof["stages"].items()}
    res = SweepResult(points=points, infeasible=infeasible,
                      cache_hits=cache.hits if cache else 0,
                      cache_misses=cache.misses if cache else 0,
                      wall_s=time.time() - t0,
                      profile=prof if profile else None)
    if out_dir is not None:
        with open(os.path.join(out_dir, "report.json"), "w") as f:
            json.dump(res.report(), f, indent=2)
    return res


# ---------------------------------------------------------------------------
# Pareto frontier
# ---------------------------------------------------------------------------
def pareto_front(items: list, *, area: Callable, cycles: Callable) -> list:
    """Lower-left frontier: min cycles for given area (generic)."""
    best = float("inf")
    front = []
    for it in sorted(items, key=lambda x: (area(x), cycles(x))):
        if cycles(it) < best:
            front.append(it)
            best = cycles(it)
    return front


def pareto(points: list[DSEPoint]) -> list[DSEPoint]:
    """Lower-left frontier: min cycles for given area."""
    return pareto_front(points, area=lambda p: p.area,
                        cycles=lambda p: p.cycles)


# ---------------------------------------------------------------------------
# Back-compat serial API (single network, explicit layer list)
# ---------------------------------------------------------------------------
def sweep(layers, *, reference: Optional[VTAConfig] = None,
          log_blocks=DEFAULT_LOG_BLOCKS, mem_widths=DEFAULT_MEM_WIDTHS,
          spad_scales=DEFAULT_SPAD_SCALES, batch_logs=(0,),
          network: str = "resnet18", progress=None) -> list[DSEPoint]:
    """Serial in-process sweep of one explicit layer list (legacy API)."""
    reference = reference or make_config()
    layer_cache: dict = {}
    points: list[DSEPoint] = []
    for lb in log_blocks:
        for mw in mem_widths:
            for ss in spad_scales:
                for bl in batch_logs:
                    hw = make_config(lb, mw, ss, bl)
                    if hw.validate():
                        continue
                    try:
                        rep = run_network(network, layers, hw,
                                          layer_cache=layer_cache)
                    except (AssertionError, RuntimeError, ValueError):
                        continue      # infeasible point (sparse space, §V)
                    pt = DSEPoint(hw=hw, cycles=rep.total_cycles,
                                  area=scaled_area(hw, reference),
                                  dram_bytes=rep.total_dram_bytes,
                                  network=network, macs=rep.total_macs,
                                  label=f"b{1 << bl}x{1 << lb}x{1 << lb}"
                                        f"/mw{mw}/sp{ss}")
                    points.append(pt)
                    if progress:
                        progress(pt)
    return points


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------
def _print_report(rep: dict) -> None:
    print(f"== DSE report ({', '.join(rep['networks'])}) ==")
    c = rep["cache"]
    print(f"  cache: {c['hits']} hits / {c['misses']} misses   "
          f"wall {rep['wall_s']:.1f}s")
    for net, e in rep["per_network"].items():
        print(f"  -- {net}: {e['n_points']} feasible points "
              f"(+{e['n_infeasible']} infeasible)")
        for label, a, cyc in e["pareto"]:
            print(f"     {label:22s} area {a:6.2f}x  cycles {cyc/1e6:8.2f}M")
        if "cycle_gain_best" in e:
            print(f"     big end {e['best'][0]}: {e['cycle_gain_best']:.1f}x "
                  f"fewer cycles at {e['area_cost_best']:.1f}x area "
                  f"[paper: ~11.5x at ~12x]")
        if e.get("total_dram_bytes_saved"):
            print(f"     graph compiler: {e['total_dram_bytes_saved']/1e6:.1f}MB "
                  f"DRAM avoided across points "
                  f"(ref config {e.get('ref_dram_bytes_saved', 0)/1e6:.2f}MB)")
        if e.get("total_tuning_cycles_saved"):
            print(f"     autotuner: {e['total_tuning_cycles_saved']/1e6:.2f}M "
                  f"cycles saved across points (ref config "
                  f"{e.get('ref_tuning_cycles_saved', 0)/1e3:.0f}k over "
                  f"{e.get('ref_tuned_layers', 0)} tuned layers)")
    j = rep.get("joint") or {}
    if j:
        print(f"  -- joint ({len(rep['networks'])} networks, "
              f"{j['n_points']} common configs):")
        for label, a, cyc in j["pareto"]:
            print(f"     {label:22s} area {a:6.2f}x  cycles {cyc/1e6:8.2f}M")
        print(f"     big end {j['best'][0]}: {j['cycle_gain_best']:.1f}x "
              f"fewer cycles at {j['area_cost_best']:.1f}x area")
    p = rep.get("profile")
    if p:
        st = p.get("stages", {})
        breakdown = "  ".join(f"{k} {v:.1f}s" for k, v in sorted(st.items()))
        print(f"  -- profile: {breakdown or 'no instrumented work'}")
        ss = p.get("schedule_store", {})
        if ss:
            print(f"     schedule store: {ss.get('hits', 0)} hits / "
                  f"{ss.get('misses', 0)} misses "
                  f"({ss.get('disk_hits', 0)} from disk, "
                  f"{ss.get('evictions', 0)} evicted, "
                  f"len {ss.get('len', 0)}/{ss.get('maxsize', 0)})")
        lc = p.get("layer_cache", {})
        if lc:
            print(f"     layer cache: len {lc.get('len', 0)}"
                  f"/{lc.get('maxsize', 0)} "
                  f"({lc.get('evictions', 0)} evicted)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.core.dse",
        description="Parallel cached multi-network VTA design-space sweep")
    ap.add_argument("--networks", default="resnet18",
                    help="comma-separated (resnet18,resnet34,resnet50,"
                         "resnet101,mobilenet)")
    ap.add_argument("--out", default="results/dse",
                    help="output dir (cache + report.json)")
    ap.add_argument("--workers", type=int, default=None,
                    help="process-pool size (default: 1 with a backend on "
                         "the card, whose workers start by spawn; else the "
                         "cpu count, started by the platform's default)")
    ap.add_argument("--log-blocks", default="4,5,6")
    ap.add_argument("--mem-widths", default="8,16,32,64")
    ap.add_argument("--spad-scales", default="1,2,4")
    ap.add_argument("--batch-logs", default="0")
    ap.add_argument("--pipelined", default="1",
                    help='comma list of 1/0, e.g. "1,0" for a joint '
                         "pipelined + unpipelined sweep (default: 1)")
    ap.add_argument("--profile", action="store_true",
                    help="add per-stage wall time (schedule / autotune / "
                         "tsim-cost / fsim-verify) and cache statistics to "
                         "the report")
    ap.add_argument("--no-cache", action="store_true",
                    help="recompute everything, do not read/write the cache")
    ap.add_argument("--no-per-layer", action="store_true",
                    help="omit per-layer breakdowns from cached points")
    ap.add_argument("--no-residency", action="store_true",
                    help="disable the graph compiler (fusion + on-chip "
                         "residency): per-layer baseline numbers")
    ap.add_argument("--tune", choices=TUNE_MODES, default="cached",
                    help="per-layer tile autotuner policy (default: cached "
                         "— reuse tiles from <out>/autotune, search misses)")
    ap.add_argument("--no-autotune", action="store_true",
                    help="shorthand for --tune off (heuristic tilings only)")
    ap.add_argument("--backend", default="torch",
                    help="execution backend for fsim verification "
                         "(numpy | torch | torch-cpu; see vta/backend.py — "
                         "results are bit-identical; torch runs on the card "
                         "through the hand-written kernels, torch-cpu runs "
                         "their plain versions)")
    args = ap.parse_args(argv)

    ints = lambda s: tuple(int(x) for x in s.split(",") if x)
    nets = [n for n in args.networks.split(",") if n]
    try:
        nets = [resolve_network(n) for n in nets]
    except KeyError as e:
        print(f"error: {e.args[0]}", file=sys.stderr)
        return 2
    if not nets:
        print("error: --networks is empty", file=sys.stderr)
        return 2
    try:
        res = run_sweep(
            nets,
            out_dir=args.out,
            log_blocks=ints(args.log_blocks),
            mem_widths=ints(args.mem_widths),
            spad_scales=ints(args.spad_scales),
            batch_logs=ints(args.batch_logs),
            pipelined=tuple(bool(int(x)) for x in args.pipelined.split(",")
                            if x),
            workers=args.workers, per_layer=not args.no_per_layer,
            use_cache=not args.no_cache, residency=not args.no_residency,
            tune="off" if args.no_autotune else args.tune,
            backend=args.backend, profile=args.profile,
            progress=lambda line: print(line, flush=True))
    except CardFault as e:
        print(f"error: card fault: {e}", file=sys.stderr)
        return 3
    _print_report(res.report())
    if args.out:
        print(f"  report: {os.path.join(args.out, 'report.json')}")
    return 0 if any(res.points.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
