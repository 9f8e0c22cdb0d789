"""Tsim-in-the-loop per-layer tile autotuner with a persistent tuning cache.

The paper's Pareto story (§IV.F) assumes the software picks a *good* tiling
for every (layer, hardware config) pair, yet the stack's one-shot heuristic
— the analytic traffic-minimal TPS tiling (``core/tps``) — leaves real
cycles on the table: byte-minimal tilings can fragment DRAM transfers (each
pays first-beat latency), bloat the uop stream (uop loads ride the compute
queue), or under-overlap load with compute. Following the TVM/VTA pairing
of Moreau et al. (arXiv:1807.04188), this module searches tile shapes per
layer with the cycle-accurate simulator as the cost oracle:

  1. **seed** — ``core/tile_search.vta_tile_candidates`` enumerates the
     Appendix-A tiling space, prunes it against the config's analytic
     scratchpad capacities, and ranks per virtual-thread mode by DRAM
     traffic *and* estimated cycles; ALU-lowered layers (depthwise / pool)
     enumerate spatial tiles (``vta_alu_tile_candidates``);
  2. **schedule** — every candidate is lowered through the existing
     ``emit_*_tasks`` paths; candidates that trip the scheduler's exact
     capacity asserts, the uop allocator, or the 128-bit encoder are pruned
     (the same checks a mis-sized runtime would hit on real VTA);
  3. **score** — tsim cycles decide; the heuristic tiling is always
     candidate #0, so tuning is *never worse* by construction;
  4. **verify** — the winner is executed in fsim against the numpy oracle
     bit-exactly before it is accepted; a diverging candidate (a machine-
     model bug, not a legal outcome) is discarded and the next-best wins;
  5. **cache** — the chosen tile is persisted content-addressed:
     sha256(engine version + config + layer fingerprint + search knobs) →
     tile JSON, stamped with the DSE cache schema version and rejected on
     mismatch (mirroring ``core/dse.ResultCache``, which it reuses). Repeat
     runs — and CI — are near-free.

``LayerTuner`` is the object ``run_network`` / ``compile_graph`` thread
through; ``core/dse`` surfaces it as the default lowering policy behind the
``tune=off|cached|full`` knob (``--no-autotune`` CLI).
"""
from __future__ import annotations

import hashlib
import json
import time
from dataclasses import asdict, dataclass, replace
from types import SimpleNamespace
from typing import Optional

import numpy as np

from repro_torch.core.stages import stage
from repro_torch.core.tile_search import (vta_alu_tile_candidates,
                                          vta_tile_candidates)
from repro_torch.core.tps import ConvWorkload, Tiling, heuristic_conv_tiling
from repro_torch.vta.fsim import (conv2d_ref, depthwise_ref, pool_ref,
                                  post_op_ref)
from repro_torch.vta.isa import VTAConfig
from repro_torch.vta.runtime import Program, UopAllocator, finalize
from repro_torch.vta.schedule_cache import (KnownScheduleFailure, alu_key,
                                            conv_key, fused_conv_key)
from repro_torch.vta.scheduler import (emit_conv_tasks, schedule_conv,
                                       schedule_depthwise, schedule_pool)
from repro_torch.vta.tsim import run_tsim

TUNABLE_KINDS = ("conv", "dense", "depthwise", "maxpool", "avgpool")


# ---------------------------------------------------------------------------
# Tune results and their JSON cache records
# ---------------------------------------------------------------------------
@dataclass
class TuneResult:
    kind: str                        # layer kind ("conv+add" for fused heads)
    tile: object                     # Tiling (GEMM path) | (th, tw) (ALU path)
    cycles: int                      # tsim cycles of the chosen tile
    heuristic_cycles: int            # tsim cycles of the default tiling
    candidates: int = 0              # candidates scored by tsim
    pruned: int = 0                  # capacity-pruned candidates
    verified: bool = False           # fsim bit-exactness of the winner
    cached: bool = False             # served from the persistent cache

    @property
    def tuning_gain(self) -> int:
        """Cycles saved vs the heuristic tiling (>= 0 by construction)."""
        return self.heuristic_cycles - self.cycles

    def tile_dict(self) -> dict:
        if isinstance(self.tile, Tiling):
            return {"tb_o": self.tile.tb_o, "th_o": self.tile.th_o,
                    "tw_o": self.tile.tw_o, "tco_o": self.tile.tco_o,
                    "tci_o": self.tile.tci_o, "oc_n": self.tile.oc_n,
                    "h_n": self.tile.h_n}
        return {"th": self.tile[0], "tw": self.tile[1]}

    def to_record(self) -> dict:
        return {"kind": self.kind, "tile": self.tile_dict(),
                "cycles": self.cycles,
                "heuristic_cycles": self.heuristic_cycles,
                "candidates": self.candidates, "pruned": self.pruned,
                "verified": self.verified}

    @staticmethod
    def from_record(rec: dict) -> "TuneResult":
        t = rec["tile"]
        tile = Tiling(t["tb_o"], t["th_o"], t["tw_o"], t["tco_o"],
                      t["tci_o"], t["oc_n"], t["h_n"]) \
            if "tb_o" in t else (t["th"], t["tw"])
        return TuneResult(kind=rec["kind"], tile=tile, cycles=rec["cycles"],
                          heuristic_cycles=rec["heuristic_cycles"],
                          candidates=rec.get("candidates", 0),
                          pruned=rec.get("pruned", 0),
                          verified=rec.get("verified", False), cached=True)


# ---------------------------------------------------------------------------
# fsim bit-exactness oracles (deterministic synthetic data per fingerprint).
# Verification executes on any registered backend (vta/backend.py): the
# numpy FSim one image at a time, or the PyTorch executor over the whole
# calibration batch — on the card through the hand-written kernels.
# ---------------------------------------------------------------------------
def _rng(fingerprint: str) -> np.random.Generator:
    return np.random.default_rng(int(fingerprint[:8], 16))


def _run_verification(backend, prog: Program, hw: VTAConfig, *,
                      shared: dict, batched: dict, out: str) -> np.ndarray:
    """``prog``'s stored tensor ``out`` for the batch, in host memory.

    A candidate runs once, so a ``TorchBackend`` runs it on its uncaptured
    route (no plan, no graph, no device memo left on the trace). On the
    card, any exception of the backend call is raised as ``CardFault``: a
    kernel that does not build or launch is a fault to stop on, never a
    candidate or a design point that failed."""
    from repro_torch.vta.backend import CardFault, get_backend, on_card
    from repro_torch.vta.fsim_torch import TorchBackend
    be = get_backend(backend)
    if isinstance(be, TorchBackend):
        be = be.uncaptured()
    card = on_card(be)
    try:
        return be.run_batched(prog, hw, shared=shared,
                              batched=batched)[out].cpu().numpy()
    except Exception as e:
        if not card:
            raise
        raise CardFault(f"verification on {be.device}: "
                        f"{type(e).__name__}: {e}") from e


def _verify_conv(prog: Program, wl: ConvWorkload, hw: VTAConfig, *,
                 post_op: str, bias: bool, fingerprint: str,
                 skip_tensor: Optional[dict] = None,
                 backend="numpy", batch: int = 1) -> bool:
    """Run ``prog`` on ``batch`` random images via ``backend``; compare
    against the numpy reference. ``skip_tensor`` (fused residual heads)
    maps the skip DRAM tensor name to the out tensor name: ref adds the
    skip and re-clips. The first image's draws match the historical
    single-image verification exactly."""
    rng = _rng(fingerprint)
    inps = [rng.integers(-32, 32, (wl.b, wl.fi, wl.h, wl.w), dtype=np.int8)]
    wgt = rng.integers(-8, 8, (wl.fo, wl.fi, wl.kh, wl.kw), dtype=np.int8)
    out_shape = (wl.b, wl.fo, wl.oh, wl.ow)
    b = rng.integers(-100, 100, (wl.fo,), dtype=np.int32) if bias else None
    skips = [rng.integers(-64, 64, out_shape, dtype=np.int8)] \
        if skip_tensor is not None else None
    for _ in range(batch - 1):
        inps.append(rng.integers(-32, 32, inps[0].shape, dtype=np.int8))
        if skips is not None:
            skips.append(rng.integers(-64, 64, out_shape, dtype=np.int8))
    names = skip_tensor or {"inp": "inp", "wgt": "wgt", "bias": "bias",
                            "out": "out"}
    shared = {names["wgt"]: wgt}
    if bias:
        shared[names["bias"]] = b
    batched = {names["inp"]: np.stack(inps),
               names["out"]: np.zeros((batch,) + out_shape, np.int8)}
    if skips is not None:
        batched[names["skip"]] = np.stack(skips)
    outs = _run_verification(backend, prog, hw, shared=shared,
                             batched=batched, out=names["out"])
    # the conv oracle is batch-parallel: one call covers every image
    refs = post_op_ref(conv2d_ref(np.concatenate(inps), wgt, (wl.sh, wl.sw),
                                  (wl.ph, wl.pw), b), post_op)         .reshape(batch, *out_shape)
    if skips is not None:
        refs = np.clip(refs.astype(np.int32)
                       + np.stack(skips).astype(np.int32),
                       -127, 127).astype(np.int8)
    return bool(np.array_equal(outs, refs))


def _verify_alu(prog: Program, wl: ConvWorkload, hw: VTAConfig, *,
                kind: str, post_op: str, fingerprint: str,
                backend="numpy", batch: int = 1) -> bool:
    rng = _rng(fingerprint)
    inps = [rng.integers(-64, 64, (wl.b, wl.fi, wl.h, wl.w), dtype=np.int8)]
    out_shape = (wl.b, wl.fo, wl.oh, wl.ow)
    shared = {}
    if kind == "depthwise":
        shared["dw_wgt"] = rng.integers(-8, 8, (wl.fi, wl.kh, wl.kw),
                                        dtype=np.int8)
    for _ in range(batch - 1):
        inps.append(rng.integers(-64, 64, inps[0].shape, dtype=np.int8))
    batched = {"inp": np.stack(inps),
               "out": np.zeros((batch,) + out_shape, np.int8)}
    outs = _run_verification(backend, prog, hw, shared=shared,
                             batched=batched, out="out")
    stacked = np.concatenate(inps)       # the oracles are batch-parallel
    if kind == "depthwise":
        refs = post_op_ref(depthwise_ref(stacked, shared["dw_wgt"],
                                         (wl.sh, wl.sw), (wl.ph, wl.pw)),
                           post_op)
    else:
        refs = np.clip(pool_ref(stacked, (wl.kh, wl.kw), (wl.sh, wl.sw),
                                (wl.ph, wl.pw), kind[:3]),
                       -128, 127).astype(np.int8)
    return bool(np.array_equal(outs, refs.reshape(batch, *out_shape)))


# ---------------------------------------------------------------------------
# The tuner
# ---------------------------------------------------------------------------
class LayerTuner:
    """Per-layer tile search with tsim as the cost oracle.

    ``mode``: ``"cached"`` reads/writes the persistent tile cache (a
    ``core/dse.ResultCache`` directory — schema-stamped, schema-rejected);
    ``"full"`` ignores cached tiles and re-searches (still writing results).
    Mode ``"off"`` is represented by *not* constructing a tuner at all.

    The search-space knobs (``k_traffic``/``k_cycles``/``tune_alu``) are part
    of the cache fingerprint: shrinking the candidate pool can change the
    chosen tile, so differently-scoped searches never share cache entries.
    """

    def __init__(self, mode: str = "cached", cache=None, *,
                 k_traffic: int = 12, k_cycles: int = 8,
                 tune_alu: bool = True, verify: bool = True,
                 backend: str = "torch", verify_batch: int = 1,
                 schedules=None):
        assert mode in ("cached", "full"), mode
        self.mode = mode
        self.cache = cache               # ResultCache-like or None
        self.k_traffic = k_traffic
        self.k_cycles = k_cycles
        self.tune_alu = tune_alu
        self.verify = verify
        self.backend = backend           # execution backend for winner
        self.verify_batch = verify_batch  # images per verification
        self.schedules = schedules       # ScheduleStore: candidate programs
                                         # + cost models shared across
                                         # cost-only config variants (not a
                                         # search knob — excluded from tag)
        self._memo: dict = {}            # fingerprint -> TuneResult
        # verification verdicts per *shared* program object: when the store
        # hands cost variants the same scheduled program, fsim bit-exactness
        # (a function of the program, not of cost parameters) transfers.
        # Keyed by id() with a strong reference held, so ids stay valid.
        self._verify_memo: dict = {}     # id(prog) -> (prog, ok)
        # stats live in a dict so with_backend() copies keep reporting into
        # the caller-held tuner (searches / hits / verifications /
        # verify_seconds)
        self._stats = {"searches": 0, "hits": 0, "verifications": 0,
                       "verify_seconds": 0.0}

    def with_backend(self, backend=None, verify_batch=None) -> "LayerTuner":
        """A shallow copy bound to another execution backend (shares the
        memo and the persistent cache — results are backend-invariant by
        the tested bit-exactness contract, so they interchange freely)."""
        if (backend in (None, self.backend)
                and verify_batch in (None, self.verify_batch)):
            return self
        import copy
        t = copy.copy(self)
        if backend is not None:
            t.backend = backend
        if verify_batch is not None:
            t.verify_batch = verify_batch
        return t

    @property
    def searches(self) -> int:
        """Cold searches this process (shared across with_backend copies)."""
        return self._stats["searches"]

    @property
    def hits(self) -> int:
        """Memo/disk hits (shared across with_backend copies)."""
        return self._stats["hits"]

    @property
    def verifications(self) -> int:
        """Programs run by winner verification (shared across copies)."""
        return self._stats["verifications"]

    @property
    def verify_seconds(self) -> float:
        """Wall-clock spent in winner verification (shared across copies)."""
        return self._stats["verify_seconds"]

    @property
    def tag(self) -> tuple:
        """Hashable identity for layer/segment cache keys (vta/network.py)."""
        return ("autotune", self.k_traffic, self.k_cycles, self.tune_alu)

    # -- fingerprinting ----------------------------------------------------
    def fingerprint(self, kind: str, wl: ConvWorkload, hw: VTAConfig, *,
                    post_op: str, bias: bool, prefer_db: bool,
                    dedup_loads: bool, fused: bool = False) -> str:
        from repro_torch.core.dse import ENGINE_VERSION
        ident = {"v": ENGINE_VERSION, "config": json.loads(hw.to_json()),
                 "kind": kind, "wl": asdict(replace(wl, name="")),
                 "post_op": post_op, "bias": bias, "prefer_db": prefer_db,
                 "dedup_loads": dedup_loads, "fused": fused,
                 "search": [self.k_traffic, self.k_cycles, self.tune_alu]}
        blob = json.dumps(ident, sort_keys=True).encode()
        return hashlib.sha256(blob).hexdigest()

    def _lookup(self, key: str) -> Optional[TuneResult]:
        hit = self._memo.get(key)
        if hit is not None:
            self._stats["hits"] += 1
            return hit
        if self.cache is not None and self.mode == "cached":
            rec = self.cache.get(key)
            if rec is not None:
                tr = TuneResult.from_record(rec)
                self._memo[key] = tr
                self._stats["hits"] += 1
                return tr
        return None

    def _commit(self, key: str, tr: TuneResult) -> TuneResult:
        self._memo[key] = tr
        if self.cache is not None:
            self.cache.put(key, tr.to_record())
        return tr

    # -- staged candidate scheduling (shared across cost variants) ---------
    @staticmethod
    def _rebuild_raises(build, validate: bool = True):
        """A cached-failure hit must surface the *exact* per-variant
        exception (messages can embed this config's repr): re-run the
        builder — it throws its cheap failing prefix — and propagate."""
        sched = build()
        if validate:
            sched.program.validate_encoding()
        raise RuntimeError(
            "cached schedule failure did not reproduce")   # pragma: no cover

    def _score_entry(self, skey, build, hw):
        """(cycles, program) of one candidate via the shared ScheduleStore;
        schedule + encode + tsim structural pass are paid once per
        geometry, the replayed cycles are bit-identical to ``run_tsim``."""
        ent = self.schedules.entry(skey, build, hw, validate=True)
        with stage("tsim_cost"):
            cycles = ent.cost_model.cost(hw).total_cycles
        return cycles, ent.program

    # -- search loops ------------------------------------------------------
    def _pick(self, scored: list, kind: str, heuristic_cycles: int,
              pruned: int, verify_fn) -> TuneResult:
        """``scored``: [(cycles, tile, program)] in deterministic order with
        the heuristic first. Winner = min cycles (ties to earlier rank),
        demoted if fsim disagrees with numpy — the heuristic entry is backed
        by the tier-1 suite, so the fallback chain always terminates."""
        order = sorted(range(len(scored)), key=lambda i: (scored[i][0], i))
        last_err: Optional[str] = None
        for i in order:
            cycles, tile, prog = scored[i]
            if self.verify:
                # programs shared via the ScheduleStore carry their verify
                # verdict across cost variants (verification data varies by
                # fingerprint, but bit-exactness is a program property)
                memo = self._verify_memo if self.schedules is not None \
                    else None
                hit = memo.get(id(prog)) if memo is not None else None
                if hit is not None and hit[0] is prog:
                    ok = hit[1]
                else:
                    t0 = time.perf_counter()
                    self._stats["verifications"] += 1
                    with stage("fsim_verify"):
                        ok = verify_fn(prog)
                    self._stats["verify_seconds"] += time.perf_counter() - t0
                    if memo is not None:
                        memo[id(prog)] = (prog, ok)
                if not ok:
                    last_err = f"fsim mismatch for {kind} tile {tile}"
                    continue
            if isinstance(tile, Tiling):
                # structural fields only: a tile served from the cache must
                # compare equal to a freshly searched one
                tile = Tiling(tile.tb_o, tile.th_o, tile.tw_o, tile.tco_o,
                              tile.tci_o, tile.oc_n, tile.h_n)
            return TuneResult(kind=kind, tile=tile, cycles=cycles,
                              heuristic_cycles=heuristic_cycles,
                              candidates=len(scored), pruned=pruned,
                              verified=self.verify)
        raise RuntimeError(f"autotune: every candidate failed verification "
                           f"({last_err})")

    def tune_conv(self, wl: ConvWorkload, hw: VTAConfig, *,
                  post_op: str = "clip_shift", bias: bool = False,
                  prefer_db: bool = True,
                  dedup_loads: bool = False) -> TuneResult:
        """Search tile shapes for a conv/dense layer (padded ``wl``)."""
        kind = "conv"
        key = self.fingerprint(kind, wl, hw, post_op=post_op, bias=bias,
                               prefer_db=prefer_db, dedup_loads=dedup_loads)
        hit = self._lookup(key)
        if hit is not None:
            return hit
        self._stats["searches"] += 1
        with stage("autotune"):
            heur = heuristic_conv_tiling(wl, hw, prefer_db=prefer_db)
            cands = [heur] + [t for t in vta_tile_candidates(
                wl, hw, k_traffic=self.k_traffic, k_cycles=self.k_cycles)
                if (t.tb_o, t.th_o, t.tw_o, t.tco_o, t.tci_o, t.oc_n, t.h_n)
                != (heur.tb_o, heur.th_o, heur.tw_o, heur.tco_o, heur.tci_o,
                    heur.oc_n, heur.h_n)]
            wl_id = replace(wl, name="")
            sk = hw.schedule_key()
            scored, pruned = [], 0
            for t in cands:
                def build(t=t):
                    return schedule_conv(wl, t, hw, post_op=post_op,
                                         dedup_loads=dedup_loads, bias=bias)
                if self.schedules is not None:
                    skey = conv_key(wl_id, post_op, bias, dedup_loads, sk,
                                    t, True)
                    try:
                        cycles, prog = self._score_entry(skey, build, hw)
                    except KnownScheduleFailure as kf:
                        if t is heur or kf.exc_type == "RuntimeError":
                            self._rebuild_raises(build)
                        pruned += 1
                        continue
                    except (AssertionError, ValueError):
                        if t is heur:  # the untuned path would fail identically
                            raise
                        pruned += 1    # scheduler/uop/encoder capacity pruning
                        continue
                    scored.append((cycles, t, prog))
                    continue
                try:
                    sched = build()
                    sched.program.validate_encoding()
                except (AssertionError, ValueError):
                    if t is heur:       # the untuned path would fail identically
                        raise
                    pruned += 1        # scheduler/uop/encoder capacity pruning
                    continue
                with stage("tsim_cost"):
                    cycles = run_tsim(sched.program, hw).total_cycles
                scored.append((cycles, t, sched.program))
        tr = self._pick(
            scored, kind, scored[0][0], pruned,
            lambda prog: _verify_conv(prog, wl, hw, post_op=post_op,
                                      bias=bias, fingerprint=key,
                                      backend=self.backend,
                                      batch=self.verify_batch))
        return self._commit(key, tr)

    def tune_alu_layer(self, kind: str, wl: ConvWorkload, hw: VTAConfig, *,
                       post_op: str = "relu_shift") -> TuneResult:
        """Search spatial tiles for an ALU-lowered layer (depthwise/pool)."""
        key = self.fingerprint(kind, wl, hw, post_op=post_op, bias=False,
                               prefer_db=True, dedup_loads=False)
        hit = self._lookup(key)
        if hit is not None:
            return hit
        self._stats["searches"] += 1

        def build(tile):
            if kind == "depthwise":
                return schedule_depthwise(wl, hw, post_op=post_op, tile=tile)
            return schedule_pool(wl, hw, mode=kind[:3], tile=tile)

        with stage("autotune"):
            wl_id = replace(wl, name="")
            sk = hw.schedule_key()
            if self.schedules is not None:
                # the default (untuned) build is unvalidated in the direct
                # path too; its failure must propagate with the real message
                try:
                    ent = self.schedules.entry(
                        alu_key(kind, wl_id, post_op, sk, None, False),
                        lambda: build(None), hw)
                except KnownScheduleFailure:
                    self._rebuild_raises(lambda: build(None), validate=False)
                d_t = ent.tiling
                d_tile = (-(-wl.oh // d_t.th_o), -(-wl.ow // d_t.tw_o))
                with stage("tsim_cost"):
                    d_cycles = ent.cost_model.cost(hw).total_cycles
                scored = [(d_cycles, d_tile, ent.program)]
            else:
                default = build(None)  # the greedy capacity-maximal tile
                # record the default's concrete (th_i, tw_i) so the result
                # is self-describing even when the default wins
                d_t = default.tiling
                d_tile = (-(-wl.oh // d_t.th_o), -(-wl.ow // d_t.tw_o))
                with stage("tsim_cost"):
                    d_cycles = run_tsim(default.program, hw).total_cycles
                scored = [(d_cycles, d_tile, default.program)]
            pruned = 0

            def n_tiles(tile):
                return -(-wl.oh // tile[0]) * -(-wl.ow // tile[1])

            # schedule-time budget: tiles much smaller than the default
            # explode the task count (cost to search AND per-task latency
            # overhead to run) without ever winning — skip anything past 4x
            # the default's spatial tile count
            budget = max(4 * n_tiles(d_tile), 16)
            for tile in vta_alu_tile_candidates(wl.oh, wl.ow):
                if tile == d_tile or n_tiles(tile) > budget:
                    continue
                if self.schedules is not None:
                    skey = alu_key(kind, wl_id, post_op, sk, tile, True)
                    try:
                        cycles, prog = self._score_entry(
                            skey, lambda tile=tile: build(tile), hw)
                    except KnownScheduleFailure as kf:
                        if kf.exc_type == "RuntimeError":
                            self._rebuild_raises(
                                lambda tile=tile: build(tile))
                        pruned += 1
                        continue
                    except (AssertionError, ValueError):
                        pruned += 1
                        continue
                    scored.append((cycles, tile, prog))
                    continue
                try:
                    sched = build(tile)
                    sched.program.validate_encoding()
                except (AssertionError, ValueError):
                    pruned += 1
                    continue
                with stage("tsim_cost"):
                    cycles = run_tsim(sched.program, hw).total_cycles
                scored.append((cycles, tile, sched.program))
        tr = self._pick(
            scored, kind, scored[0][0], pruned,
            lambda prog: _verify_alu(prog, wl, hw, kind=kind,
                                     post_op=post_op, fingerprint=key,
                                     backend=self.backend,
                                     batch=self.verify_batch))
        return self._commit(key, tr)

    def tune_fused_conv(self, wl: ConvWorkload, hw: VTAConfig, *,
                        post_op: str, bias: bool, prefer_db: bool,
                        dedup_loads: bool, skip_name: str,
                        tensors: dict) -> Optional[TuneResult]:
        """Search the head tiling of a fused conv→add→clip segment
        (vta/compiler.py). Candidates are scored on the *actual* fused
        program — the one the segment will run — so the winner is never
        worse than the compiler's ``_fused_tiling`` heuristic, which is
        always candidate #0. Returns None when nothing schedules (the
        compiler then falls back to its own plan and demotion path)."""
        kind = "conv+add"
        key = self.fingerprint(kind, wl, hw, post_op=post_op, bias=bias,
                               prefer_db=prefer_db, dedup_loads=dedup_loads,
                               fused=True)
        hit = self._lookup(key)
        if hit is not None:
            return hit
        self._stats["searches"] += 1
        with stage("autotune"):
            shrunk = replace(hw, log_acc_buff=hw.log_acc_buff - 1)
            try:
                heur = heuristic_conv_tiling(wl, shrunk, prefer_db=prefer_db)
            except RuntimeError:
                return None
            cands = [heur] + [t for t in vta_tile_candidates(
                wl, shrunk, k_traffic=self.k_traffic, k_cycles=self.k_cycles)
                if (t.tb_o, t.th_o, t.tw_o, t.tco_o, t.tci_o, t.oc_n, t.h_n)
                != (heur.tb_o, heur.th_o, heur.tw_o, heur.tco_o, heur.tci_o,
                    heur.oc_n, heur.h_n)]

            def build(t) -> Program:
                alloc = UopAllocator(hw)
                tasks: list = []
                n_ctx = emit_conv_tasks(wl, t, hw, alloc, tasks,
                                        post_op=post_op,
                                        dedup_loads=dedup_loads, bias=bias,
                                        tensors=tensors, fuse_add=skip_name)
                prog = finalize(tasks, hw, n_ctx=n_ctx)
                prog.uop_mem = alloc.mem
                return prog

            wl_id = replace(wl, name="")
            sk = hw.schedule_key()
            scored, pruned = [], 0
            for t in cands:
                if self.schedules is not None:
                    def build_sched(t=t):
                        # adapt the bare-Program builder to the store's
                        # Schedule-like contract
                        return SimpleNamespace(program=build(t), tiling=t,
                                               dram_bytes={})
                    skey = fused_conv_key(wl_id, post_op, bias, dedup_loads,
                                          sk, skip_name, tensors, t, True)
                    try:
                        cycles, prog = self._score_entry(skey, build_sched,
                                                         hw)
                    except KnownScheduleFailure as kf:
                        if kf.exc_type == "RuntimeError":
                            self._rebuild_raises(build_sched)
                        if t is heur:
                            # the compiler's own _fused_tiling would fail
                            # the same way: let it fall back
                            return None
                        pruned += 1
                        continue
                    except (AssertionError, ValueError):
                        if t is heur:
                            return None
                        pruned += 1
                        continue
                    scored.append((cycles, t, prog))
                    continue
                try:
                    prog = build(t)
                    prog.validate_encoding()
                except (AssertionError, ValueError):
                    if t is heur:
                        # the compiler's own _fused_tiling would fail the
                        # same way: report "no tunable plan" and let it
                        # fall back
                        return None
                    pruned += 1
                    continue
                with stage("tsim_cost"):
                    cycles = run_tsim(prog, hw).total_cycles
                scored.append((cycles, t, prog))
        if not scored:
            return None
        names = {"inp": tensors["inp"], "wgt": tensors["wgt"],
                 "bias": tensors["bias"], "out": tensors["out"],
                 "skip": skip_name}
        try:
            tr = self._pick(
                scored, kind, scored[0][0], pruned,
                lambda prog: _verify_conv(prog, wl, hw, post_op=post_op,
                                          bias=bias, fingerprint=key,
                                          skip_tensor=names,
                                          backend=self.backend,
                                          batch=self.verify_batch))
        except RuntimeError:
            # every candidate failed fsim verification: refuse to tune this
            # head (compiler falls back to its own plan + demotion) instead
            # of poisoning the whole network evaluation
            return None
        return self._commit(key, tr)

    # -- the scheduler-facing entry point ----------------------------------
    def plan(self, kind: str, wl: ConvWorkload, hw: VTAConfig, *,
             post_op: str, bias: bool = False, prefer_db: bool = True,
             dedup_loads: bool = False) -> Optional[TuneResult]:
        """Tile plan for one layer, or None when the kind is not tuned."""
        if kind not in TUNABLE_KINDS:
            return None
        if kind in ("conv", "dense"):
            return self.tune_conv(wl, hw, post_op=post_op, bias=bias,
                                  prefer_db=prefer_db,
                                  dedup_loads=dedup_loads)
        if self.tune_alu and kind in ("depthwise", "maxpool", "avgpool"):
            return self.tune_alu_layer(kind, wl, hw, post_op=post_op)
        return None


def make_tuner(mode: str = "cached", cache_dir: Optional[str] = None,
               **kw) -> Optional[LayerTuner]:
    """``LayerTuner`` factory honoring the ``tune`` knob; ``"off"`` → None."""
    if mode in (None, "off", False):
        return None
    from repro_torch.core.dse import ResultCache
    cache = ResultCache(cache_dir) if cache_dir else None
    return LayerTuner(mode=mode, cache=cache, **kw)
