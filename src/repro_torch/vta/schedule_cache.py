"""Staged schedule sharing keyed on config *projections* (DSE fast path).

Scheduling, lowering and instruction encoding read only the geometry half
of a ``VTAConfig`` (``VTAConfig.SCHEDULE_FIELDS``); the cycle cost reads
only the other half (``COST_FIELDS``). The DSE grid multiplies 4 memory
widths x 2 pipelining settings onto every geometry, so without sharing,
8 sweep points re-schedule, re-encode and re-simulate byte-identical
programs from scratch.

``ScheduleStore`` is the in-process (LRU-bounded) map from a *build
identity* — layer shape + schedule knobs + ``hw.schedule_key()`` + the
concrete tile — to a ``ScheduleEntry`` holding the lowered program, its
tiling/DRAM accounting, and a ``TsimCostModel`` (vta/tsim.py) that replays
cycle costs per cost variant bit-identically to ``run_tsim``. Failed
builds are remembered too (``ScheduleFailure``): the next cost variant
learns the geometry is infeasible without re-scheduling — consumers that
must surface the *exact* per-variant exception text (it may embed the
full config repr) rebuild on a failure hit, which only pays the cheap
throwing prefix of the schedule.

An optional ``backing`` object (``core/dse.ScheduleBlobCache``) persists
entries on disk so separate sweep processes and repeat runs share
schedules; only entries flagged ``persist=True`` (final per-layer builds,
not every autotune candidate) are written through.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable

from repro_torch.core.stages import stage
from repro_torch.vta.isa import VTAConfig
from repro_torch.vta.tsim import TsimCostModel


@dataclass
class ScheduleEntry:
    """One shared scheduled+lowered program and its replayable cost model."""
    program: object
    tiling: object
    dram_bytes: dict
    cost_model: TsimCostModel
    validated: bool = False
    uop_flushes: int = 0


@dataclass
class ScheduleFailure:
    """A build identity known to fail (geometry-infeasible)."""
    exc_type: str                 # AssertionError | ValueError | RuntimeError


class KnownScheduleFailure(Exception):
    """Raised on a cache hit of a failing build identity.

    Carries only the exception *type* of the original failure: the
    original message may embed the full config repr of the variant that
    first built it, so consumers that propagate messages (layer
    evaluation) re-run the builder to regenerate the exact per-variant
    exception; consumers that only count (candidate pruning) don't.
    """

    def __init__(self, exc_type: str):
        super().__init__(exc_type)
        self.exc_type = exc_type


_FAILURES = (AssertionError, RuntimeError, ValueError)


class ScheduleStore:
    """LRU-bounded map: build identity -> ScheduleEntry | ScheduleFailure."""

    def __init__(self, maxsize: int = 4096, backing=None):
        # maxsize must cover one geometry's full autotune candidate set
        # (layers x ~50 tiles): smaller stores thrash — each cost variant
        # re-schedules what the previous variant just evicted
        self.maxsize = maxsize
        self.backing = backing          # ScheduleBlobCache-like or None
        self._lru: OrderedDict = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.disk_hits = 0

    def __len__(self) -> int:
        return len(self._lru)

    def stats(self) -> dict:
        return {"len": len(self._lru), "maxsize": self.maxsize,
                "hits": self.hits, "misses": self.misses,
                "evictions": self.evictions, "disk_hits": self.disk_hits}

    # -- LRU ---------------------------------------------------------------
    def _get(self, key):
        ent = self._lru.get(key)
        if ent is not None:
            self._lru.move_to_end(key)
        return ent

    def _put(self, key, ent) -> None:
        self._lru[key] = ent
        self._lru.move_to_end(key)
        while len(self._lru) > self.maxsize:
            self._lru.popitem(last=False)
            self.evictions += 1

    # -- the one entry point ----------------------------------------------
    def entry(self, key, build: Callable[[], object], hw: VTAConfig, *,
              validate: bool = False, persist: bool = False) -> ScheduleEntry:
        """Scheduled entry for ``key``, building (and caching) on miss.

        ``build()`` returns a ``Schedule``-like object (``.program``,
        ``.tiling``, ``.dram_bytes``, ``.uop_flushes``). ``key`` must
        fully determine the built program — include ``hw.schedule_key()``
        and every build knob, and include ``validate``: validation raises
        on encoder overflow, so validated/unvalidated builds of one
        geometry are distinct identities.

        On a failing build the original exception propagates (and the
        failure is cached); a later hit of that identity raises
        ``KnownScheduleFailure`` instead.
        """
        ent = self._get(key)
        if ent is None and self.backing is not None:
            ent = self.backing.get(key)
            if ent is not None:
                self.disk_hits += 1
                self._put(key, ent)
        if ent is not None:
            self.hits += 1
            if isinstance(ent, ScheduleFailure):
                raise KnownScheduleFailure(ent.exc_type)
            return ent
        self.misses += 1
        try:
            with stage("schedule"):
                sched = build()
                if validate:
                    sched.program.validate_encoding()
                model = TsimCostModel(sched.program, hw)
        except _FAILURES as e:
            fail = ScheduleFailure(type(e).__name__)
            self._put(key, fail)
            if persist and self.backing is not None:
                self.backing.put(key, fail)
            raise
        ent = ScheduleEntry(program=sched.program, tiling=sched.tiling,
                            dram_bytes=dict(sched.dram_bytes),
                            cost_model=model, validated=validate,
                            uop_flushes=getattr(sched, "uop_flushes", 0))
        self._put(key, ent)
        if persist and self.backing is not None:
            self.backing.put(key, ent)
        return ent


# ---------------------------------------------------------------------------
# Build identities (keys) for the layer kinds the stack schedules
# ---------------------------------------------------------------------------
def conv_key(wl_id, post_op: str, bias: bool, dedup_loads: bool,
             sk: tuple, tile, validate: bool) -> tuple:
    t = (tile.tb_o, tile.th_o, tile.tw_o, tile.tco_o, tile.tci_o,
         tile.oc_n, tile.h_n)
    return ("conv", wl_id, post_op, bias, dedup_loads, sk, t, validate)


def alu_key(kind: str, wl_id, post_op: str, sk: tuple, tile,
            validate: bool) -> tuple:
    return ("alu", kind, wl_id, post_op, sk,
            None if tile is None else tuple(tile), validate)


def add_key(wl_id, sk: tuple, validate: bool) -> tuple:
    return ("add", wl_id, sk, validate)


def fused_conv_key(wl_id, post_op: str, bias: bool, dedup_loads: bool,
                   sk: tuple, skip_name: str, tensors: dict, tile,
                   validate: bool) -> tuple:
    t = (tile.tb_o, tile.th_o, tile.tw_o, tile.tco_o, tile.tci_o,
         tile.oc_n, tile.h_n)
    return ("fused", wl_id, post_op, bias, dedup_loads, sk, skip_name,
            tuple(sorted(tensors.items())), t, validate)
