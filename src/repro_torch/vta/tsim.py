"""Cycle-level performance model of the VTA machine ("tsim" role).

Marked-graph simulation of the three decoupled processes (load / compute /
store) synchronized by the 4 dependency-token queues (paper Fig 1), with:

  * GEMM initiation interval `gemm_ii` (4 unpipelined -> 1 pipelined, §IV.A.1)
    + pipeline-flush depth per instruction;
  * ALU II (4/5 unpipelined; 1 imm / 2 two-operand pipelined, §IV.A.2 — the
    accumulator register file allows one read per cycle);
  * a shared memory engine with `mem_width_bytes`/cycle throughput and
    `dram_latency` to first beat, with in-flight pipelining across requests
    (the multiple-outstanding-request VME of §IV.A.3 / Fig 6);
  * UOP/ACC loads issued from the compute queue (as on real VTA).

Outputs total cycles + per-process busy intervals — the data behind the
paper's process-utilization visualizations (Fig 3-4) and roofline points.
"""
from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass, field

import numpy as np

from repro_torch.vta.isa import (AluInsn, Buffer, GemmInsn, LoadInsn,
                                 StoreInsn, VTAConfig)
from repro_torch.vta.lowering import insn_dram_bytes, lower_ranges
from repro_torch.vta.runtime import Program

DECODE_OVERHEAD = 4   # fetch/decode cycles per instruction
CMD_OVERHEAD = 4      # DMA command setup per load/store


class HazardError(RuntimeError):
    """A scratchpad RAW/WAW hazard the dependency tokens do not close."""


@dataclass
class TsimResult:
    total_cycles: int
    busy: dict                      # queue -> [(start, end, kind)]
    counts: dict
    dram_bytes: int
    stalls: dict = field(default_factory=dict)      # token-wait cycles/queue
    mem_wait: dict = field(default_factory=dict)    # memory-engine backpressure
                                                    # (issue - ready) per queue

    def utilization(self) -> dict:
        out = {}
        for q, spans in self.busy.items():
            t = sum(e - s for s, e, _ in spans)
            out[q] = t / max(1, self.total_cycles)
        return out

    def busy_by_kind(self) -> dict:
        out: dict = {}
        for q, spans in self.busy.items():
            for s, e, kind in spans:
                out[kind] = out.get(kind, 0) + (e - s)
        return out


def _alu_ii(hw: VTAConfig, insn: AluInsn) -> int:
    """Initiation interval of one ALU iteration.

    The acc register file has one read port, so the II is bounded by the
    reads each iteration needs (``AluInsn.acc_reads``): dst (unless the
    ``overwrite`` bit write-throughs), src, and a MAC's second source.

      * unpipelined (as published, alu_ii >= 4): every read serializes —
        alu_ii for one read, +1 per extra read (the old 4/5 split);
      * pipelined: II = max(alu_ii, reads). Multi-uop macro sweeps latch a
        MAC's loop-invariant src2 once per uop, so it costs no per-iteration
        read; write-through ops (overwrite) reach the alu_ii floor.
    """
    if hw.alu_ii >= 4:                       # unpipelined (as published)
        return hw.alu_ii + max(0, insn.acc_reads(latched=False) - 1)
    return max(hw.alu_ii, 1, insn.acc_reads(latched=True))


def insn_cycles(insn, hw: VTAConfig) -> int:
    """Execution occupancy of the owning module (memory time modelled apart)."""
    if isinstance(insn, GemmInsn):
        return insn.iterations() * hw.gemm_ii + hw.gemm_depth + DECODE_OVERHEAD
    if isinstance(insn, AluInsn):
        return insn.iterations() * _alu_ii(hw, insn) \
            + hw.gemm_depth + DECODE_OVERHEAD
    if isinstance(insn, (LoadInsn, StoreInsn)):
        return CMD_OVERHEAD
    return DECODE_OVERHEAD


def _ranges_conflict(a: tuple, b: tuple) -> bool:
    """Do two (buffer, lo, hi) scratchpad ranges overlap?"""
    return a[0] == b[0] and a[1] < b[2] and b[1] < a[2]


def _benign_reload(prog: Program, touches: list, wi: int, yi: int,
                   w: tuple, r: tuple) -> bool:
    """A concurrent clobber is value-identical (and therefore not a data
    hazard) when the writer is a LoadInsn re-fetching exactly the DRAM slice
    that currently backs the overlapped region — e.g. merged dedup units
    re-loading the same weight chunks into the shared full-buffer slots."""
    writer = prog.order[wi]
    if not isinstance(writer, LoadInsn):
        return False
    sect = (w[0], max(w[1], r[1]), min(w[2], r[2]))
    for j in range(yi - 1, -1, -1):     # program-order backing write
        for bw in touches[j].writes:
            if _ranges_conflict(bw, sect):
                backing = prog.order[j]
                return (isinstance(backing, LoadInsn)
                        and backing.buffer == writer.buffer
                        and backing.sram_base == writer.sram_base
                        and getattr(backing, "meta", None)
                        == getattr(writer, "meta", None))
    return False


def _check_hazards(prog: Program, hw: VTAConfig, spans: list) -> None:
    """Scratchpad RAW/WAW checking over the lowered ranges (vta/lowering.py).

    Two instructions from *different* queues whose simulated busy intervals
    overlap run concurrently — the dependency tokens impose no order between
    them — so a write range of one overlapping a read or write range of the
    other is a race the hardware could lose. Same-queue instructions
    serialize and are never flagged; a load that re-fetches exactly the
    bytes already backing the overlapped region is value-identical and
    skipped (``_benign_reload``).
    """
    touches = lower_ranges(prog, hw)
    active: list = []                   # (end, queue, order_idx)
    for start, end, q, i in sorted(spans):
        active = [a for a in active if a[0] > start]
        for aend, aq, ai in active:
            if aq == q:
                continue
            for xi, yi in ((i, ai), (ai, i)):
                for w in touches[xi].writes:
                    for r in touches[yi].reads + touches[yi].writes:
                        if not _ranges_conflict(w, r):
                            continue
                        if _benign_reload(prog, touches, xi, yi, w, r):
                            continue
                        kind = "WAW" if r in touches[yi].writes else "RAW"
                        raise HazardError(
                            f"{kind} hazard on {w[0].name} scratchpad "
                            f"[{w[1]}, {w[2]}): insn {xi} "
                            f"({type(prog.order[xi]).__name__}) writes "
                            f"while insn {yi} "
                            f"({type(prog.order[yi]).__name__}) touches "
                            f"[{r[1]}, {r[2]}) concurrently")
        active.append((end, q, i))


def _pops_of(insn, q: str) -> list:
    """Dependency-token FIFOs this instruction pops (paper Fig 1 edges)."""
    out = []
    if q == "load" and insn.pop_next:
        out.append(("compute", "load"))
    if q == "compute":
        if insn.pop_prev:
            out.append(("load", "compute"))
        if insn.pop_next:
            out.append(("store", "compute"))
    if q == "store" and insn.pop_prev:
        out.append(("compute", "store"))
    return out


def _pushes_of(insn, q: str) -> list:
    out = []
    if q == "load" and insn.push_next:
        out.append(("load", "compute"))
    if q == "compute":
        if insn.push_prev:
            out.append(("compute", "load"))
        if insn.push_next:
            out.append(("compute", "store"))
    if q == "store" and insn.push_prev:
        out.append(("store", "compute"))
    return out


def run_tsim(prog: Program, hw: VTAConfig, *, check_hazards: bool = False) -> TsimResult:
    queues = prog.queues
    if check_hazards:
        pos = {id(insn): i for i, insn in enumerate(prog.order)}
        spans = []                      # (start, end, queue, order_idx)
    names = ("load", "compute", "store")
    idx = {q: 0 for q in names}
    qtime = {q: 0 for q in names}
    busy = {q: [] for q in names}
    tokens: dict = {("load", "compute"): deque(), ("compute", "load"): deque(),
                    ("compute", "store"): deque(), ("store", "compute"): deque()}
    engine_free = 0
    stall_cycles = {q: 0 for q in names}
    mem_wait = {q: 0 for q in names}
    total_dram = 0
    pops_of, pushes_of = _pops_of, _pushes_of

    progress = True
    while progress:
        progress = False
        for q in names:
            while idx[q] < len(queues[q]):
                insn = queues[q][idx[q]]
                pops = pops_of(insn, q)
                if any(not tokens[p] for p in pops):
                    break
                ready = qtime[q]
                for p in pops:
                    ready = max(ready, tokens[p].popleft())
                start = ready
                if isinstance(insn, StoreInsn) and insn.on_chip:
                    # scratchpad spill: narrowed tiles move on-chip at the
                    # memory-interface width, but never touch the DRAM
                    # engine (no first-beat latency, no bus occupancy)
                    onchip = insn.tiles() * hw.out_tile_bytes
                    end = start + math.ceil(onchip / hw.mem_width_bytes) \
                        + CMD_OVERHEAD
                    kind = "spill"
                elif isinstance(insn, (LoadInsn, StoreInsn)):
                    nonloc_bytes = insn_dram_bytes(insn, hw)
                    occ = math.ceil(nonloc_bytes / hw.mem_width_bytes)
                    issue = max(start, engine_free)
                    mem_wait[q] += issue - start    # engine backpressure only
                    engine_free = issue + occ
                    end = issue + hw.dram_latency + occ + CMD_OVERHEAD
                    total_dram += nonloc_bytes
                    kind = ("uop_load" if getattr(insn, "buffer", None) == Buffer.UOP
                            else "acc_load" if getattr(insn, "buffer", None) == Buffer.ACC
                            and isinstance(insn, LoadInsn)
                            else "store" if isinstance(insn, StoreInsn) else "load")
                else:
                    end = start + insn_cycles(insn, hw)
                    kind = ("gemm" if isinstance(insn, GemmInsn)
                            else "alu" if isinstance(insn, AluInsn) else "ctrl")
                stall_cycles[q] += max(0, start - qtime[q])
                if check_hazards:
                    spans.append((start, end, q, pos[id(insn)]))
                if end > start:
                    busy[q].append((start, end, kind))
                qtime[q] = end
                for p in pushes_of(insn, q):
                    tokens[p].append(end)
                idx[q] += 1
                progress = True
    for q in names:
        if idx[q] < len(queues[q]):
            raise RuntimeError(
                f"tsim deadlock: queue {q} stuck at insn {idx[q]}/{len(queues[q])} "
                f"({type(queues[q][idx[q]]).__name__})")
    if check_hazards:
        _check_hazards(prog, hw, spans)
    total = max(qtime.values())
    return TsimResult(total_cycles=total, busy=busy, counts=prog.counts(),
                      dram_bytes=total_dram, stalls=stall_cycles,
                      mem_wait=mem_wait)


# ---------------------------------------------------------------------------
# Two-phase costing: structural pass once per schedule, cheap replay per
# cost variant (DSE engine fast path — bit-identical to run_tsim)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class CostParams:
    """The VTAConfig projection run_tsim's timing depends on.

    Mirrors ``VTAConfig.COST_FIELDS``: two configs with equal CostParams
    cost any given program identically, whatever their geometry."""
    mem_width_bytes: int = 8
    dram_latency: int = 64
    gemm_ii: int = 4
    alu_ii: int = 4
    gemm_depth: int = 5
    max_inflight: int = 8

    @staticmethod
    def of(hw: VTAConfig) -> "CostParams":
        return CostParams(**{f: getattr(hw, f) for f in VTAConfig.COST_FIELDS})


_MEM, _SPILL, _GEMM, _ALU, _CTRL = range(5)
_QNAMES = ("load", "compute", "store")


class TsimCostModel:
    """Replayable costing of one lowered program across cost variants.

    ``run_tsim``'s fixpoint advances an instruction exactly when every
    dependency token it pops is *available* — a boolean that does not
    depend on timestamps — so the execution order, the FIFO matching of
    each pop to its producing push, and the memory-engine serialization
    order are all invariant under the cost parameters. The constructor
    runs that fixpoint once (structurally, recording matched producer
    event indices and the static per-instruction cost inputs as numpy
    arrays); ``cost()`` replays the max-plus recurrence for one
    ``CostParams``, reproducing ``run_tsim``'s TsimResult bit-for-bit at
    a fraction of the price. ``cost_many()`` prices K variants of the
    same program in one call.

    ``hw`` contributes only its schedule projection (geometry: DRAM byte
    accounting, spill tile sizes) — any config with the same
    ``schedule_key()`` builds the same model.
    """

    def __init__(self, prog: Program, hw: VTAConfig):
        self._prog = prog
        self._hw = hw
        queues = prog.queues
        pos = {id(insn): i for i, insn in enumerate(prog.order)}
        idx = {q: 0 for q in _QNAMES}
        tokens: dict = {("load", "compute"): deque(),
                        ("compute", "load"): deque(),
                        ("compute", "store"): deque(),
                        ("store", "compute"): deque()}
        qof = {q: i for i, q in enumerate(_QNAMES)}
        ev_q: list = []        # queue index per event
        ev_code: list = []     # _MEM/_SPILL/_GEMM/_ALU/_CTRL
        ev_kind: list = []     # busy-span kind string
        ev_prod: list = []     # tuple of producer event indices (popped tokens)
        ev_ord: list = []      # index into prog.order (hazard spans)
        a_v: list = []         # bytes (mem/spill) or iterations (gemm/alu)
        b_v: list = []         # alu: acc reads, latched
        c_v: list = []         # alu: acc reads, unlatched
        total_dram = 0
        progress = True
        while progress:
            progress = False
            for q in _QNAMES:
                while idx[q] < len(queues[q]):
                    insn = queues[q][idx[q]]
                    pops = _pops_of(insn, q)
                    if any(not tokens[p] for p in pops):
                        break
                    prods = tuple(tokens[p].popleft() for p in pops)
                    a = b = c = 0
                    if isinstance(insn, StoreInsn) and insn.on_chip:
                        code, kind = _SPILL, "spill"
                        a = insn.tiles() * hw.out_tile_bytes
                    elif isinstance(insn, (LoadInsn, StoreInsn)):
                        code = _MEM
                        a = insn_dram_bytes(insn, hw)
                        total_dram += a
                        kind = ("uop_load" if getattr(insn, "buffer", None) == Buffer.UOP
                                else "acc_load" if getattr(insn, "buffer", None) == Buffer.ACC
                                and isinstance(insn, LoadInsn)
                                else "store" if isinstance(insn, StoreInsn) else "load")
                    elif isinstance(insn, GemmInsn):
                        code, kind = _GEMM, "gemm"
                        a = insn.iterations()
                    elif isinstance(insn, AluInsn):
                        code, kind = _ALU, "alu"
                        a = insn.iterations()
                        b = insn.acc_reads(latched=True)
                        c = insn.acc_reads(latched=False)
                    else:
                        code, kind = _CTRL, "ctrl"
                    e = len(ev_q)
                    ev_q.append(qof[q])
                    ev_code.append(code)
                    ev_kind.append(kind)
                    ev_prod.append(prods)
                    ev_ord.append(pos[id(insn)])
                    a_v.append(a)
                    b_v.append(b)
                    c_v.append(c)
                    for p in _pushes_of(insn, q):
                        tokens[p].append(e)
                    idx[q] += 1
                    progress = True
        for q in _QNAMES:
            if idx[q] < len(queues[q]):
                raise RuntimeError(
                    f"tsim deadlock: queue {q} stuck at insn {idx[q]}/{len(queues[q])} "
                    f"({type(queues[q][idx[q]]).__name__})")
        self._n = len(ev_q)
        self._qi = ev_q
        self._codes = ev_code
        self._kinds = ev_kind
        self._prods = ev_prod
        self._ords = ev_ord
        self._a = np.asarray(a_v, dtype=np.int64)
        self._b = np.asarray(b_v, dtype=np.int64)
        self._c = np.asarray(c_v, dtype=np.int64)
        self._code_arr = np.asarray(ev_code, dtype=np.int64)
        self._dram = total_dram

    # -- replay ------------------------------------------------------------
    def _durations(self, p: CostParams):
        """Per-event static durations for one variant (vectorized)."""
        a, code = self._a, self._code_arr
        dur = np.full(self._n, DECODE_OVERHEAD, dtype=np.int64)   # _CTRL
        m = code == _SPILL
        dur[m] = -(-a[m] // p.mem_width_bytes) + CMD_OVERHEAD
        m = code == _GEMM
        dur[m] = a[m] * p.gemm_ii + p.gemm_depth + DECODE_OVERHEAD
        m = code == _ALU
        if p.alu_ii >= 4:                # unpipelined (as published)
            ii = p.alu_ii + np.maximum(0, self._c[m] - 1)
        else:
            ii = np.maximum(np.maximum(p.alu_ii, 1), self._b[m])
        dur[m] = a[m] * ii + p.gemm_depth + DECODE_OVERHEAD
        m = code == _MEM
        occ = np.zeros(self._n, dtype=np.int64)
        occ[m] = -(-a[m] // p.mem_width_bytes)
        return dur.tolist(), occ.tolist()

    def cost(self, hw_or_params, *, check_hazards: bool = False) -> TsimResult:
        """One variant's TsimResult — bit-identical to ``run_tsim`` of the
        same program under a config with these cost parameters."""
        p = hw_or_params if isinstance(hw_or_params, CostParams) \
            else CostParams.of(hw_or_params)
        dur, occ = self._durations(p)
        n = self._n
        qi, codes, prods, kinds = self._qi, self._codes, self._prods, self._kinds
        latcmd = p.dram_latency + CMD_OVERHEAD
        qtime = [0, 0, 0]
        stalls = [0, 0, 0]
        mwait = [0, 0, 0]
        engine_free = 0
        end = [0] * n
        busy: tuple = ([], [], [])
        spans = [] if check_hazards else None
        for e in range(n):
            q = qi[e]
            ready = qtime[q]
            for pe in prods[e]:
                v = end[pe]
                if v > ready:
                    ready = v
            stalls[q] += ready - qtime[q]
            if codes[e] == _MEM:
                issue = engine_free if engine_free > ready else ready
                mwait[q] += issue - ready
                o = occ[e]
                engine_free = issue + o
                t = issue + latcmd + o
            else:
                t = ready + dur[e]
            if check_hazards:
                spans.append((ready, t, _QNAMES[q], self._ords[e]))
            if t > ready:
                busy[q].append((ready, t, kinds[e]))
            end[e] = t
            qtime[q] = t
        if check_hazards:
            hz_hw = hw_or_params if isinstance(hw_or_params, VTAConfig) \
                else self._hw
            _check_hazards(self._prog, hz_hw, spans)
        return TsimResult(
            total_cycles=max(qtime) if n else 0,
            busy={_QNAMES[i]: busy[i] for i in range(3)},
            counts=self._prog.counts(), dram_bytes=self._dram,
            stalls={_QNAMES[i]: stalls[i] for i in range(3)},
            mem_wait={_QNAMES[i]: mwait[i] for i in range(3)})

    def cost_many(self, variants) -> list[TsimResult]:
        """Cost K config variants of this program in one call."""
        return [self.cost(v) for v in variants]


def utilization_ascii(res: TsimResult, width: int = 100) -> str:
    """Process-utilization strip chart (paper Fig 3/4), ASCII rendition."""
    total = max(1, res.total_cycles)
    lines = []
    symbols = {"gemm": "G", "alu": "A", "load": "L", "store": "S",
               "uop_load": "u", "acc_load": "a", "ctrl": ".", "spill": "s"}
    for q in ("load", "compute", "store"):
        row = [" "] * width
        for s, e, kind in res.busy[q]:
            c0 = int(s / total * width)
            c1 = max(c0 + 1, int(e / total * width))
            for c in range(c0, min(c1, width)):
                row[c] = symbols.get(kind, "#")
        lines.append(f"{q:8s}|{''.join(row)}|")
    util = res.utilization()
    lines.append("util: " + "  ".join(f"{q}={util[q]*100:.0f}%" for q in util))
    return "\n".join(lines)
