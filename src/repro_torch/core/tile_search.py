"""Candidate tile search for the VTA autotuner (vta/autotune.py).

The single analytic argmin of ``core/tps`` is a *heuristic*: it minimizes
bytes, while real cycles also hinge on transfer granularity (DRAM latency
amortization), uop-load pressure on the compute queue and load/compute
overlap. So this module exposes the search *frontier* instead of one point:

  * ``rank_candidates``  — generic deterministic top-k by an arbitrary cost;
  * ``vta_tile_candidates`` — the VTA tiling space (paper Appendix A, via
    ``core/tps``) ranked per virtual-thread mode by BOTH analytic DRAM
    traffic and a coarse cycle estimate, deduplicated. Infeasible points
    (scratchpad/uop capacity) are pruned analytically here; the autotuner
    prunes the remainder against the scheduler's exact capacity asserts;
  * ``vta_alu_tile_candidates`` — spatial tiles of ALU-lowered layers.

A copy of the VTA half of the JAX package's ``core/tile_search.py``; its
TPU block sizing (VMEM budgets of Pallas tiles) has no counterpart here.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np


def rank_candidates(candidates: list, *, cost: Callable, k: int,
                    feasible: Optional[Callable] = None) -> list:
    """Deterministic top-``k`` of ``candidates`` by ``cost`` (ascending).

    Ties break on the candidate's own ordering key (its repr), so the result
    never depends on input order — a requirement for the autotuner's
    content-addressed cache (same key must always yield the same tile).
    """
    pool = [c for c in candidates if feasible is None or feasible(c)]
    return sorted(pool, key=lambda c: (cost(c), repr(c)))[:k]


def vta_est_cycles(wl, hw, t) -> float:
    """Coarse cycle estimate of one conv tiling: the roofline max of memory
    and compute time, plus per-task latency overhead (each outer iteration
    pays DRAM first-beat latency on its loads). Deliberately cheap — it only
    ranks candidates for exact tsim scoring, it never decides alone."""
    mem = t.cost_bytes / hw.mem_width_bytes
    comp = wl.macs / max(1, hw.macs) * hw.gemm_ii
    n_tasks = t.tb_o * t.th_o * t.tw_o * t.tco_o * t.tci_o
    return max(mem, comp) + n_tasks * 2 * hw.dram_latency


def vta_tile_candidates(wl, hw, *, k_traffic: int = 12,
                        k_cycles: int = 8) -> list:
    """Analytic seeding of the autotuner: the VTA tiling space (Appendix A),
    capacity-pruned, ranked *per virtual-thread mode* by (a) DRAM traffic and
    (b) estimated cycles, concatenated and deduplicated in rank order.

    Per-mode ranking matters: byte-optimal serial tilings crowd out every
    double-buffered candidate under a global sort, yet the double-buffered
    ones often win on overlap once tsim scores them (and vice versa on
    memory-starved configs).
    """
    from repro_torch.core.tps import Tiling, _costs, _divisors
    BI, BO, BV = hw.block_in, hw.block_out, hw.batch
    fi = wl.fi if not wl.depthwise else BI
    di = max(1, fi // BI)
    do = max(1, wl.fo // BO)
    b_outer = max(1, wl.b // BV)
    grids = np.meshgrid(_divisors(b_outer), _divisors(wl.oh),
                        _divisors(wl.ow), _divisors(do), _divisors(di),
                        indexing="ij")
    g = [x.reshape(-1).astype(np.float64) for x in grids]
    out: list = []
    seen: set = set()
    for oc_n, h_n in ((1, 1), (2, 1), (1, 2)):
        l_inp, l_wgt, l_acc, s_inp, s_wgt, s_acc = _costs(
            wl, hw, g[0], g[1], g[2], g[3], g[4], oc_n, h_n)
        cost = l_inp + l_wgt + l_acc
        ok = ((s_inp <= hw.inp_elems) & (s_wgt <= hw.wgt_elems)
              & (s_acc <= hw.acc_elems))
        if oc_n == 2:
            ok &= (g[3] % 2 == 0)
        if h_n == 2:
            ok &= (g[1] % 2 == 0)
        idxs = [int(i) for i in np.nonzero(ok)[0]]
        mode = [Tiling(int(g[0][i]), int(g[1][i]), int(g[2][i]),
                       int(g[3][i]), int(g[4][i]), oc_n, h_n,
                       float(cost[i]), float(s_inp[i]), float(s_wgt[i]),
                       float(s_acc[i])) for i in idxs]
        ranked = rank_candidates(mode, cost=lambda t: t.cost_bytes,
                                 k=k_traffic)
        ranked += rank_candidates(mode, cost=lambda t: vta_est_cycles(
            wl, hw, t), k=k_cycles)
        for t in ranked:
            key = (t.tb_o, t.th_o, t.tw_o, t.tco_o, t.tci_o, t.oc_n, t.h_n)
            if key not in seen:
                seen.add(key)
                out.append(t)
    return out


def vta_alu_tile_candidates(oh: int, ow: int) -> list:
    """Spatial-tile candidates for ALU-lowered layers (depthwise / pool):
    divisor row counts plus the ceil-halving ladder the greedy default walks,
    crossed with full / halved widths. Capacity feasibility is decided by the
    emitters' asserts (the autotuner prunes on failure)."""
    from repro_torch.core.tps import _divisors
    ths = set(int(d) for d in _divisors(oh))
    t = oh
    while t > 1:
        t = -(-t // 2)
        ths.add(t)
    tws = {ow}
    t = ow
    while t > 1:
        t = -(-t // 2)
        tws.add(t)
    return [(th, tw) for th in sorted(ths) for tw in sorted(tws, reverse=True)]
