"""Tiling Parameter Search (TPS) — faithful implementation of Appendix A.

Given a convolution workload and a VTA hardware configuration, TPS expresses
DRAM->scratchpad byte traffic as an analytical function of the tiling
parameters and exhaustively enumerates the (divisor-constrained) tiling space
subject to scratchpad-capacity constraints:

    min  l_inp + l_wgt + l_acc
    s.t. u_inp >= 0, u_wgt >= 0, u_acc >= 0            (paper eq. 2)

The same constrained-enumeration formulation is reused at the Pallas-kernel
level (core/tile_search.py: HBM bytes vs VMEM capacity) and at the mesh level
(core/sharding_search.py: collective bytes vs HBM capacity) — the paper's core
idea lifted to TPU scope.

All cost expressions below mirror Appendix A verbatim (eqs. 1-6); the search
is vectorized over the full candidate grid with numpy.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


# ---------------------------------------------------------------------------
# Workload / tiling descriptors
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ConvWorkload:
    """A convolution layer: NCHW activation b*fi*h*w, kernel fo*fi*kh*kw."""
    name: str
    b: int
    h: int
    w: int
    kh: int
    kw: int
    fi: int
    fo: int
    ph: int = 0
    pw: int = 0
    sh: int = 1
    sw: int = 1
    depthwise: bool = False
    groups: int = 1

    @property
    def oh(self) -> int:
        return (self.h + 2 * self.ph - self.kh) // self.sh + 1   # eq. (1)

    @property
    def ow(self) -> int:
        return (self.w + 2 * self.pw - self.kw) // self.sw + 1

    @property
    def macs(self) -> int:
        per_out = self.kh * self.kw * (1 if self.depthwise else self.fi)
        return self.b * self.fo * self.oh * self.ow * per_out

    def out_elems(self) -> int:
        return self.b * self.fo * self.oh * self.ow


@dataclass(frozen=True)
class Tiling:
    """Outer tiling factors + virtual-thread (double-buffer) dims."""
    tb_o: int
    th_o: int
    tw_o: int
    tco_o: int
    tci_o: int
    oc_n: int = 1       # virtual threads along output channels
    h_n: int = 1        # virtual threads along input height
    cost_bytes: float = 0.0
    s_inp: float = 0.0
    s_wgt: float = 0.0
    s_acc: float = 0.0

    @property
    def double_buffered(self) -> bool:
        return self.oc_n == 2 or self.h_n == 2


@dataclass
class TPSResult:
    tiling: Optional[Tiling]
    feasible: bool
    candidates: int
    searched: int


def _divisors(n: int) -> np.ndarray:
    n = max(1, int(n))
    return np.array([d for d in range(1, n + 1) if n % d == 0], dtype=np.int64)


# ---------------------------------------------------------------------------
# Cost model (Appendix A, eqs. 3-6) — vectorized over candidate grids
# ---------------------------------------------------------------------------
def _costs(wl: ConvWorkload, hw, tb_o, th_o, tw_o, tco_o, tci_o, oc_n, h_n):
    """Vectorized l_inp/l_wgt/l_acc (bytes) and s_inp/s_wgt/s_acc (elements)."""
    BI, BO, BV = hw.block_in, hw.block_out, hw.batch
    fi = wl.fi if not wl.depthwise else BI  # depthwise handled channel-blocked
    di = max(1, fi // BI)
    do = max(1, wl.fo // BO)
    tb_i = np.maximum(1, (wl.b // BV) // tb_o)

    # s_inp (eq. 3)
    ih_tile = (np.floor_divide(wl.h // th_o + 2 * wl.ph - wl.kh, wl.sh)) * wl.sh + wl.kh
    iw_tile = (np.floor_divide(wl.w // tw_o + 2 * wl.pw - wl.kw, wl.sw)) * wl.sw + wl.kw
    s_inp = (tb_i * (di // np.maximum(tci_o, 1)) * ih_tile * iw_tile
             * BV * BI * oc_n * h_n)

    # s_wgt (eq. 4)
    s_wgt = (do * di * wl.kh * wl.kw * BO * BI) / (tco_o * tci_o) * oc_n * h_n

    # s_acc (eq. 6)
    s_acc = (((wl.b // BV) * do * wl.oh * wl.ow * BV * BO)
             / (tb_o * tco_o * th_o * tw_o)
             + (wl.fo * wl.b) / (tb_o * tco_o)) * oc_n * h_n

    # l_* (bytes; inp/wgt int8, acc int32)
    pre = tb_o * (th_o / h_n) * (tco_o / oc_n) * tw_o * tci_o
    l_inp = pre * s_inp * hw.inp_bytes
    l_wgt = pre * s_wgt * hw.wgt_bytes
    l_acc = (tb_o * th_o * tw_o * wl.fo) * hw.acc_bytes
    return l_inp, l_wgt, l_acc, s_inp, s_wgt, s_acc


def tps_search(wl: ConvWorkload, hw, *, require_db: bool = False,
               forbid_db: bool = False) -> TPSResult:
    """Exhaustively enumerate tilings; return the DRAM-byte-minimal feasible one.

    require_db: restrict to virtual-threaded (double-buffered) tilings, as the
    upstream TVM/VTA stack always schedules (needed for §IV.D.2 comparisons).
    """
    BI, BO, BV = hw.block_in, hw.block_out, hw.batch
    fi = wl.fi if not wl.depthwise else BI
    di = max(1, fi // BI)
    do = max(1, wl.fo // BO)
    b_outer = max(1, wl.b // BV)

    tb = _divisors(b_outer)
    th = _divisors(wl.oh)
    tw = _divisors(wl.ow)
    tco = _divisors(do)
    tci = _divisors(di)
    vts = [(1, 1), (2, 1), (1, 2)]       # oc_n, h_n: not both 2 (Appendix A)
    if require_db:
        vts = [(2, 1), (1, 2)]
    elif forbid_db:
        vts = [(1, 1)]

    best = None
    searched = 0
    grids = np.meshgrid(tb, th, tw, tco, tci, indexing="ij")
    g = [x.reshape(-1).astype(np.float64) for x in grids]
    n = g[0].size
    for oc_n, h_n in vts:
        l_inp, l_wgt, l_acc, s_inp, s_wgt, s_acc = _costs(
            wl, hw, g[0], g[1], g[2], g[3], g[4], oc_n, h_n)
        cost = l_inp + l_wgt + l_acc
        ok = ((s_inp <= hw.inp_elems) & (s_wgt <= hw.wgt_elems)
              & (s_acc <= hw.acc_elems))
        # the virtual-threaded outer loop is split across 2 contexts
        if oc_n == 2:
            ok &= (g[3] % 2 == 0)
        if h_n == 2:
            ok &= (g[1] % 2 == 0)
        searched += n
        if not ok.any():
            continue
        idx = np.where(ok, cost, np.inf).argmin()
        cand = Tiling(int(g[0][idx]), int(g[1][idx]), int(g[2][idx]),
                      int(g[3][idx]), int(g[4][idx]), oc_n, h_n,
                      float(cost[idx]), float(s_inp[idx]), float(s_wgt[idx]),
                      float(s_acc[idx]))
        if best is None or cand.cost_bytes < best.cost_bytes:
            best = cand
    return TPSResult(best, best is not None, n * len(vts), searched)


def heuristic_conv_tiling(wl: ConvWorkload, hw, *,
                          prefer_db: bool = True) -> Tiling:
    """The stack's default one-shot tiling policy: the traffic-minimal
    double-buffered tiling when one exists (as upstream TVM/VTA always
    schedules), else the traffic-minimal serial one.

    Shared by the per-layer scheduler (vta/network.py) and the autotuner
    (vta/autotune.py) — the autotuner always includes this tiling in its
    candidate set, which is what makes tuning never-worse by construction.
    """
    res = tps_search(wl, hw, require_db=True) if prefer_db else None
    if res is None or not res.feasible:
        res = tps_search(wl, hw)
    if not res.feasible:
        raise RuntimeError(f"no feasible tiling for {wl.name} on {hw}")
    return res.tiling


def legacy_db_tiling(wl: ConvWorkload, hw) -> Optional[Tiling]:
    """Emulate the original (pre-TPS) TVM/VTA virtual-threaded schedules:
    output-channel-major traversal (deep tco_o loop, minimal spatial split)
    with oc_n=2 weight threading. These schedules reload the input tile per
    output-channel step — the redundancy the paper's §IV.D.2 fix halves.
    Selection: feasible oc_n=2 tiling minimizing (spatial splits, -tco_o)."""
    BI, BO, BV = hw.block_in, hw.block_out, hw.batch
    fi = wl.fi if not wl.depthwise else BI
    di = max(1, fi // BI)
    do = max(1, wl.fo // BO)
    b_outer = max(1, wl.b // BV)
    best = None
    best_key = None
    for tb in _divisors(b_outer):
        for th in _divisors(wl.oh):
            for tw in _divisors(wl.ow):
                for tco in _divisors(do):
                    if tco % 2:
                        continue
                    for tci in _divisors(di):
                        l_inp, l_wgt, l_acc, s_i, s_w, s_a = _costs(
                            wl, hw, np.float64(tb), np.float64(th),
                            np.float64(tw), np.float64(tco), np.float64(tci),
                            2, 1)
                        if s_i > hw.inp_elems or s_w > hw.wgt_elems \
                                or s_a > hw.acc_elems:
                            continue
                        key = (tb * th * tw, -tco, float(l_inp + l_wgt + l_acc))
                        if best_key is None or key < best_key:
                            best_key = key
                            best = Tiling(int(tb), int(th), int(tw), int(tco),
                                          int(tci), 2, 1,
                                          float(l_inp + l_wgt + l_acc),
                                          float(s_i), float(s_w), float(s_a))
    return best


def fallback_tiling(wl: ConvWorkload, hw) -> Tiling:
    """The TVM-VTA fallback: maximal outer tiling => minimal scratchpad use,
    maximal DRAM traffic (paper §IV.D.1)."""
    BI, BO, BV = hw.block_in, hw.block_out, hw.batch
    fi = wl.fi if not wl.depthwise else BI
    di = max(1, fi // BI)
    do = max(1, wl.fo // BO)
    tb_o = max(1, wl.b // BV)
    t = (tb_o, wl.oh, wl.ow, do, di)
    l_inp, l_wgt, l_acc, s_inp, s_wgt, s_acc = _costs(
        wl, hw, *map(np.float64, t), 1, 1)
    return Tiling(*t, 1, 1, float(l_inp + l_wgt + l_acc),
                  float(s_inp), float(s_wgt), float(s_acc))


def tiling_dram_bytes(wl: ConvWorkload, hw, t: Tiling) -> dict:
    l_inp, l_wgt, l_acc, *_ = _costs(
        wl, hw, np.float64(t.tb_o), np.float64(t.th_o), np.float64(t.tw_o),
        np.float64(t.tco_o), np.float64(t.tci_o), t.oc_n, t.h_n)
    return {"inp": float(l_inp), "wgt": float(l_wgt), "acc": float(l_acc),
            "total": float(l_inp + l_wgt + l_acc)}
