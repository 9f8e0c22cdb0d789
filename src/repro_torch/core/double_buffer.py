"""Redundant-load elimination analytics (paper §IV.D.2, Figs 11-12).

The TVM virtual-threading pass loads `d_i1` twice when double buffering
(pattern (I1,W1),(I2,W2),(I1,W1),(I2,W2)); the paper's fix reorders the uop
access pattern to (I1,W1),(I1,W2),(I2,W1),(I2,W2), reusing the loaded chunk.
The executable rewrite lives in `vta/scheduler.py` (`dedup_loads=True`); this
module provides the closed-form byte accounting used by the Fig-11 benchmark
and by tests that cross-check the scheduler against the model.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.tps import ConvWorkload, Tiling, _costs
import numpy as np


@dataclass(frozen=True)
class DBSavings:
    bytes_baseline: float       # redundant-load schedule
    bytes_dedup: float          # reordered schedule
    shared_operand: str         # "inp" (oc_n=2) or "wgt" (h_n=2)

    @property
    def reduction(self) -> float:
        return 1.0 - self.bytes_dedup / max(1.0, self.bytes_baseline)


def db_savings(wl: ConvWorkload, hw, t: Tiling) -> DBSavings:
    assert t.double_buffered, "savings only defined for virtual-threaded tilings"
    l_inp, l_wgt, l_acc, *_ = _costs(
        wl, hw, np.float64(t.tb_o), np.float64(t.th_o), np.float64(t.tw_o),
        np.float64(t.tco_o), np.float64(t.tci_o), t.oc_n, t.h_n)
    l_inp, l_wgt, l_acc = float(l_inp), float(l_wgt), float(l_acc)
    if t.oc_n == 2:
        # both contexts consume the same input chunk -> half the input loads
        base = l_inp + l_wgt + l_acc
        dedup = l_inp / 2 + l_wgt + l_acc
        shared = "inp"
    else:
        base = l_inp + l_wgt + l_acc
        dedup = l_inp + l_wgt / 2 + l_acc
        shared = "wgt"
    return DBSavings(base, dedup, shared)
