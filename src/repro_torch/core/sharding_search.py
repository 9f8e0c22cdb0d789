"""SPS — Sharding Parameter Search (beyond-paper, TPS lifted to the mesh);
the port of ``repro/core/sharding_search.py``.

The paper's TPS formulation:  min DRAM bytes  s.t. scratchpad capacities.
SPS:                          min collective bytes  s.t. per-device HBM.

Candidates are logical-rule-table variants (sequence parallelism on/off,
FSDP axis choice, expert placement, batch mapping); each runs like a dry-run
cell (``launch/dryrun.py::run_cell``, on a fake 256-rank mesh) and is scored
by (collective bytes, HBM bytes) with a hard HBM-capacity constraint — an
exhaustive enumeration over a small discrete space, exactly the paper's
search shape. The cap is one H100 SXM 80GB HBM3's memory (its data sheet, at
its 700 W limit).

  PYTHONPATH=src python -m repro_torch.core.sharding_search \\
      --arch qwen2.5-32b --shape train_4k
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from dataclasses import dataclass
from typing import Optional

HBM_CAP_GIB = 80e9 / 2 ** 30   # H100 SXM 80GB HBM3: 80 GB


def candidate_tables() -> dict:
    """Named rule-table variants (deltas on DEFAULT_RULES)."""
    return {
        "baseline": {},
        "no_seq_parallel": {"seq": ()},
        "fsdp_off": {"d_model": ()},
        "seq_on_data": {"seq": ("data",), "d_model": ("model",)},
        "experts_on_data": {"experts": ("data",)},
        "batch_data_only": {"batch": ("data",)},
    }


@dataclass
class SPSResult:
    name: str
    coll_bytes: float
    hbm_bytes: float
    flops: float
    peak_gib: float
    feasible: bool
    compile_s: float

    def key(self):
        return (not self.feasible, self.coll_bytes, self.hbm_bytes)


def evaluate(arch: str, shape: str, overrides: dict, name: str) -> SPSResult:
    """One candidate: ``run_cell`` with the rules' table updated by
    ``overrides``. Raises where the cell fails."""
    from repro_torch.launch import dryrun
    t0 = time.time()
    res = dryrun.run_cell(arch, shape, verbose=False, rule_overrides=overrides)
    if "error" in res:
        raise RuntimeError(res["error"])
    peak = res["memory"]["peak_est_bytes"] / 2 ** 30
    return SPSResult(name=name, coll_bytes=float(
        res["collectives"]["total_bytes"]),
        hbm_bytes=res["hbm_bytes_per_device"],
        flops=res["flops_per_device"], peak_gib=peak,
        feasible=peak <= HBM_CAP_GIB, compile_s=time.time() - t0)


def sps_search(arch: str, shape: str, candidates: Optional[dict] = None,
               verbose: bool = True) -> list[SPSResult]:
    candidates = candidates or candidate_tables()
    results = []
    for name, ov in candidates.items():
        try:
            r = evaluate(arch, shape, ov, name)
        except Exception as e:   # infeasible layouts are data, not crashes
            r = SPSResult(name, float("inf"), float("inf"), 0.0, float("inf"),
                          False, 0.0)
            if verbose:
                print(f"  {name:20s} FAILED: {type(e).__name__}: {e}")
        results.append(r)
        if verbose and r.compile_s:
            print(f"  {name:20s} coll={r.coll_bytes/2**20:9.1f}MiB "
                  f"hbm={r.hbm_bytes/2**30:7.2f}GiB peak={r.peak_gib:6.2f}GiB "
                  f"{'ok' if r.feasible else 'OVER-CAP'} ({r.compile_s:.0f}s)")
    results.sort(key=lambda r: r.key())
    if verbose:
        print(f"  SPS winner: {results[0].name}")
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    res = sps_search(args.arch, args.shape)
    if args.out:
        with open(args.out, "w") as f:
            json.dump([r.__dict__ for r in res], f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
