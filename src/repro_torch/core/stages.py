"""Per-stage wall-time accounting for the DSE pipeline (--profile).

Process-global, exclusive accumulators: nesting a stage inside another
subtracts the child's elapsed time from the parent, so the reported
numbers sum to total instrumented wall time without double counting
(e.g. the autotuner's candidate scheduling shows up as "schedule", not
"autotune"). Pool workers snapshot/delta around each job group and ship
the deltas back to the parent for aggregation into the report.

Stages used by the sweep engine:
  schedule     lowering + encoding validation + tsim structural pass
  autotune     tile search bookkeeping (candidate enumeration, ranking)
  tsim_cost    cost-model replay / scalar tsim of scheduled programs
  fsim_verify  functional verification of autotune winners
"""
from __future__ import annotations

import time
from contextlib import contextmanager

STAGE_NAMES = ("schedule", "autotune", "tsim_cost", "fsim_verify")

_totals: dict = {}
_stack: list = []


@contextmanager
def stage(name: str):
    t0 = time.perf_counter()
    _stack.append(name)
    try:
        yield
    finally:
        _stack.pop()
        dt = time.perf_counter() - t0
        _totals[name] = _totals.get(name, 0.0) + dt
        if _stack:       # exclusive accounting: carve out of the parent
            parent = _stack[-1]
            _totals[parent] = _totals.get(parent, 0.0) - dt


def snapshot() -> dict:
    return dict(_totals)


def delta(before: dict) -> dict:
    """Seconds accumulated per stage since ``before`` (a snapshot)."""
    out = {}
    for k in set(_totals) | set(before):
        d = _totals.get(k, 0.0) - before.get(k, 0.0)
        if d > 1e-12:
            out[k] = d
    return out


def merge(into: dict, d: dict) -> dict:
    for k, v in d.items():
        into[k] = into.get(k, 0.0) + v
    return into


def reset() -> None:
    _totals.clear()
