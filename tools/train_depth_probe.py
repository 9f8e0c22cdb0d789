"""Find the deepest whole-pattern depth at which each past-card bf16 run of
``chip_smoke.py`` phase 8 trains on one card within its peak limit.

    python3 tools/train_depth_probe.py [--steps 2] [name ...]

For each run of ``chip_smoke.TRAIN_BF16_RUNS`` named in
``TRAIN_PAST_CARD_NAMES`` (or on the command line), from the depth its spec
gives: the ``Trainer`` at that depth (``chip_smoke.trainer``, the spec's
batch and sequence, donated step) takes ``--steps`` steps, each step's
``torch.cuda.max_memory_allocated`` over what was allocated before the
Trainer was built recorded, as phase 8 records it. A depth whose peak
stays at or under ``chip_smoke.TRAIN_PEAK_LIMIT`` is followed by the depth
one pattern group deeper, one over it (or out of memory) by the depth one
group shallower, until the deepest depth within the limit is bracketed.
Prints the card's name and power limit (``nvidia-smi``), a line a depth
tried, then one JSON line. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def try_depth(cs, spec: dict, layers: int, steps: int) -> dict:
    """``steps`` steps of ``spec`` at ``layers``: the peak of each, its ms
    on the host clock between synchronizes, and its losses; an
    out-of-memory error instead where one was raised."""
    import torch
    spec = dict(spec, overrides=dict(spec.get("overrides", {}),
                                     n_layers=layers))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    peaks, ms, row, tr = [], [], dict(layers=layers), None
    try:
        tr = cs.trainer(spec, torch.device("cuda"))
        inner = tr.step_fn

        def step_fn(params, opt_state, batch):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = inner(params, opt_state, batch)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            peaks.append(torch.cuda.max_memory_allocated() - base)
            return out
        tr.step_fn = step_fn
        _, _, hist = tr.run(steps)
        row.update(loss=[h["loss"] for h in hist])
    except torch.cuda.OutOfMemoryError as e:
        row["oom"] = str(e).splitlines()[0]
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    row.update(peak_gb=[p / 1e9 for p in peaks], step_ms=ms,
               reserved_gb=torch.cuda.memory_reserved() / 1e9)
    row["fits"] = "oom" not in row and bool(peaks) and \
        max(peaks) <= cs.TRAIN_PEAK_LIMIT
    return row


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("names", nargs="*")
    ap.add_argument("--steps", type=int, default=2)
    a = ap.parse_args()
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch
    if not torch.cuda.is_available():
        print("train_depth_probe.py: no CUDA device", file=sys.stderr)
        return 3
    import chip_smoke as cs
    card = cs.card_line()
    print(card, flush=True)
    names = a.names or list(cs.TRAIN_PAST_CARD_NAMES)
    out = {"card": card, "limit_gb": cs.TRAIN_PEAK_LIMIT / 1e9, "runs": {}}
    for name in names:
        (spec,) = [r for r in cs.TRAIN_BF16_RUNS if r["name"] == name]
        group = len(cs.train_config(spec).pattern)
        layers = cs.train_config(spec).n_layers
        tried: dict = {}
        while layers > 0 and layers not in tried:
            row = try_depth(cs, spec, layers, a.steps)
            tried[layers] = row
            print(f"{name} at {layers} layers: {json.dumps(row)}",
                  flush=True)
            layers += group if row["fits"] else -group
        fit = [d for d, r in tried.items() if r["fits"]]
        out["runs"][name] = dict(deepest=max(fit) if fit else None,
                                 tried=tried)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
