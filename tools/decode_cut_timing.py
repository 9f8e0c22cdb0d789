"""Time the bf16 runs of ``chip_smoke.py`` phase 7 that decode 16 steps,
each at 32 decode steps and at 16, one after the other on one card: what
the cut from 32 to 16 saves, on one host.

    python3 tools/decode_cut_timing.py

Each run is ``chip_smoke.lm_bf16`` on its ``LM_BF16_RUNS`` spec with only
``steps`` changed (the 32-step run first), its memory freed before it as
phase 7 frees it; the wall of a run is the host clock around that call.
Phase 7 draws the goldens' numpy weights on threads beside these runs;
here nothing else runs. A run's checks are recorded, not gated: a 32-step
run can differ from the plain attention at a tie its spec does not list.
Prints the card's name and power limit (``nvidia-smi``), a line a run,
then one JSON line. Needs a CUDA device.
"""
from __future__ import annotations

import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = (32, 16)


def main() -> int:
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch
    if not torch.cuda.is_available():
        print("decode_cut_timing: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    card = cs.card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    out = {"card": card, "build_s": time.perf_counter() - t0, "runs": []}
    device = torch.device("cuda", torch.cuda.current_device())
    for spec in cs.LM_BF16_RUNS:
        if spec["steps"] != 16:
            continue
        for steps in STEPS:
            gc.collect()
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            errs, row = cs.lm_bf16(device, dict(spec, steps=steps))
            wall = time.perf_counter() - t0
            run = dict(name=spec["name"], steps=steps, wall_s=wall,
                       walls=row["walls"],
                       decode_ms_per_step_median=row[
                           "decode_ms_per_step_median"],
                       argmax_agree=row["argmax_agree"],
                       differ_steps=[d["step"]
                                     for d in row["argmax_differ_at"]],
                       failed={k: v for k, v in errs.items() if v})
            print(json.dumps(run), flush=True)
            out["runs"].append(run)
            del row
    for steps in STEPS:
        out[f"wall_s_{steps}"] = sum(r["wall_s"] for r in out["runs"]
                                     if r["steps"] == steps)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
