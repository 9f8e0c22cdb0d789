"""Perf hillclimb: run config-override variants of one dry-run cell,
take their roofline terms, and tabulate before/after per hypothesis; the
port of ``repro/analysis/hillclimb.py``, over ``repro_torch.launch.dryrun``.

  PYTHONPATH=src python -m repro_torch.analysis.hillclimb \\
      --arch deepseek-67b --shape train_4k --variant base \\
      --variant remat=dots:remat_policy=dots

Variant syntax: NAME[:key=value[,key=value...]]  (empty overrides = baseline)
Each variant runs the cell at full depth in a subprocess (no d1/d2 probes:
the port's counts cover every layer, analysis/roofline.py) and lands in
<out>/<cell>/<name>__full.json.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from repro_torch.core.roofline import h100_terms


def run_variant(arch: str, shape: str, name: str, overrides: dict,
                out_dir: str, timeout: int = 1800) -> dict:
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, f"{name}__full.json")
    if not os.path.exists(out):
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", arch, "--shape", shape, "--out", out]
        for k, v in overrides.items():
            cmd += ["--set", f"{k}={v}"]
        env = dict(os.environ)
        env["PYTHONPATH"] = env.get("PYTHONPATH", "src")
        p = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=timeout, env=env)
        if not os.path.exists(out):
            return {"name": name, "error": p.stderr[-2000:]}
    with open(out) as f:
        full = json.load(f)
    if "error" in full:
        return {"name": name, "error": full["error"]}
    return summarize(name, full, overrides)


def summarize(name: str, full: dict, overrides: dict) -> dict:
    coll = full["collectives"]["total_bytes"]
    t = h100_terms(full["flops_per_device"], full["hbm_bytes_per_device"],
                   coll, n_devices=full["chips"])
    return {
        "name": name, "overrides": overrides,
        "compute_s": t.compute_s, "memory_s": t.memory_s,
        "collective_s": t.collective_s, "dominant": t.dominant,
        "bound_s": t.bound_s, "roofline_fraction": t.fraction_of_roofline(),
        "peak_gib": full["memory"]["peak_est_bytes"] / 2 ** 30,
        "compile_s": full["compile_s"],
    }


def parse_variant(s: str) -> tuple:
    if ":" in s:
        name, ov = s.split(":", 1)
        overrides = {}
        for kv in ov.split(","):
            k, v = kv.split("=", 1)
            try:
                overrides[k] = int(v)
            except ValueError:
                try:
                    overrides[k] = float(v)
                except ValueError:
                    overrides[k] = (v.lower() == "true") \
                        if v.lower() in ("true", "false") else v
        return name, overrides
    return s, {}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--out", default="results/hillclimb")
    args = ap.parse_args(argv)
    cell_dir = os.path.join(args.out, f"{args.arch}__{args.shape}")
    rows = []
    for spec in args.variant or ["base"]:
        name, ov = parse_variant(spec)
        t0 = time.time()
        r = run_variant(args.arch, args.shape, name, ov, cell_dir)
        rows.append(r)
        if "error" in r:
            print(f"{name:26s} FAILED\n{r['error'][-800:]}")
            continue
        print(f"{name:26s} comp={r['compute_s']:8.3f}s mem={r['memory_s']:8.3f}s "
              f"coll={r['collective_s']:8.3f}s dom={r['dominant']:10s} "
              f"roofl={r['roofline_fraction']*100:5.1f}% "
              f"peak={r['peak_gib']:6.2f}GiB ({time.time()-t0:.0f}s)",
              flush=True)
    with open(os.path.join(cell_dir, "summary.json"), "w") as f:
        json.dump(rows, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
