"""Dry-run sweep orchestrator: every (arch x shape) x {16x16, 2x16x16} cell;
the port of ``repro/analysis/sweep.py``, over ``repro_torch.launch.dryrun``.

Each cell runs in a subprocess (a fresh fake process group, bounded
memory), as many at once as the host has cores. The port needs no
depth-1/depth-2 variants (analysis/roofline.py does not extrapolate), so
each cell runs at full depth on each mesh.
Results land in <out>/cellname.json; a failed cell's in <out>/cellname.json
too, with its ``"error"`` (the op it failed on), or in .err if the process
died.

  PYTHONPATH=src python -m repro_torch.analysis.sweep --out results/dryrun
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor


def cell_jobs(single_depths=("full",)) -> list[dict]:
    from repro_torch.launch.dryrun import runnable_cells
    jobs = []
    for arch, shape in runnable_cells():
        for depth in single_depths:
            jobs.append({"arch": arch, "shape": shape, "multi_pod": False,
                         "depth": depth})
        jobs.append({"arch": arch, "shape": shape, "multi_pod": True,
                     "depth": "full"})
    return jobs


def job_tag(j: dict) -> str:
    return (f"{j['arch']}__{j['shape']}__"
            f"{'mp' if j['multi_pod'] else 'sp'}__{j['depth']}")


def run_job(j: dict, out_dir: str, timeout: int = 1800) -> dict:
    tag = job_tag(j)
    out = os.path.join(out_dir, tag + ".json")
    if os.path.exists(out):
        with open(out) as f:
            return json.load(f)
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
           "--arch", j["arch"], "--shape", j["shape"],
           "--depth", j["depth"], "--out", out]
    if j["multi_pod"]:
        cmd.append("--multi-pod")
    env = dict(os.environ)
    env["PYTHONPATH"] = env.get("PYTHONPATH", "src")
    t0 = time.time()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout,
                          env=env)
    if os.path.exists(out):        # written with "error" for a failed op
        with open(out) as f:
            return json.load(f)
    err = {"arch": j["arch"], "shape": j["shape"], "depth": j["depth"],
           "mesh": "2x16x16" if j["multi_pod"] else "16x16",
           "error": proc.stderr[-4000:], "wall_s": time.time() - t0}
    with open(out + ".err", "w") as f:
        json.dump(err, f, indent=2)
    return err


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--only-arch", default=None)
    ap.add_argument("--timeout", type=int, default=1800)
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    jobs = cell_jobs()
    if args.only_arch:
        jobs = [j for j in jobs if j["arch"] == args.only_arch]
    t0 = time.time()
    # one cell process a core: a cell is one Python thread on meta tensors
    with ThreadPoolExecutor(os.cpu_count() or 1) as ex:
        results = list(ex.map(lambda j: run_job(j, args.out, args.timeout),
                              jobs))
    n_err = 0
    for i, (j, r) in enumerate(zip(jobs, results)):
        ok = "error" not in r
        n_err += 0 if ok else 1
        print(f"[{i+1}/{len(jobs)}] {job_tag(j):55s} "
              f"{'OK' if ok else 'FAIL'}", flush=True)
    print(f"done: {len(jobs)-n_err}/{len(jobs)} ok in {time.time()-t0:.0f}s")
    return 1 if n_err else 0


if __name__ == "__main__":
    sys.exit(main())
