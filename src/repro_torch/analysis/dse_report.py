"""Render a DSE sweep report (results/dse/report.json) as ASCII Fig-13.

Plots every network's feasible points on the (scaled area, cycles) plane —
log-x like the paper's figure — marking frontier members, plus the textual
per-network and joint summaries.

  PYTHONPATH=src python -m repro_torch.analysis.dse_report results/dse/report.json
"""
from __future__ import annotations

import argparse
import json
import math
import sys


def frontier_chart(pareto_pts: list, all_pts: list, *, width: int = 72,
                   height: int = 18) -> str:
    """ASCII scatter: '*' = frontier member, 'o' = dominated point."""
    if not all_pts:
        return "  (no feasible points)"
    areas = [a for _, a, _ in all_pts]
    cycles = [c for _, _, c in all_pts]
    la0, la1 = math.log(min(areas)), math.log(max(areas)) or 1e-9
    c0, c1 = min(cycles), max(cycles)
    la1 = la1 if la1 > la0 else la0 + 1e-9
    c1 = c1 if c1 > c0 else c0 + 1

    grid = [[" "] * width for _ in range(height)]
    front = {(a, c) for _, a, c in pareto_pts}

    def cell(a, c):
        x = int((math.log(a) - la0) / (la1 - la0) * (width - 1))
        y = int((c - c0) / (c1 - c0) * (height - 1))
        return height - 1 - y, x

    for label, a, c in all_pts:
        r, x = cell(a, c)
        grid[r][x] = "*" if (a, c) in front else \
            ("o" if grid[r][x] != "*" else "*")
    lines = [f"  {c1/1e6:7.1f}M |" + "".join(grid[0])]
    lines += ["           |" + "".join(row) for row in grid[1:-1]]
    lines.append(f"  {c0/1e6:7.1f}M |" + "".join(grid[-1]))
    lines.append("           +" + "-" * width)
    lines.append(f"            {min(areas):.1f}x{'scaled area':^{width - 16}}"
                 f"{max(areas):.1f}x")
    return "\n".join(lines)


def render(report: dict, *, chart: bool = True) -> str:
    out = [f"DSE report — networks: {', '.join(report['networks'])}  "
           f"(cache {report['cache']['hits']}h/{report['cache']['misses']}m, "
           f"{report['wall_s']}s)"]
    for net, e in report["per_network"].items():
        out.append(f"\n[{net}] {e['n_points']} feasible, "
                   f"{e['n_infeasible']} infeasible")
        if chart and e.get("pareto"):
            # dominated points are not persisted in the report; chart frontier
            out.append(frontier_chart(e["pareto"], e["pareto"]))
        for label, a, c in e.get("pareto", []):
            out.append(f"  {label:22s} area {a:6.2f}x  cycles {c/1e6:8.2f}M")
        if "cycle_gain_best" in e:
            out.append(f"  big end {e['best'][0]}: "
                       f"{e['cycle_gain_best']:.1f}x fewer cycles at "
                       f"{e['area_cost_best']:.1f}x area")
        if e.get("total_dram_bytes_saved"):
            ref_saved = e.get("ref_dram_bytes_saved", 0)
            out.append(f"  graph compiler: "
                       f"{e['total_dram_bytes_saved']/1e6:.1f}MB DRAM avoided "
                       f"across points ({ref_saved/1e6:.2f}MB on the ref "
                       f"config)")
        if e.get("total_tuning_cycles_saved"):
            out.append(f"  autotuner: "
                       f"{e['total_tuning_cycles_saved']/1e6:.2f}M cycles "
                       f"saved across points "
                       f"({e.get('ref_tuning_cycles_saved', 0)/1e3:.0f}k on "
                       f"the ref config, "
                       f"{e.get('ref_tuned_layers', 0)} tuned layers)")
    j = report.get("joint") or {}
    if j:
        out.append(f"\n[joint] {j['n_points']} configs feasible on all "
                   f"networks")
        if chart:
            out.append(frontier_chart(j["pareto"], j["pareto"]))
        for label, a, c in j["pareto"]:
            out.append(f"  {label:22s} area {a:6.2f}x  cycles {c/1e6:8.2f}M")
        out.append(f"  big end {j['best'][0]}: {j['cycle_gain_best']:.1f}x "
                   f"fewer cycles at {j['area_cost_best']:.1f}x area")
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("report", help="path to report.json from repro_torch.core.dse")
    ap.add_argument("--no-chart", action="store_true")
    args = ap.parse_args(argv)
    try:
        with open(args.report) as f:
            report = json.load(f)
    except (FileNotFoundError, json.JSONDecodeError) as e:
        print(f"error: cannot read report {args.report!r}: {e}",
              file=sys.stderr)
        return 2
    print(render(report, chart=not args.no_chart))
    return 0


if __name__ == "__main__":
    sys.exit(main())
