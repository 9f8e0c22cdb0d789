"""Roofline table from dry-run JSONs; the port of
``repro/analysis/roofline.py``, over ``core/roofline.py::h100_terms``.

No extrapolation: the reference compiles depth-1/depth-2 variants because
XLA's cost_analysis counts a while body once, and multiplies by grad_accum
because the microbatch scan is a loop too. The port loops over groups and
microbatches in Python, so the dry-run's counts (``launch/dryrun.py``)
already cover every layer and every microbatch: a cell's terms are its
full-depth JSON's numbers as they are.

MODEL_FLOPS is the analytic useful-work count (6*N_active*tokens for train,
2*N_active*tokens for prefill/decode, + attention term), so
MODEL_FLOPS / counted FLOPs exposes remat/dispatch waste per cell.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Optional

from repro_torch.configs.base import SHAPES, ModelConfig
from repro_torch.core.roofline import RooflineTerms, h100_terms


def model_flops(cfg: ModelConfig, shape_name: str) -> float:
    """Analytic useful FLOPs per step (per the assignment's MODEL_FLOPS)."""
    shape = SHAPES[shape_name]
    n_act = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        mult = 6.0
        ctx = shape.seq_len
    elif shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        mult = 2.0
        ctx = shape.seq_len
    else:
        tokens = shape.global_batch
        mult = 2.0
        ctx = shape.seq_len
    total = mult * n_act * tokens
    # attention reads/writes: 4 * ctx_eff * H * hd flops per token per attn layer
    attn_layers = [k for k in cfg.layer_kinds if k.startswith("attn")]
    for kind in attn_layers:
        if shape.kind == "decode":
            ctx_eff = ctx if kind == "attn_global" else min(
                ctx, cfg.sliding_window or ctx)
        else:
            ctx_eff = (ctx / 2 if kind == "attn_global"
                       else min(ctx, cfg.sliding_window or ctx) / 2)
        fwd = 4.0 * ctx_eff * cfg.n_heads * cfg.head_dim * tokens
        total += (3.0 if shape.kind == "train" else 1.0) * fwd
    return total


@dataclass
class CellRoofline:
    arch: str
    shape: str
    chips: int
    flops_per_chip: float
    hbm_bytes_per_chip: float
    coll_bytes_per_chip: float
    terms: RooflineTerms
    model_flops_total: float
    peak_hbm_gib: float
    compile_s: float

    @property
    def useful_ratio(self) -> float:
        return self.model_flops_total / max(1.0, self.flops_per_chip * self.chips)

    def row(self) -> dict:
        t = self.terms
        return {
            "arch": self.arch, "shape": self.shape, "chips": self.chips,
            "compute_s": t.compute_s, "memory_s": t.memory_s,
            "collective_s": t.collective_s, "dominant": t.dominant,
            "bound_s": t.bound_s,
            "roofline_fraction": t.fraction_of_roofline(),
            "model_flops": self.model_flops_total,
            "flops_per_chip": self.flops_per_chip,
            "useful_ratio": self.useful_ratio,
            "peak_hbm_gib": self.peak_hbm_gib,
        }


def _load(out_dir: str, arch: str, shape: str, mesh: str, depth: str) -> Optional[dict]:
    path = os.path.join(out_dir, f"{arch}__{shape}__{mesh}__{depth}.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def roofline_of(res: dict, cfg: ModelConfig) -> CellRoofline:
    """A dry-run result (``run_cell``'s dict) as its roofline row."""
    flops = res["flops_per_device"]
    hbm = res["hbm_bytes_per_device"]
    coll = float(res["collectives"]["total_bytes"])
    return CellRoofline(
        arch=res["arch"], shape=res["shape"], chips=res["chips"],
        flops_per_chip=flops, hbm_bytes_per_chip=hbm,
        coll_bytes_per_chip=coll,
        terms=h100_terms(flops, hbm, coll, n_devices=res["chips"]),
        model_flops_total=model_flops(cfg, res["shape"]),
        peak_hbm_gib=res["memory"]["peak_est_bytes"] / 2 ** 30,
        compile_s=res.get("compile_s", 0.0),
    )


def cell_roofline(out_dir: str, arch: str, shape: str,
                  cfg: ModelConfig) -> Optional[CellRoofline]:
    full = _load(out_dir, arch, shape, "sp", "full")
    if full is None or "error" in full:
        return None
    return roofline_of(full, cfg)


def full_table(out_dir: str) -> list[CellRoofline]:
    from repro_torch.configs import ARCHS
    from repro_torch.launch.dryrun import runnable_cells
    rows = []
    for arch, shape in runnable_cells():
        r = cell_roofline(out_dir, arch, shape, ARCHS[arch])
        if r is not None:
            rows.append(r)
    return rows


def format_table(rows: list[CellRoofline]) -> str:
    hdr = (f"{'arch':22s} {'shape':12s} {'compute_s':>10s} {'memory_s':>10s} "
           f"{'coll_s':>10s} {'dom':>10s} {'roofl%':>7s} {'useful%':>8s} "
           f"{'HBM GiB':>8s}")
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        t = r.terms
        lines.append(
            f"{r.arch:22s} {r.shape:12s} {t.compute_s:10.4f} {t.memory_s:10.4f} "
            f"{t.collective_s:10.4f} {t.dominant:>10s} "
            f"{t.fraction_of_roofline()*100:6.1f}% "
            f"{min(9.999, r.useful_ratio)*100:7.1f}% {r.peak_hbm_gib:8.2f}")
    return "\n".join(lines)


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results/dryrun")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)
    rows = full_table(args.dir)
    print(format_table(rows))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump([r.row() for r in rows], f, indent=2)
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
