"""Time the float ALU kernel (``repro_torch.kernels.alu.alu``) at sizes
whose bytes bound it, against ``torch.mul`` on the same inputs.

    python3 tools/alu_timing.py [--src DIR] [--label NAME]

``--src`` is the ``src`` directory whose ``repro_torch`` is imported
(default: this checkout's), so the kernel of another checkout, such as the
parent commit unpacked with ``git archive``, is timed by the same code; run
both in one process each, in one session, to compare them. Each case is
checked exact against ``alu_plain`` and prints one JSON line: the kernel's
and ``torch.mul``'s time (CUDA-graph replay, ``chip_smoke.graph_ms``), and
the bytes bound (each input read once, the output written once, at
``chip_smoke.HBM_BYTES_PER_S``). Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BIG = 1 << 26      # 256 MiB of f32: far past the 50 MB L2
# name, elements, dtype, second operand ("y" or an immediate), x's offset
# in elements from a 16-byte boundary
CASES = [
    ("mul 8x56x56x64 y", 8 * 56 * 56 * 64, "float32", "y", 0),
    ("mul 2^26 y", BIG, "float32", "y", 0),
    ("mul 2^26 imm", BIG, "float32", -1.5, 0),
    ("mul 2^26-1 y, x and y 4 B off", BIG - 1, "float32", "y", 1),
    ("mul 2^26 y", BIG, "bfloat16", "y", 0),
    ("mul 2^26 imm", BIG, "bfloat16", -1.5, 0),
]


def main(argv: list) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--label", default="this checkout")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("alu_timing: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(1, ROOT)
    from chip_smoke import HBM_BYTES_PER_S, graph_ms
    from repro_torch.kernels.alu import alu, alu_plain
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    for name, n, dtype, second, off in CASES:
        dt = getattr(torch, dtype)

        def draw():
            a = rng.standard_normal(n + off, dtype=np.float32)
            return torch.from_numpy(a).to(dev, dt)[off:]
        x = draw()
        y = draw() if second == "y" else None
        kw = {} if y is not None else {"imm": second}
        other = y if y is not None else second
        out = alu(x, y, op="mul", **kw)
        exact = bool(torch.equal(out, alu_plain(x, y, op="mul", **kw)))
        reps = 20 if n < BIG else 10
        ms = graph_ms(lambda: alu(x, y, op="mul", **kw), reps=reps)
        lib_ms = graph_ms(lambda: torch.mul(x, other), reps=reps)
        nbytes = (2 + (y is not None)) * n * x.element_size()
        print(json.dumps({
            "label": args.label, "case": f"{name}/{dtype}", "n": n,
            "exact": exact, "ms": ms, "torch_mul_ms": lib_ms,
            "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S}), flush=True)
        del x, y, out
        if not exact:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
