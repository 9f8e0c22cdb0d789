"""Time the pooling kernel (``repro_torch.kernels.pool2d.pool2d``) at sizes
past the card's 50 MB L2, against ``F.max_pool2d``/``F.avg_pool2d`` on the
same inputs.

    python3 tools/pool_timing.py [--src DIR] [--label NAME]

``--src`` is the ``src`` directory whose ``repro_torch`` is imported
(default: this checkout's), so the kernel of another checkout, such as the
parent commit unpacked with ``git archive``, is timed by the same code; run
both on one card, one after the other, to compare them. The cases are
ResNet-18's ``pool1`` (3x3, stride 2, pad 1 over 112x112x64) at batch 64
in f32 and bf16 and MobileNet-1.0's global pool (7x7 over 7x7x1024) at
batch 512 in f32: each input is 100-205 MB, so every replay reads it from
device memory. Each case
is checked against ``pool2d_plain`` (the same bits, NaN by position) and
prints one JSON line: the kernel's and the library's time (CUDA-graph
replay, ``chip_smoke.graph_ms``), the bytes bound (the input read once, the
output written once, at ``chip_smoke.HBM_BYTES_PER_S``) and the kernel's
share of the bytes rate. The first line is the card's name and power limit
(``nvidia-smi``). Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# name, shape (B, H, W, C), k, stride, pad, mode, dtype
CASES = [
    ("resnet18.pool1 b64", (64, 112, 112, 64), 3, 2, 1, "max", "float32"),
    ("resnet18.pool1 b64", (64, 112, 112, 64), 3, 2, 1, "max", "bfloat16"),
    ("mbn.gap b512", (512, 7, 7, 1024), 7, 7, 0, "avg", "float32"),
]


def main(argv: list) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--label", default="this checkout")
    args = ap.parse_args(argv)
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("pool_timing: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(1, ROOT)
    from chip_smoke import HBM_BYTES_PER_S, bits_differ, graph_ms
    from repro_torch.kernels.pool2d import pool2d, pool2d_plain
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    exact = True
    for name, shape, k, s, p, mode, dtype in CASES:
        a = rng.standard_normal(shape, dtype=np.float32)
        x = torch.from_numpy(a).to(dev, getattr(torch, dtype))
        kw = dict(k=k, stride=s, pad=p, mode=mode)
        out = pool2d(x, **kw)
        nbits = bits_differ(out, pool2d_plain(x, **kw))
        exact &= nbits == 0
        xn = x.permute(0, 3, 1, 2)              # NCHW view, channels-last
        if mode == "max":
            lib = lambda: F.max_pool2d(xn, k, s, p)
        else:
            lib = lambda: F.avg_pool2d(xn, k, s, p, count_include_pad=True)
        ms = graph_ms(lambda: pool2d(x, **kw), reps=10)
        lib_ms = graph_ms(lib, reps=10)
        nbytes = (x.numel() + out.numel()) * x.element_size()
        bound = 1e3 * nbytes / HBM_BYTES_PER_S
        print(json.dumps({
            "label": args.label, "case": f"{name}/{dtype}",
            "shape": list(shape), "bits_differ": nbits, "ms": ms,
            "library_ms": lib_ms, "bound_ms": bound,
            "share_of_bytes_rate": bound / ms}), flush=True)
        del x, xn, out
    return 0 if exact else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
