"""Time Qwen3-0.6B's serving steps and its training step on the card, as
``chip_smoke.py`` phases 7 and 8 run them, for one checkout's
``repro_torch``: the host cost of a change to the model code shows here.

    python3 tools/lm_host_timing.py [--src DIR] [--label NAME] [--reps N]

``--src`` is the ``src`` directory whose ``repro_torch`` is imported
(default: this checkout's), so another checkout, such as the parent commit
unpacked with ``git archive``, is timed by the same code; run both on one
card, one after the other (parent, change, change, parent), to compare
them. Serving: full width and depth in bf16 over f32 master weights from a
seeded generator, 4 prompts of 1024 seeded tokens, a warm-up generation,
then ``reps`` generations of 32 greedy steps through ``ServeSession``,
each step timed on the host clock between synchronizes (phase 7's way).
Training: phase 8's configuration (remat "full", loss in 8 chunks, 4 x
2048 tokens, AdamW) through ``Trainer.step_fn`` on its first batch,
``reps + 1`` steps timed the same way, the first one apart (it builds
what later steps reuse). Prints the card's name and power limit
(``nvidia-smi``), then one JSON line. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH, BATCH, PROMPT, STEPS = "qwen3-0.6b", 4, 1024, 32
TRAIN_BATCH, TRAIN_SEQ = 4, 2048


def serve_ms(torch, device, reps: int) -> dict:
    """Prefill ms and decode ms a step of ``reps`` generations."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import build_model
    from repro_torch.serve.session import ServeSession
    cfg = ARCHS[ARCH]
    model = build_model(cfg)
    sess = ServeSession(model, model.init(
        torch.Generator(device=device).manual_seed(0), device), device=device)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (BATCH, PROMPT), dtype=np.int32)
    sess.generate(prompts[:, :64], 2)                   # warm-up, untimed
    times: list = []

    def timed(step):
        def wrapped(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(*args)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            return out
        return wrapped
    sess._prefill, sess._decode = timed(sess._prefill), timed(sess._decode)
    prefill, decode = [], []
    for _ in range(reps):
        times.clear()
        sess.generate(prompts, STEPS)
        prefill.append(times[0] * 1e3)
        decode.append(statistics.median(times[1:]) * 1e3)
    return {"prefill_ms": prefill, "decode_ms_per_step_median": decode}


def train_ms(torch, device, reps: int) -> dict:
    """The first step's ms and the next ``reps`` steps' ms."""
    from repro_torch.configs import ARCHS
    from repro_torch.train.data import DataConfig, DataLoader
    from repro_torch.train.loop import Trainer, TrainerConfig
    from repro_torch.train.optimizer import AdamWConfig
    cfg = ARCHS[ARCH].replace(remat=True, remat_policy="full", loss_chunks=8)
    tr = Trainer(cfg, DataConfig(seed=0, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ),
                 AdamWConfig(lr=1e-4, warmup_steps=2, total_steps=100),
                 TrainerConfig(seed=0), device=device)
    params, opt_state, _ = tr.init_or_resume()
    loader = DataLoader(tr.data_cfg, cfg)
    try:
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in next(loader).items()}
    finally:
        loader.close()
    steps, losses = [], []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, metrics = tr.step_fn(params, opt_state, batch)
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
    return {"first_step_ms": steps[0], "step_ms": steps[1:], "loss": losses}


def main(argv: list) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("lm_host_timing: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    sys.path.insert(0, os.path.abspath(args.src))
    device = torch.device("cuda")
    row = {"label": args.label, "card": card, **serve_ms(torch, device,
                                                         args.reps)}
    torch.cuda.empty_cache()
    row.update(train_ms(torch, device, args.reps))
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
