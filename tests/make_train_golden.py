"""Write the golden file of ``chip_smoke.py`` phase 8: the JAX package's
``make_train_step`` on the CPU, three AdamW steps in f32 from weights and
batches that numpy makes from a seed.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/make_train_golden.py

Not a test (pytest collects ``test_*.py`` only). Writes
``golden/train_f32.json`` (~1 min, ~6 GB at its peak), runs each in f32:

- ``qwen3-0.6b`` at full width (d_model 1024, 16/8 heads of 128, d_ff 3072,
  vocab 151936) with its depth cut to ``QWEN3_LAYERS`` of 28, as
  tests/make_lm_golden.py cuts it, batch 2 x 256 tokens;
- ``gemma2-27b``'s smoke config (local layers with a window of 8, the
  attention and final logit softcaps, its query scale), batch 2 x 32.

Per run the file keeps the config's name and overrides, the weights' seed
and sha256 (``convert.tree_sha256``: whether numpy made the same ones on
the card's host), the data and AdamW settings, and per step the batch
(its ``tokens`` and ``labels``: ``Generator.zipf`` draws other tokens
under other numpy versions, so the card's host reads them from here),
the loss, xent, moe_aux, grad_norm and lr. ``chip_smoke.py`` reads only
this JSON.
"""
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import ARCHS, SMOKE_ARCHS
from repro.models import build_model
from repro.train.optimizer import AdamWConfig, init_opt_state
from repro.train.step import make_train_step
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.configs import SMOKE_ARCHS as T_SMOKE
from repro_torch.models.convert import numpy_params, tree_sha256
from repro_torch.train.data import DataConfig, make_batch

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
OUT = os.path.join(GOLDEN, "train_f32.json")
QWEN3_LAYERS = 4
OPT = dict(lr=1e-3, warmup_steps=0, total_steps=10)
RUNS = [
    dict(name="qwen3-0.6b", smoke=False,
         overrides=dict(dtype="float32", n_layers=QWEN3_LAYERS), seed=0,
         data=dict(seed=1, batch=2, seq_len=256), opt=OPT, steps=3),
    dict(name="gemma2-27b", smoke=True, overrides=dict(dtype="float32"),
         seed=0, data=dict(seed=1, batch=2, seq_len=32), opt=OPT, steps=3),
]
METRICS = ("loss", "xent", "moe_aux", "grad_norm", "lr")


def golden_run(run: dict) -> dict:
    cfg = (SMOKE_ARCHS if run["smoke"] else ARCHS)[run["name"]].replace(
        **run["overrides"])
    tcfg = (T_SMOKE if run["smoke"] else T_ARCHS)[run["name"]].replace(
        **run["overrides"])
    weights = numpy_params(tcfg, run["seed"])
    sha = tree_sha256(weights)
    params = jax.tree_util.tree_map(jnp.asarray, weights)
    del weights
    opt_state = init_opt_state(params)
    step_fn = jax.jit(make_train_step(build_model(cfg),
                                      AdamWConfig(**run["opt"])))
    dcfg = DataConfig(**run["data"])
    per_step = []
    for s in range(run["steps"]):
        batch = make_batch(dcfg, tcfg, s)
        params, opt_state, m = step_fn(
            params, opt_state, jax.tree_util.tree_map(jnp.asarray, batch))
        per_step.append({**{k: v.tolist() for k, v in batch.items()},
                         **{k: float(np.asarray(m[k])) for k in METRICS}})
    return dict(run, weights_sha256=sha, per_step=per_step)


def main(argv: list) -> None:
    if argv[1:]:
        raise SystemExit(f"usage: {argv[0]}")
    runs = [golden_run(r) for r in RUNS]
    os.makedirs(GOLDEN, exist_ok=True)
    with open(OUT, "w") as f:
        json.dump({"made_by": "tests/make_train_golden.py", "runs": runs}, f,
                  indent=1)
        f.write("\n")
    for r in runs:
        print(r["name"], [(x["loss"], x["grad_norm"]) for x in r["per_step"]])


if __name__ == "__main__":
    main(sys.argv)
