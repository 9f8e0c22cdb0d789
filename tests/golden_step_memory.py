"""Reckon what the JAX package's jitted train step holds on the CPU for a
golden run of ``tests/make_train_golden.py``, before drawing its weights:
XLA's own memory analysis of the compiled step (its arguments, its outputs,
the bytes the outputs alias and its temporaries), compiled from the
params' shapes alone.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/golden_step_memory.py \\
        gemma2-27b --layers 2 --batch 4 [--seq-len 256] [--loss-chunks 1] \\
        [--grad-accum N] [--no-donate]

The step is ``make_train_step`` in f32 at the config's published width,
jitted with ``donate_argnums=(0, 1)`` as the reference's ``Trainer`` jits
it unless ``--no-donate``; ``--grad-accum`` sets the config's
``grad_accum`` (the microbatches of the reference's ``lax.scan``), else
the published one stands. Its peak is about the arguments plus the
temporaries (plus the outputs without donation). Prints one JSON line.
Compiling a full-width config takes a minute and a few GB, not the step's
memory. Not a test (pytest collects ``test_*.py`` only).
"""
from __future__ import annotations

import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import ARCHS
from repro.models import build_model
from repro.train.optimizer import AdamWConfig, init_opt_state
from repro.train.step import make_train_step


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("name")
    ap.add_argument("--layers", type=int, required=True)
    ap.add_argument("--batch", type=int, required=True)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--loss-chunks", type=int, default=None)
    ap.add_argument("--grad-accum", type=int, default=None)
    ap.add_argument("--no-donate", action="store_true")
    a = ap.parse_args()
    over = dict(dtype="float32", n_layers=a.layers)
    if a.loss_chunks:
        over["loss_chunks"] = a.loss_chunks
    if a.grad_accum:
        over["grad_accum"] = a.grad_accum
    cfg = ARCHS[a.name].replace(**over)
    model = build_model(cfg)

    def abstract(t):
        if isinstance(t, dict):
            return {k: abstract(v) for k, v in t.items()}
        return jax.ShapeDtypeStruct(t.shape, jnp.float32)
    params = abstract(model.specs())
    opt_state = jax.eval_shape(init_opt_state, params)
    tok = jax.ShapeDtypeStruct((a.batch, a.seq_len), jnp.int32)
    step = jax.jit(make_train_step(model, AdamWConfig()),
                   donate_argnums=() if a.no_donate else (0, 1))
    m = step.lower(params, opt_state, {"tokens": tok, "labels": tok}) \
        .compile().memory_analysis()
    n = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(params))
    out = {k: getattr(m, f"{k}_size_in_bytes")
           for k in ("argument", "output", "alias", "temp")}
    peak = out["argument"] + out["temp"] + out["output"] - out["alias"]
    print(json.dumps(dict(config=a.name, overrides=over, batch=a.batch,
                          seq_len=a.seq_len, donate=not a.no_donate,
                          params=n, bytes=out, reckoned_peak_gb=peak / 1e9)))


if __name__ == "__main__":
    main()
