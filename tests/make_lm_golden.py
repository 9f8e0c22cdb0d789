"""Write the golden file of ``chip_smoke.py`` phase 7: the JAX package's
``ServeSession`` on the CPU, greedy generation in f32 from weights and
prompts that numpy makes from a seed.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/make_lm_golden.py

Not a test (pytest collects ``test_*.py`` only). Runs, each in f32:

- ``qwen3-0.6b`` at full width (d_model 1024, 16/8 heads of 128, d_ff 3072,
  vocab 151936) with its depth cut to ``QWEN3_LAYERS`` of 28, so that the
  JAX run on a CPU stays small (0.9 GB of weights);
- ``gemma2-27b``'s smoke config, whose local layers (window 8) see a
  32-token prompt: the run that holds the sliding window.

Per run the file keeps the config's name and overrides, the seeds, the
prompts, a sha256 of the weights (``convert.tree_sha256``: whether numpy
made the same ones on the card's host), the generated tokens and, at each
step (the prefill's last position, then every decode step), the 8 largest
logits of each sequence with their indices. ``chip_smoke.py`` reads only
this JSON.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import ARCHS, SMOKE_ARCHS
from repro.models import build_model
from repro.serve.engine import ServeSession
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.configs import SMOKE_ARCHS as T_SMOKE
from repro_torch.models.convert import numpy_params, tree_sha256

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                   "lm_session_f32.json")
QWEN3_LAYERS = 4
TOP = 8
RUNS = [
    dict(name="qwen3-0.6b", smoke=False,
         overrides=dict(dtype="float32", n_layers=QWEN3_LAYERS),
         seed=0, prompt_seed=1, batch=2, prompt_len=64, steps=8),
    dict(name="gemma2-27b", smoke=True, overrides=dict(dtype="float32"),
         seed=0, prompt_seed=1, batch=2, prompt_len=32, steps=8),
]


def golden_run(run: dict) -> dict:
    cfg = (SMOKE_ARCHS if run["smoke"] else ARCHS)[run["name"]].replace(
        **run["overrides"])
    tcfg = (T_SMOKE if run["smoke"] else T_ARCHS)[run["name"]].replace(
        **run["overrides"])
    weights = numpy_params(tcfg, run["seed"])
    sess = ServeSession(build_model(cfg),
                        jax.tree_util.tree_map(jnp.asarray, weights))
    seen = []
    prefill, decode = sess._prefill, sess._decode

    def keep(step):
        def wrapped(*args):
            out = step(*args)
            seen.append(np.asarray(out[0], np.float32).reshape(
                run["batch"], -1))
            return out
        return wrapped
    sess._prefill, sess._decode = keep(prefill), keep(decode)
    toks = np.random.default_rng(run["prompt_seed"]).integers(
        0, cfg.vocab_size, (run["batch"], run["prompt_len"]), dtype=np.int32)
    out = np.asarray(sess.generate(jnp.asarray(toks), run["steps"]))
    top = []
    for logits in seen:
        idx = np.argsort(-logits, axis=-1, kind="stable")[:, :TOP]
        top.append({"index": idx.tolist(),
                    "value": np.take_along_axis(logits, idx, -1).tolist()})
    return dict(run, weights_sha256=tree_sha256(weights),
                prompts=toks.tolist(), tokens=out.tolist(), top=top)


def main() -> None:
    runs = [golden_run(r) for r in RUNS]
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump({"made_by": "tests/make_lm_golden.py", "top": TOP,
                   "runs": runs}, f, indent=1)
        f.write("\n")
    for r in runs:
        print(r["name"], "tokens", r["tokens"])


if __name__ == "__main__":
    main()
