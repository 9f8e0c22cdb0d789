"""Write the golden files of ``chip_smoke.py`` phase 7: the JAX package's
``ServeSession`` on the CPU, greedy generation in f32 from weights and
prompts that numpy makes from a seed.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/make_lm_golden.py
    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/make_lm_golden.py --recurrent
    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/make_lm_golden.py --moe
    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/make_lm_golden.py --vlm-audio

Not a test (pytest collects ``test_*.py`` only). The first writes
``golden/lm_session_f32.json``, runs each in f32:

- ``qwen3-0.6b`` at full width (d_model 1024, 16/8 heads of 128, d_ff 3072,
  vocab 151936) with its depth cut to ``QWEN3_LAYERS`` of 28, so that the
  JAX run on a CPU stays small (0.9 GB of weights);
- ``gemma2-27b``'s smoke config, whose local layers (window 8) see a
  32-token prompt: the run that holds the sliding window.

``--recurrent`` writes ``golden/lm_session_recurrent_f32.json`` (~4 min,
~14 GB at its peak), runs each in f32:

- ``rwkv6-1.6b`` at full width (d_model 2048, 32 heads of 64, d_ff 7168,
  vocab 65536) cut to ``RWKV_LAYERS`` of 24 layers, 2 prompts of 2048
  tokens: two whole ``scan_chunk``s of 1024, the state carried between;
- ``rwkv6-1.6b``'s smoke config with 40-token prompts: one padded chunk;
- ``recurrentgemma-9b`` at full width (d_model and lru_width 4096, 16
  heads of 256 over 1 KV head, d_ff 12288, vocab 256000) cut to
  ``GRIFFIN_LAYERS`` of 38, one pattern group (RG-LRU, RG-LRU, local
  attention; 1.64 B parameters, 6.6 GB), 2 prompts of 64 tokens;
- ``recurrentgemma-9b``'s smoke config (window 8), 32-token prompts: the
  window and the ring wrapping on a local layer.

``--moe`` writes ``golden/lm_session_moe_f32.json`` (~1 min, ~10 GB at
its peak), runs each in f32:

- ``moonshot-v1-16b-a3b`` at full width (d_model 2048, 16 heads of 128, 64
  experts of moe_d_ff 1408, top-6, vocab 163840) cut to ``MOE_LAYERS`` of
  48 (1.24 B parameters, 5.0 GB), 2 prompts of 64 tokens;
- ``moonshot-v1-16b-a3b``'s and ``mixtral-8x22b``'s smoke configs (4
  experts, top-2), 32-token prompts.

``--vlm-audio`` writes ``golden/lm_session_vlm_audio_f32.json``, runs
each in f32:

- ``qwen2-vl-2b`` at full width (d_model 1536, 12/2 heads of 128, d_ff
  8960, vocab 151936, qkv bias, M-RoPE sections (16, 24, 24)) cut to
  ``VLM_LAYERS`` of 28 (0.65 B parameters), 2 sequences of 64 positions;
- ``qwen2-vl-2b``'s smoke config, 2 sequences of 32 positions;
- ``musicgen-large`` at full width (d_model 2048, 32 heads of 64, d_ff
  8192, vocab 2048, 4 codebooks) cut to ``AUDIO_LAYERS`` of 48 (0.3 B
  parameters), prompts (2, 4, 64);
- ``musicgen-large``'s smoke config (2 codebooks), prompts (2, 2, 32).

A vlm run feeds embeddings, not tokens, which ``ServeSession.generate``
does not pass: it drives ``make_prefill_step`` and ``make_decode_step``
itself (``vlm_generate``). The embeddings are numpy's standard normal
draws from ``embed_seed``, (B, S + steps, d_model): the prefill takes the
first S at the positions of one image of ``image`` = (t, h, w) patches
followed by text (``chip_smoke.image_text_positions``), and each decode
step the next one, teacher-forced, at position S + step on all three
M-RoPE rows (the reference's ``decode_step``). The run keeps the positions and a sha256 of
the embeddings; its ``tokens`` are the greedy choices of each step's
logits, which no step feeds back.

Each step's logits are kept as rows of the vocabulary: (B, V), or (B * K,
V) for a model of K codebooks, one row per sequence and codebook, so that
each codebook has its own top 8 (the earlier files' models have no
codebooks, and their rows are the same either way).

A MoE run also keeps ``router_margin``: the smallest gap between the K-th
and the (K+1)-th largest router probability over every token, layer and
step, where a routing choice would flip first.

Per run the file keeps the config's name and overrides, the seeds, the
prompts, a sha256 of the weights (``convert.tree_sha256``: whether numpy
made the same ones on the card's host), the generated tokens and, at each
step (the prefill's last position, then every decode step), the 8 largest
logits of each sequence with their indices. ``chip_smoke.py`` reads only
this JSON.
"""
import contextlib
import importlib.util
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import ARCHS, SMOKE_ARCHS
from repro.models import build_model
from repro.serve.engine import ServeSession
from repro.serve.session import greedy_token
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.configs import SMOKE_ARCHS as T_SMOKE
from repro_torch.models.convert import numpy_params, tree_sha256

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
# the vlm runs lay out their positions as chip_smoke.py's bf16 run does
_spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(
    os.path.dirname(GOLDEN), os.pardir, "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)
OUT = os.path.join(GOLDEN, "lm_session_f32.json")
OUT_RECURRENT = os.path.join(GOLDEN, "lm_session_recurrent_f32.json")
OUT_MOE = os.path.join(GOLDEN, "lm_session_moe_f32.json")
OUT_VLM_AUDIO = os.path.join(GOLDEN, "lm_session_vlm_audio_f32.json")
QWEN3_LAYERS = 4
RWKV_LAYERS = 2
GRIFFIN_LAYERS = 3
MOE_LAYERS = 1
VLM_LAYERS = 4
AUDIO_LAYERS = 4
TOP = 8
RUNS = [
    dict(name="qwen3-0.6b", smoke=False,
         overrides=dict(dtype="float32", n_layers=QWEN3_LAYERS),
         seed=0, prompt_seed=1, batch=2, prompt_len=64, steps=8),
    dict(name="gemma2-27b", smoke=True, overrides=dict(dtype="float32"),
         seed=0, prompt_seed=1, batch=2, prompt_len=32, steps=8),
]
RECURRENT_RUNS = [
    dict(name="rwkv6-1.6b", smoke=False,
         overrides=dict(dtype="float32", n_layers=RWKV_LAYERS),
         seed=0, prompt_seed=1, batch=2, prompt_len=2048, steps=8),
    # prompt seed 2: seed 1's prompts leave top-1 margins under chip_smoke's
    # LM_F32_TOL at steps 1 and 2, after which no token would be compared
    dict(name="rwkv6-1.6b", smoke=True, overrides=dict(dtype="float32"),
         seed=0, prompt_seed=2, batch=2, prompt_len=40, steps=8),
    dict(name="recurrentgemma-9b", smoke=False,
         overrides=dict(dtype="float32", n_layers=GRIFFIN_LAYERS),
         seed=0, prompt_seed=1, batch=2, prompt_len=64, steps=8),
    dict(name="recurrentgemma-9b", smoke=True,
         overrides=dict(dtype="float32"),
         seed=0, prompt_seed=1, batch=2, prompt_len=32, steps=8),
]
MOE_RUNS = [
    dict(name="moonshot-v1-16b-a3b", smoke=False,
         overrides=dict(dtype="float32", n_layers=MOE_LAYERS),
         seed=0, prompt_seed=1, batch=2, prompt_len=64, steps=8),
    dict(name="moonshot-v1-16b-a3b", smoke=True,
         overrides=dict(dtype="float32"),
         seed=0, prompt_seed=1, batch=2, prompt_len=32, steps=8),
    dict(name="mixtral-8x22b", smoke=True, overrides=dict(dtype="float32"),
         seed=0, prompt_seed=1, batch=2, prompt_len=32, steps=8),
]
# a vlm run's prompt: one image of ``image`` (t, h, w) patches, then text
# up to ``prompt_len`` positions
VLM_AUDIO_RUNS = [
    dict(name="qwen2-vl-2b", smoke=False,
         overrides=dict(dtype="float32", n_layers=VLM_LAYERS),
         seed=0, embed_seed=1, batch=2, image=(1, 6, 8), prompt_len=64,
         steps=8),
    dict(name="qwen2-vl-2b", smoke=True, overrides=dict(dtype="float32"),
         seed=0, embed_seed=1, batch=2, image=(1, 4, 4), prompt_len=32,
         steps=8),
    dict(name="musicgen-large", smoke=False,
         overrides=dict(dtype="float32", n_layers=AUDIO_LAYERS),
         seed=0, prompt_seed=1, batch=2, prompt_len=64, steps=8),
    # prompt seed 2: seed 1's prompts leave a top-1 margin under
    # chip_smoke's LM_F32_TOL at step 6, after which no token would be
    # compared
    dict(name="musicgen-large", smoke=True, overrides=dict(dtype="float32"),
         seed=0, prompt_seed=2, batch=2, prompt_len=32, steps=8),
]
MODES = {(): (RUNS, OUT), ("--recurrent",): (RECURRENT_RUNS, OUT_RECURRENT),
         ("--moe",): (MOE_RUNS, OUT_MOE),
         ("--vlm-audio",): (VLM_AUDIO_RUNS, OUT_VLM_AUDIO)}


@contextlib.contextmanager
def router_margins(margins: list):
    """``jax.lax.top_k`` (which only the MoE router calls) taking k + 1
    values, the (k+1)-th only to append the smallest K-th minus (K+1)-th
    gap of each call to ``margins`` (a host callback under ``jit``); the
    top k it returns are ``top_k``'s own."""
    real = jax.lax.top_k

    def top_k(x, k):
        vals, idx = real(x, k + 1)
        jax.debug.callback(lambda v: margins.append(float(np.min(
            v[..., k - 1] - v[..., k]))), vals)
        return vals[..., :k], idx[..., :k]
    jax.lax.top_k = top_k
    try:
        yield
    finally:
        jax.lax.top_k = real


def _to_jax(tree):
    """``tree``'s numpy leaves as JAX arrays, each numpy leaf dropped once
    it is copied, so that the two copies of the weights never coexist."""
    out = {}
    for k in list(tree):
        v = tree.pop(k)
        out[k] = _to_jax(v) if isinstance(v, dict) else jnp.array(v)
    return out


def vlm_generate(prefill, decode, params, embeds, positions, steps: int):
    """A vlm's generation, teacher-forced: the prefill of the first S
    embeddings at ``positions`` (3, B, S), then ``steps`` decode steps,
    each fed the next embedding at position S + step. Returns the greedy
    token of each step's logits but the last, (B, steps)."""
    S = positions.shape[-1]
    logits, caches = prefill(params, {"embeds": embeds[:, :S],
                                      "positions": positions})
    out = []
    for step in range(steps):
        out.append(greedy_token(logits).reshape(logits.shape[0], -1))
        nxt = embeds[:, S + step:S + step + 1]
        logits, caches = decode(params, {"embeds": nxt}, caches,
                                jnp.asarray(S + step, jnp.int32))
    return jnp.concatenate(out, axis=-1)


def golden_run(run: dict) -> dict:
    cfg = (SMOKE_ARCHS if run["smoke"] else ARCHS)[run["name"]].replace(
        **run["overrides"])
    tcfg = (T_SMOKE if run["smoke"] else T_ARCHS)[run["name"]].replace(
        **run["overrides"])
    weights = numpy_params(tcfg, run["seed"])
    sha = tree_sha256(weights)
    sess = ServeSession(build_model(cfg), _to_jax(weights))
    seen = []
    prefill, decode = sess._prefill, sess._decode

    def keep(step):
        def wrapped(*args):
            out = step(*args)
            logits = np.asarray(out[0], np.float32)
            seen.append(logits.reshape(-1, logits.shape[-1]))
            return out
        return wrapped
    sess._prefill, sess._decode = keep(prefill), keep(decode)
    B, S = run["batch"], run["prompt_len"]
    margins: list = []
    inputs: dict = {}
    if cfg.family == "vlm":
        embeds = np.random.default_rng(run["embed_seed"]).standard_normal(
            (B, S + run["steps"], cfg.d_model), dtype=np.float32)
        pos = chip_smoke.image_text_positions(B, run["image"], S)
        out = np.asarray(vlm_generate(
            sess._prefill, sess._decode, sess.params, jnp.asarray(embeds),
            jnp.asarray(pos), run["steps"]))
        inputs.update(embeds_sha256=tree_sha256(embeds),
                      positions=pos.tolist())
    else:
        shape = (B, cfg.n_codebooks, S) if cfg.n_codebooks else (B, S)
        toks = np.random.default_rng(run["prompt_seed"]).integers(
            0, cfg.vocab_size, shape, dtype=np.int32)
        with router_margins(margins):
            out = np.asarray(sess.generate(jnp.asarray(toks), run["steps"]))
        inputs["prompts"] = toks.tolist()
    top = []
    for logits in seen:
        idx = np.argsort(-logits, axis=-1, kind="stable")[:, :TOP]
        top.append({"index": idx.tolist(),
                    "value": np.take_along_axis(logits, idx, -1).tolist()})
    extra = {"router_margin": min(margins)} if margins else {}
    return dict(run, weights_sha256=sha, **inputs, tokens=out.tolist(),
                top=top, **extra)


def main(argv: list) -> None:
    if tuple(argv[1:]) not in MODES:
        raise SystemExit(f"usage: {argv[0]} [--recurrent | --moe | "
                         f"--vlm-audio]")
    specs, out_path = MODES[tuple(argv[1:])]
    runs = [golden_run(r) for r in specs]
    os.makedirs(GOLDEN, exist_ok=True)
    with open(out_path, "w") as f:
        json.dump({"made_by": "tests/make_lm_golden.py", "top": TOP,
                   "runs": runs}, f, indent=1)
        f.write("\n")
    for r in runs:
        print(r["name"], "tokens", r["tokens"],
              "router margin", r.get("router_margin"))


if __name__ == "__main__":
    main(sys.argv)
