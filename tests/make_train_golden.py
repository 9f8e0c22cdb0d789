"""Write the golden file of ``chip_smoke.py`` phase 8: the JAX package's
``make_train_step`` on the CPU, three AdamW steps in f32 from weights and
batches that numpy makes from a seed.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/make_train_golden.py
    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/make_train_golden.py --families
    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/make_train_golden.py --full-width
    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/make_train_golden.py --past-card
    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/make_train_golden.py --past-card-large

Not a test (pytest collects ``test_*.py`` only). The first writes
``golden/train_f32.json`` (~1 min, ~6 GB at its peak), runs each in f32:

- ``qwen3-0.6b`` at full width (d_model 1024, 16/8 heads of 128, d_ff 3072,
  vocab 151936) with its depth cut to ``QWEN3_LAYERS`` of 28, as
  tests/make_lm_golden.py cuts it, batch 2 x 256 tokens;
- ``gemma2-27b``'s smoke config (local layers with a window of 8, the
  attention and final logit softcaps, its query scale), batch 2 x 32.

``--families`` writes ``golden/train_families_f32.json``, runs each in
f32:

- the smoke configs of ``mixtral-8x22b`` (the MoE dispatch and its aux
  loss), ``rwkv6-1.6b`` (the chunked WKV: 64 tokens, two chunks of 32),
  ``recurrentgemma-9b`` (the RG-LRU scan and local attention),
  ``qwen2-vl-2b`` (embeddings for tokens, at ``make_batch``'s M-RoPE
  positions: the sequence index on all three rows) and
  ``musicgen-large`` (codebooks), batch 2 x 32 unless said;
- ``qwen3-0.6b`` at full width cut to ``QWEN3_LAYERS`` with ``grad_accum``
  2, batch 4 x 256: the reference's ``lax.scan`` over two microbatches.

``--full-width`` writes ``golden/train_full_width_f32.json``: the
configs that ``chip_smoke.py`` phase 8 trains whole in bf16, at their
published widths with the depth cut to ``FULL_WIDTH_LAYERS``, in f32:

- ``qwen2-vl-2b`` (12/2 heads of 128, a GQA group of 6), batch 2 x 256 of
  ``make_batch``'s embeddings at its M-RoPE positions;
- ``rwkv6-1.6b``, batch 2 x 2048: two of its ``scan_chunk``s of 1024, so
  the WKV carries its state from one chunk into the next;
- ``musicgen-large`` (32 heads of 64, 4 codebooks) under its own
  ``grad_accum`` of 2, batch 4 x 4 codebooks x 256;
- ``musicgen-large``'s smoke config under ``grad_accum`` 2, batch 4 x 32:
  the one run of the file the CPU tests can afford, which sees the
  microbatch sum.

A full-width run's embeddings (786,432 floats a step) are kept by their
sha256 (``embeds_sha256``), not their values: ``standard_normal`` is the
first draw of ``make_batch``'s generator, so the card's host makes them
again and checks the hash. The mode takes ~3 min and ~10 GB at the
peak.

``--past-card`` writes ``golden/train_past_card_f32.json``: the configs
whose train state exceeds one card, which ``chip_smoke.py`` phase 8
trains in bf16 at full width and cut depth, here at their published
widths with the depth cut to one pattern group and the loss in one chunk
(``loss_chunks`` 1, which orders the loss's sum and leaves every shape as
published), in f32, each under its own ``grad_accum``:

- ``moonshot-v1-16b-a3b``, 1 layer (64 experts, top 6, the load-balance
  aux loss), batch 2 x 256 in 2 microbatches;
- ``recurrentgemma-9b``, 3 layers (``rglru, rglru, attn_local``: the RG-LRU
  scan at ``lru_width`` 4096, MQA of 16 query heads over 1 KV head of
  256), batch 2 x 256 in 2 microbatches;
- ``gemma2-27b``, 2 layers (a local/global pair: the attention softcap of
  50, the final softcap of 30, the post norms), batch 4 x 256 in 4
  microbatches;
- ``moonshot-v1-16b-a3b``'s smoke config, batch 2 x 32: the one run of the
  file the CPU tests can afford, the MoE family's training golden.

Each MoE run keeps ``router_margin``, as tests/make_lm_golden.py does: the
smallest gap between the K-th and the (K+1)-th largest router probability
over every token, layer, microbatch and step (the forward and the
backward's recompute), where a routing choice would flip first.

The step is jitted with ``donate_argnums=(0, 1)``, as the reference's
``Trainer`` jits it. On an 8-core x86 host the mode took 7.5 min, its runs
74.4, 124.9, 243.0 and 5.1 s, at peaks of resident memory of 25.72,
33.90, 47.43 and 1.19 GB. XLA's own reckoning of the full-width steps'
buffers (``tests/golden_step_memory.py``) is 24.83, 32.85 and 46.25 GB
donated and 29.82, 39.82 and 55.60 GB without: each peak sits within
1.2 GB over the donated figure, so the CPU backend took the donation.

``--past-card-large`` writes ``golden/train_past_card_large_f32.json``:
the three configs whose train state exceeds one card that ``--past-card``
left out, at their published widths cut to one layer (each has a pattern
of one layer), the loss in one chunk, f32, each under its own
``grad_accum``, lr 1e-4, card only:

- ``qwen2.5-32b`` (40 query heads over 8, a GQA group of 5, the q/k/v
  bias, vocab 152064, an untied head; 2.04 B parameters), batch 4 x 256
  in 4 microbatches;
- ``deepseek-67b`` (64 over 8, a group of 8, d_model 8192; 2.37 B),
  batch 8 x 256 in 8;
- ``mixtral-8x22b`` (8 experts of (6144, 16384), top 2, the aux loss,
  a window of 4096; 2.91 B), batch 4 x 256 in 4, its router margin kept;
- the smoke configs of ``qwen2.5-32b`` at 10 query heads over 2 (a group
  of 5, the bias) and ``deepseek-67b`` at 16 over 2 (8), batch 2 x 32:
  the runs the CPU tests afford.

Run it alone: the Mixtral run's resident peak sits at the edge of a
62 GB host (see ``PAST_CARD_LARGE_RUNS``).

Every mode jits the step with that donation, which changes no value: the
default mode's file is byte for byte the one made without it.

Per run the file keeps the config's name and overrides, the weights' seed
and sha256 (``convert.tree_sha256``: whether numpy made the same ones on
the card's host), the data and AdamW settings, and per step the batch
(its ``tokens`` and ``labels``, a vlm's ``embeds``, ``positions`` and
``labels``: ``Generator.zipf`` draws other tokens under other numpy
versions, so the card's host reads them from here),
the loss, xent, moe_aux, grad_norm and lr. ``chip_smoke.py`` reads only
this JSON.
"""
import contextlib
import json
import os
import sys
import threading
import time

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
OUT_FAMILIES = os.path.join(GOLDEN, "train_families_f32.json")
QWEN3_LAYERS = 4
OPT = dict(lr=1e-3, warmup_steps=0, total_steps=10)
RUNS = [
    dict(name="qwen3-0.6b", smoke=False,
         overrides=dict(dtype="float32", n_layers=QWEN3_LAYERS), seed=0,
         data=dict(seed=1, batch=2, seq_len=256), opt=OPT, steps=3),
    dict(name="gemma2-27b", smoke=True, overrides=dict(dtype="float32"),
         seed=0, data=dict(seed=1, batch=2, seq_len=32), opt=OPT, steps=3),
]
FAMILY_RUNS = [
    dict(name=name, smoke=True, overrides=dict(dtype="float32"), seed=0,
         data=dict(seed=1, batch=2, seq_len=seq_len), opt=OPT, steps=3)
    for name, seq_len in (("mixtral-8x22b", 32), ("rwkv6-1.6b", 64),
                          ("recurrentgemma-9b", 32), ("qwen2-vl-2b", 32),
                          ("musicgen-large", 32))] + [
    dict(name="qwen3-0.6b", smoke=False,
         overrides=dict(dtype="float32", n_layers=QWEN3_LAYERS, grad_accum=2),
         seed=0, data=dict(seed=1, batch=4, seq_len=256), opt=OPT, steps=3),
]
OUT_FULL_WIDTH = os.path.join(GOLDEN, "train_full_width_f32.json")
FULL_WIDTH_LAYERS = 2
# the full-width runs at a tenth of OPT's rate: at 1e-3 RWKV-6's loss
# doubles at the second step (11.55 -> 22.64) and MusicGen-Large's climbs
# at the third (6.73 -> 10.61), and a diverging run amplifies rounding:
# the port on the CPU lay 8.5e-6 from RWKV-6's third loss, against
# chip_smoke.py's TRAIN_LOSS_RTOL of 1e-5 (1.1e-7 at 1e-4)
OPT_FULL_WIDTH = dict(OPT, lr=1e-4)
FULL_WIDTH_RUNS = [
    dict(name=name, smoke=False,
         overrides=dict(dtype="float32", n_layers=FULL_WIDTH_LAYERS), seed=0,
         data=dict(seed=1, batch=batch, seq_len=seq_len), opt=OPT_FULL_WIDTH,
         steps=3)
    for name, batch, seq_len in (("qwen2-vl-2b", 2, 256),
                                 ("rwkv6-1.6b", 2, 2048),
                                 ("musicgen-large", 4, 256))] + [
    dict(name="musicgen-large", smoke=True,
         overrides=dict(dtype="float32", grad_accum=2), seed=0,
         data=dict(seed=1, batch=4, seq_len=32), opt=OPT, steps=3),
]
OUT_PAST_CARD = os.path.join(GOLDEN, "train_past_card_f32.json")
# depths of one pattern group: Moonshot's (attn_global,),
# RecurrentGemma's (rglru, rglru, attn_local), Gemma-2's local/global pair.
# The loss in one chunk: the reference's chunk loop is unrolled, and XLA's
# CPU build holds every chunk's f32 head gradient until it sums them (8 x
# 4.7 GB for Gemma-2's 256000 x 4608 embedding: its step's buffers 75.8
# GB under 8 chunks, 46.3 GB under 1, by tests/golden_step_memory.py)
PAST_CARD_RUNS = [
    dict(name=name, smoke=False,
         overrides=dict(dtype="float32", n_layers=layers, loss_chunks=1),
         seed=0, data=dict(seed=1, batch=batch, seq_len=256),
         opt=OPT_FULL_WIDTH, steps=3)
    for name, layers, batch in (("moonshot-v1-16b-a3b", 1, 2),
                                ("recurrentgemma-9b", 3, 2),
                                ("gemma2-27b", 2, 4))] + [
    dict(name="moonshot-v1-16b-a3b", smoke=True,
         overrides=dict(dtype="float32"), seed=0,
         data=dict(seed=1, batch=2, seq_len=32), opt=OPT_FULL_WIDTH,
         steps=3),
]
OUT_PAST_CARD_LARGE = os.path.join(GOLDEN, "train_past_card_large_f32.json")
# one layer each (every one of the three has a pattern of one layer), the
# loss in one chunk; each a microbatch of one sequence under its own
# grad_accum (4, 8, 4). The peak of each step's buffers as XLA reckons it
# (tests/golden_step_memory.py NAME --layers 1 --batch B --loss-chunks 1)
# and the resident peak (VmRSS) measured here, on an 8-core x86 host with
# 62 GB: Qwen2.5-32B 40.90 GB reckoned, 41.55 measured (134.2 s);
# DeepSeek-67B 47.40, 48.41 (210.1 s); Mixtral-8x22B 58.14, 66.43 (212.8
# s), at the edge of the host: it ran at its own grad_accum of 4 (at 1 and
# batch 2 XLA reckons 53.15 GB: --grad-accum 1). The smoke runs 3.3 and
# 3.0 s at 1.2 GB. Mixtral's router margin, 1.05e-6, is within a decade
# of the f32 noise between two machines' router probabilities (~1e-7):
# the card's run did not flip a choice
PAST_CARD_LARGE_RUNS = [
    dict(name=name, smoke=False,
         overrides=dict(dtype="float32", n_layers=1, loss_chunks=1),
         seed=0, data=dict(seed=1, batch=batch, seq_len=256),
         opt=OPT_FULL_WIDTH, steps=3)
    for name, batch in (("qwen2.5-32b", 4), ("deepseek-67b", 8),
                        ("mixtral-8x22b", 4))] + [
    # the smoke configs at the published GQA groups, 10 over 2 heads (5,
    # with Qwen2.5's q/k/v bias) and 16 over 2 (8), as
    # tests/make_lm_golden.py serves them
    dict(name=name, smoke=True,
         overrides=dict(dtype="float32", n_heads=heads, n_kv_heads=2),
         seed=0, data=dict(seed=1, batch=2, seq_len=32), opt=OPT_FULL_WIDTH,
         steps=3)
    for name, heads in (("qwen2.5-32b", 10), ("deepseek-67b", 16))]
# mode: (runs, file, whether a MoE run keeps its router_margin)
MODES = {(): (RUNS, OUT, False),
         ("--families",): (FAMILY_RUNS, OUT_FAMILIES, False),
         ("--full-width",): (FULL_WIDTH_RUNS, OUT_FULL_WIDTH, False),
         ("--past-card",): (PAST_CARD_RUNS, OUT_PAST_CARD, True),
         ("--past-card-large",): (PAST_CARD_LARGE_RUNS, OUT_PAST_CARD_LARGE,
                                  True)}
METRICS = ("loss", "xent", "moe_aux", "grad_norm", "lr")


@contextlib.contextmanager
def router_margins(margins: list):
    """``jax.lax.top_k`` (which only the MoE router calls) taking k + 1
    values, the (k+1)-th only to append the smallest K-th minus (K+1)-th
    gap of each call to ``margins`` (a host callback under ``jit``); the
    top k it returns are ``top_k``'s own."""
    real = jax.lax.top_k

    def top_k(x, k):
        vals, idx = real(x, k + 1)
        jax.debug.callback(lambda v: margins.append(
            float(np.min(v[..., k - 1] - v[..., k]))), vals)
        return vals[..., :k], idx[..., :k]
    jax.lax.top_k = top_k
    try:
        yield
    finally:
        jax.lax.top_k = real


@contextlib.contextmanager
def peak_rss(out: dict):
    """The largest resident set of this process within the block, in
    bytes, into ``out["peak_rss"]``: ``VmRSS`` read every 20 ms."""
    done = threading.Event()
    peak = [0]

    def sample():
        while not done.is_set():
            with open("/proc/self/status") as f:
                for line in f:
                    if line.startswith("VmRSS:"):
                        peak[0] = max(peak[0], int(line.split()[1]) << 10)
            done.wait(0.02)
    t = threading.Thread(target=sample, daemon=True)
    t.start()
    try:
        yield
    finally:
        done.set()
        t.join()
        out["peak_rss"] = peak[0]


def golden_run(run: dict, margin: bool = False) -> dict:
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
                                      AdamWConfig(**run["opt"])),
                      donate_argnums=(0, 1))
    dcfg = DataConfig(**run["data"])
    per_step, margins = [], []
    for s in range(run["steps"]):
        batch = make_batch(dcfg, tcfg, s)
        with router_margins(margins) if margin else contextlib.nullcontext():
            params, opt_state, m = step_fn(
                params, opt_state, jax.tree_util.tree_map(jnp.asarray, batch))
            jax.block_until_ready(m)
        kept = {k: v.tolist() for k, v in batch.items()
                if run["smoke"] or k != "embeds"}
        if not run["smoke"] and "embeds" in batch:
            kept["embeds_sha256"] = tree_sha256(batch["embeds"])
        per_step.append({**kept,
                         **{k: float(np.asarray(m[k])) for k in METRICS}})
    extra = {"router_margin": min(margins)} if margins else {}
    return dict(run, weights_sha256=sha, per_step=per_step, **extra)


def main(argv: list) -> None:
    if tuple(argv[1:]) not in MODES:
        raise SystemExit(f"usage: {argv[0]} [--families | --full-width | "
                         f"--past-card | --past-card-large]")
    specs, out_path, margin = MODES[tuple(argv[1:])]
    runs = []
    for r in specs:
        t0, seen = time.perf_counter(), {}
        with peak_rss(seen):
            runs.append(golden_run(r, margin))
        print(r["name"], r["overrides"], f"{time.perf_counter() - t0:.1f} s,",
              f"peak RSS {seen['peak_rss'] / 1e9:.2f} GB", flush=True)
    os.makedirs(GOLDEN, exist_ok=True)
    with open(out_path, "w") as f:
        json.dump({"made_by": "tests/make_train_golden.py", "runs": runs}, f,
                  indent=1)
        f.write("\n")
    for r in runs:
        print(r["name"], [(x["loss"], x["grad_norm"]) for x in r["per_step"]],
              "router margin", r.get("router_margin"))


if __name__ == "__main__":
    main(sys.argv)
