"""``chip_smoke.py``'s checks of the two dense configs that fit one card
whole, Gemma-2-27B and Qwen2.5-32B (phases 5 and 7), rehearsed on the CPU.

The golden file ``tests/golden/lm_session_dense_large_f32.json`` holds the
JAX package's runs in f32 (``tests/make_lm_golden.py --dense-large``):
Gemma-2-27B at full width cut to one local and one global layer, which
only the card runs (2.31 B numpy draws), Gemma-2's smoke config with a
query scale that is not ``head_dim ** -0.5``, Qwen2.5-32B's smoke
config at its published GQA group of 5, and Qwen2.5-32B at full width cut
to 2 layers, which only the card runs (2.53 B numpy draws). The two smoke runs go through
phase 7's ``golden_errors`` here, where the port's attention takes its
plain forward: every check 0.

Each check must fail what it is there for: ``attention._scale`` taking
``head_dim ** -0.5`` whatever the config says (the planted fault
``lm.query_scale_dropped``) fails the query-scale run, and passes the
golden file's older Gemma-2 smoke run, whose scale is ``head_dim ** -0.5``;
a GQA head map off for a group of 5 (``mma.gqa5_head_map``), emulated
here on the plain version, fails phase 5's limit at the ``qwen25.prefill``
case's heads.
"""
import math

import pytest
import torch

from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.models.transformer import model_specs
from repro_torch.utils.tree import flatten_dict
from test_torch_session import _chip_smoke, _plant

CPU = torch.device("cpu")


def _runs(cs) -> dict:
    """The dense-large golden file's runs by ``chip_smoke.run_tag``."""
    return {cs.run_tag(r): r for r in cs.lm_golden(cs.LM_GOLDEN_DENSE_LARGE)}


@pytest.mark.parametrize("tag", ["gemma2-27b-smoke-query_scale",
                                 "qwen2.5-32b-smoke-n_heads-n_kv_heads"])
def test_dense_large_smoke_runs_hold_on_the_cpu(tag):
    """Each smoke run of the dense-large golden file through phase 7's
    golden check: the weights hash to the file's, tokens and logits agree
    with the JAX package's run, every step compared."""
    cs = _chip_smoke()
    errs, row = cs.golden_errors(_runs(cs)[tag], CPU)
    assert errs == {"weights": 0, "tokens": 0, "logits": 0}, (errs, row)
    assert row["tokens_compared"] == row["steps"] and row["max_err"] < 1e-4
    assert set(row["walls"]) == {"draw", "sha256", "session", "generate"}


def test_dense_large_runs_are_the_configs_they_claim():
    """The file's four runs: Gemma-2-27B at full width (d_model 4608,
    vocab 256000, f32) cut to one local and one global layer, 2 x 64
    tokens and 8 steps, its query scale 1/12; the smoke config with a query
    scale that is not ``head_dim ** -0.5``; Qwen2.5-32B's smoke config
    with a GQA group of 5; Qwen2.5-32B at full width (d_model 5120, 40 / 8
    heads of 128, the q/k/v bias, vocab 152064, f32) cut to 2 layers, 2 x
    64 tokens and 8 steps. The full-width runs are not run here."""
    cs = _chip_smoke()
    runs = _runs(cs)
    assert set(runs) == {"gemma2-27b", "gemma2-27b-smoke-query_scale",
                         "qwen2.5-32b-smoke-n_heads-n_kv_heads",
                         "qwen2.5-32b"}
    full = runs["gemma2-27b"]
    cfg = cs.lm_config(full)
    assert (cfg.name, cfg.d_model, cfg.vocab_size, cfg.dtype) == (
        "gemma2-27b", 4608, 256000, "float32")
    assert list(cfg.layer_kinds) == ["attn_local", "attn_global"]
    assert (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff) == (
        32, 16, 128, 36864)
    assert cfg.sliding_window == 4096 and cfg.tie_embeddings
    assert (cfg.attn_logit_softcap, cfg.final_logit_softcap) == (50.0, 30.0)
    assert cfg.query_scale == pytest.approx(1 / 12)
    assert (full["batch"], full["prompt_len"], full["steps"]) == (2, 64, 8)
    n = sum(math.prod(s.shape)
            for s in flatten_dict(model_specs(cfg)).values())
    assert 2.30e9 < n < 2.32e9
    scaled = cs.lm_config(runs["gemma2-27b-smoke-query_scale"])
    assert scaled.query_scale == 12.0 ** -0.5
    assert scaled.query_scale != scaled.head_dim ** -0.5
    qwen = cs.lm_config(runs["qwen2.5-32b-smoke-n_heads-n_kv_heads"])
    assert (qwen.n_heads, qwen.n_kv_heads) == (10, 2) and qwen.qkv_bias
    full = runs["qwen2.5-32b"]
    cfg = cs.lm_config(full)
    assert (cfg.name, cfg.d_model, cfg.vocab_size, cfg.dtype, cfg.n_layers) \
        == ("qwen2.5-32b", 5120, 152064, "float32", 2)
    assert (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff) == (
        40, 8, 128, 27648)
    assert cfg.qkv_bias and not cfg.tie_embeddings
    assert (full["batch"], full["prompt_len"], full["steps"]) == (2, 64, 8)
    assert cs.published_layers(full) == 64
    n = sum(math.prod(s.shape)
            for s in flatten_dict(model_specs(cfg)).values())
    assert 2.53e9 < n < 2.54e9


def test_dropped_query_scale_fails_only_the_new_golden(monkeypatch):
    """With ``attention._scale`` ignoring ``query_scale`` (the planted
    fault ``lm.query_scale_dropped``), the query-scale run fails its
    logits and the older Gemma-2 smoke run of ``lm_session_f32.json``
    still passes every check: it could not see the fault."""
    cs = _chip_smoke()
    run = _runs(cs)["gemma2-27b-smoke-query_scale"]
    (old,) = [r for r in cs.lm_golden() if r["smoke"]]
    assert cs.run_tag(old) == "gemma2-27b-smoke"
    assert "query_scale" not in old["overrides"]
    _plant(monkeypatch, cs, "lm.query_scale_dropped")
    errs, _ = cs.golden_errors(run, CPU)
    assert errs["weights"] == 0 and errs["logits"] > 0, errs
    errs, _ = cs.golden_errors(old, CPU)
    assert errs == {"weights": 0, "tokens": 0, "logits": 0}, errs


def test_gqa5_head_map_off_fails_phase5_limit():
    """Phase 5's bf16 limit (``attention_error``) at the ``qwen25.prefill``
    case's heads (40 over 8, head_dim 128; 256 tokens here): the plain
    version passes, and the head map of ``mma.gqa5_head_map`` (q-head h
    reading KV head (h + 1) % 40 // 5), emulated on the plain version with
    K and V expanded by that map, fails."""
    cs = _chip_smoke()
    (spec,) = [c for c in cs.QWEN25_ATTENTION if c[0] == "qwen25.prefill"]
    _, b, h, kv, d, *_ = spec
    assert (h, kv) == (40, 8)
    gen = torch.Generator().manual_seed(0)
    s = 256
    q, k, v = (torch.randn(shape, generator=gen) * m for shape, m in (
        ((b, h, s, d), 0.4), ((b, kv, s, d), 0.4), ((b, kv, s, d), 1.0)))
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    kw = dict(causal=True, window=None, softcap=None, scale=None)
    want = flash_attention_plain(q, k, v, **kw)
    rows = cs.sample_rows(s, s, None)
    r64 = cs.attention64(q, k, v, rows, **kw)
    assert not cs.attention_error(want[:, :, rows], want[:, :, rows], r64)[2]
    heads = torch.tensor([(i + 1) % h // (h // kv) for i in range(h)])
    got = flash_attention_plain(q, k[:, heads], v[:, heads], **kw)
    assert cs.attention_error(got[:, :, rows], want[:, :, rows], r64)[2]


def test_reference_caps_only_decode_logits():
    """The JAX package applies Gemma-2's final softcap (30) in its decode
    step (``repro/models/transformer.py:357``) but not in its forward, so
    a prefill's logits are uncapped (``:211-213``); the port mirrors both
    (``transformer.py:432``, ``forward``). In the full-width golden the
    prefill's largest logit is over 30 and every decode step's under it:
    the softcap moves no argmax, since tanh is monotonic."""
    cs = _chip_smoke()
    full = _runs(cs)["gemma2-27b"]
    assert cs.lm_config(full).final_logit_softcap == 30.0
    first, *rest = (max(max(v) for v in t["value"]) for t in full["top"])
    assert first > 30.0 and all(x < 30.0 for x in rest)


def test_generation_decodes_over_a_ring_of_the_prompt_length():
    """Both packages' ``ServeSession.generate`` decode into the prefill's
    caches (``repro/serve/session.py:64-75``), which hold S slots on a
    global layer, not S + steps: from the first decode step its ring wraps
    (slot ``pos % S``) and each step evicts the oldest position, so a
    global layer attends over the last S positions. The port keeps the
    reference's cache lengths, the local layers' at the window."""
    import jax
    from repro.configs import SMOKE_ARCHS
    from repro.models import build_model as jax_model
    from repro_torch.configs import SMOKE_ARCHS as T_SMOKE
    from repro_torch.models import build_model
    S = 24
    for name in ("gemma2-27b", "qwen2.5-32b"):
        jcfg = SMOKE_ARCHS[name].replace(dtype="float32")
        jm = jax_model(jcfg)
        toks = jax.numpy.zeros((1, S), jax.numpy.int32)
        _, jc = jm.prefill(jm.init(jax.random.PRNGKey(0)), {"tokens": toks})
        tm = build_model(T_SMOKE[name].replace(dtype="float32"))
        with torch.inference_mode():
            _, tc = tm.prefill(tm.init(torch.Generator().manual_seed(0),
                                       "cpu"),
                               {"tokens": torch.zeros((1, S), dtype=torch.int32)})
        for i, kind in enumerate(jcfg.pattern):
            want = S if kind == "attn_global" else min(S, jcfg.sliding_window)
            assert jc["scan"][f"l{i}"]["k"].shape[2] == want
            assert tc["scan"][f"l{i}"]["k"].shape[2] == want
