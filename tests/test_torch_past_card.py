"""``chip_smoke.py``'s checks of the two configs that fit no card whole,
DeepSeek-67B and Mixtral-8x22B (phases 5 and 7), rehearsed on the CPU.

Phase 7 serves both at full width and cut depth in bf16 (``LM_BF16_RUNS``:
40 of DeepSeek's 95 layers, 12 of Mixtral's 56) and holds the golden file
``tests/golden/lm_session_past_card_f32.json``
(``tests/make_lm_golden.py --past-card``): both at full width cut to one
layer, which only the card runs (5.3 B numpy draws), and DeepSeek-67B's
smoke config at its published GQA group of 8 (16 query heads over 2 KV
heads), which goes through phase 7's ``golden_errors`` here, where the
port's attention takes its plain forward: every check 0.

Each check must fail what it is there for: a GQA head map off for a group
of 8 (``mma.gqa8_head_map``), emulated here on the plain version, fails
phase 5's limit at the ``deepseek.prefill`` case's heads, and a router
choice that differs from the JAX package's counts in ``routing_errors``.
"""
import dataclasses
import math

import pytest
import torch

from repro_torch.configs import ARCHS
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.models.transformer import model_specs
from repro_torch.utils.tree import flatten_dict
from test_torch_session import _chip_smoke

CPU = torch.device("cpu")
# (config, depth) of the bf16 runs and of the full-width goldens
CUT = {"deepseek-67b": (40, 1), "mixtral-8x22b": (12, 1)}


def _runs(cs) -> dict:
    """The past-card golden file's runs by ``chip_smoke.run_tag``."""
    return {cs.run_tag(r): r for r in cs.lm_golden(cs.LM_GOLDEN_PAST_CARD)}


def test_gqa8_smoke_run_holds_on_the_cpu():
    """The GQA-8 smoke run of the past-card golden file through phase 7's
    golden check: the weights hash to the file's, tokens and logits agree
    with the JAX package's run, every step compared."""
    cs = _chip_smoke()
    run = _runs(cs)["deepseek-67b-smoke-n_heads-n_kv_heads"]
    cfg = cs.lm_config(run)
    assert (cfg.n_heads, cfg.n_kv_heads) == (16, 2)
    errs, row = cs.golden_errors(run, CPU)
    assert errs == {"weights": 0, "tokens": 0, "logits": 0}, (errs, row)
    assert row["tokens_compared"] == row["steps"] and row["max_err"] < 1e-4
    assert row["published_layers"] == row["layers"]


def _published(cfg, name: str, dtype: str) -> None:
    """``cfg`` is ``ARCHS[name]`` in every field but its depth (the run's
    cut) and its dtype."""
    want = dataclasses.asdict(ARCHS[name].replace(
        n_layers=cfg.n_layers, dtype=dtype))
    assert dataclasses.asdict(cfg) == want


@pytest.mark.parametrize("name", sorted(CUT))
def test_past_card_runs_are_their_published_configs(name):
    """The bf16 run of ``LM_BF16_RUNS`` and the full-width golden run of
    each config: every field of ``ARCHS`` equal but the depth (40 and 12
    layers in bf16, 1 in the golden) and the dtype; the bf16 params under
    62 GB by ``param_count``, and the golden's 2.37 B or 2.91 B values
    (``model_specs``)."""
    cs = _chip_smoke()
    bf16_layers, golden_layers = CUT[name]
    (spec,) = [r for r in cs.LM_BF16_RUNS if r["name"] == name]
    assert spec["overrides"] == {"n_layers": bf16_layers}
    cfg = cs.lm_config(spec)
    _published(cfg, name, ARCHS[name].dtype)
    assert cfg.n_layers < ARCHS[name].n_layers == cs.published_layers(spec)
    assert 2 * cfg.param_count() < 62e9
    # ties the card showed at 16 decode steps, listed beside the run:
    # exact ones only, and none for Mixtral
    assert not spec.get("step_ties")
    assert bool(spec.get("exact_ties")) == (name == "deepseek-67b")
    gold = _runs(cs)[name]
    gcfg = cs.lm_config(gold)
    _published(gcfg, name, "float32")
    assert gcfg.n_layers == golden_layers
    assert (gold["batch"], gold["prompt_len"], gold["steps"]) == (2, 64, 8)
    n = sum(math.prod(s.shape)
            for s in flatten_dict(model_specs(gcfg)).values())
    assert n == pytest.approx({"deepseek-67b": 2.37e9,
                               "mixtral-8x22b": 2.91e9}[name], rel=2e-3)
    if name == "mixtral-8x22b":
        assert (spec["batch"], spec["prompt_len"]) == (2, 5120)
        assert spec["prompt_len"] > cfg.sliding_window
        assert "router_margin" in gold and gold["router_margin"] > 1e-4
        assert len(gold["routing"]) == 1 + gold["steps"]
    else:
        assert (spec["batch"], spec["prompt_len"]) == (4, 2048)
        assert cfg.n_heads // cfg.n_kv_heads == 8


@pytest.mark.parametrize("name,mma", [("deepseek-67b", 40),
                                      ("mixtral-8x22b", 12)])
def test_launches_want_of_the_cut_runs(name, mma):
    """``lm_launches_want`` for each cut bf16 run: one ``mma`` launch a
    layer a prefill (40 and 12), one decode and one combine a layer a
    step, and one ``flash_attention`` call a layer a prefill and a step."""
    cs = _chip_smoke()
    (spec,) = [r for r in cs.LM_BF16_RUNS if r["name"] == name]
    cfg = cs.lm_config(spec)
    assert cs.attention_layers(cfg) == mma
    want = cs.lm_launches_want(mma, cfg.dtype, spec["prompt_len"],
                               spec["steps"])
    steps = spec["steps"]
    assert want == {"flash_attention.mma": mma,
                    "flash_attention.decode": mma * steps,
                    "flash_attention.tf32x3": 0,
                    "flash_attention_combine": mma * steps,
                    "flash_attention": mma * (1 + steps)}


def test_phase5_cases_have_the_configs_heads():
    """The three phase-5 cases of ``DEEPSEEK_MIXTRAL_ATTENTION`` at the
    configs' heads: DeepSeek's 64 over 8 (a GQA group of 8, which no
    earlier case has) at prefill and decode, Mixtral's 48 over 8 decoding
    against its 4096-key window; the earlier 34 cases come before them."""
    cs = _chip_smoke()
    got = {c[0]: c[1:7] + (c[8],) for c in cs.DEEPSEEK_MIXTRAL_ATTENTION}
    assert got == {"deepseek.prefill": (1, 64, 8, 128, 8192, 8192, None),
                   "deepseek.decode": (8, 64, 8, 128, 1, 32768, None),
                   "mixtral.local.decode": (8, 48, 8, 128, 1, 4096, 4096)}
    for name, heads in (("deepseek-67b", (64, 8)), ("mixtral-8x22b", (48, 8))):
        assert (ARCHS[name].n_heads, ARCHS[name].n_kv_heads) == heads
    assert ARCHS["mixtral-8x22b"].sliding_window == 4096
    earlier = cs.ATTENTION_CASES[:-len(cs.DEEPSEEK_MIXTRAL_ATTENTION)]
    assert sum(len(c[11]) for c in earlier) == 34
    assert all(c[2] // c[3] != 8 for c in earlier)


def test_gqa8_head_map_off_fails_phase5_limit():
    """Phase 5's bf16 limit (``attention_error``) at the
    ``deepseek.prefill`` case's heads (64 over 8, head_dim 128; 256
    tokens here): the plain version passes, and the head map of
    ``mma.gqa8_head_map`` (q-head h reading KV head (h + 1) % 64 // 8),
    emulated on the plain version with K and V expanded by that map,
    fails."""
    cs = _chip_smoke()
    (spec,) = [c for c in cs.DEEPSEEK_MIXTRAL_ATTENTION
               if c[0] == "deepseek.prefill"]
    _, b, h, kv, d, *_ = spec
    assert (h, kv) == (64, 8)
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


def test_routing_errors_count_a_moved_choice():
    """``routing_errors`` against the full-width Mixtral golden's own
    routing: 0 for the same choices in either order within a token, 1 for
    one token sent to another expert, and the missing call counted."""
    cs = _chip_smoke()
    want = _runs(cs)["mixtral-8x22b"]["routing"]
    kept = [torch.tensor(c).flip(-1) for c in want]
    assert cs.routing_errors(kept, want, 2) == (
        0, sum(2 * len(c) for c in want))
    assert len(want[0]) == 2 * 64 and len(want[1]) == 2   # prefill, step
    moved = [x.clone() for x in kept]
    a, b = (int(e) for e in moved[0][5])
    moved[0][5, 0] = next(e for e in range(8) if e not in (a, b))
    assert cs.routing_errors(moved, want, 2)[0] == 1
    assert cs.routing_errors(kept[:-1], want, 2)[0] == 1
