"""``chip_smoke.py`` phase 8's training of the configs whose train state
exceeds one card, rehearsed on the CPU.

Phase 8 trains Moonshot-v1-16B-A3B, RecurrentGemma-9B and Gemma-2 27B,
and Qwen2.5-32B, DeepSeek-67B and Mixtral-8x22B (whose golden file has
tests of its own, ``tests/test_torch_train_past_card_large.py``), at
full width and cut depth in bf16 through the donated ``Trainer``
(``TRAIN_BF16_RUNS``), and holds the golden file
``tests/golden/train_past_card_f32.json`` (``tests/make_train_golden.py
--past-card``): the three at full width cut to one pattern group, which
only the card runs, and Moonshot's smoke config, which goes through phase
8's ``train_golden_errors`` here, where the port's attention takes its
plain forward: every check 0. ``train.moe_router_no_grad`` must fail it,
and ``train.backward_window_dropped`` the attention's gradients past the
window.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS
from repro_torch.models import build_model
from test_torch_session import _chip_smoke, _plant

CPU = torch.device("cpu")
# each bf16 run's depth and attention launches a step (remat "full": each
# attention layer's forward twice, per microbatch)
RUNS = {"moonshot-v1-16b-a3b": (5, 20), "recurrentgemma-9b": (12, 16),
        "gemma2-27b": (2, 16), "qwen2.5-32b": (4, 32),
        "deepseek-67b": (2, 32), "mixtral-8x22b": (1, 8)}
# the train state a step holds, per parameter: f32 master weights and
# AdamW's two moments, the f32 gradient sum, the bf16 compute copy
STATE_BYTES = 4 + 8 + 4 + 2


def _runs(cs) -> dict:
    """The past-card golden file's runs by ``chip_smoke.run_tag``."""
    return {cs.run_tag(r): r
            for r in cs.train_golden(cs.TRAIN_GOLDEN_PAST_CARD)}


def _published(cfg, name: str, **but) -> None:
    """``cfg`` is ``ARCHS[name]`` in every field but those of ``but``."""
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        ARCHS[name].replace(**but))


def _params(cfg) -> int:
    """The parameters of ``cfg``, from its ``model_specs``."""
    def count(t):
        if isinstance(t, dict):
            return sum(count(v) for v in t.values())
        return math.prod(t.shape)
    return count(build_model(cfg).specs())


@pytest.mark.parametrize("name", sorted(RUNS))
def test_bf16_runs_are_their_published_configs(name):
    """Each past-card bf16 run of phase 8 trains its config at full width,
    cut at whole pattern groups (phase 8's remat and loss chunks and the
    depth the only changes), in microbatches of whole sequences, and
    expects one ``mma`` launch an attention layer, twice under remat, per
    microbatch: 20 for Moonshot at 5 layers (5 x 2 x 2), 16 for
    RecurrentGemma at 12 (4 attention layers x 2 x 2), 16 for Gemma-2 at 2
    (2 x 2 x 4), 32 for Qwen2.5-32B at 4 (4 x 2 x 4), 32 for DeepSeek-67B
    at 2 (2 x 2 x 8), 8 for Mixtral-8x22B at 1 (1 x 2 x 4).
    RecurrentGemma's, Gemma-2's and Mixtral's sequences run past their
    windows."""
    cs = _chip_smoke()
    (spec,) = [r for r in cs.TRAIN_BF16_RUNS if r["name"] == name]
    layers, n = RUNS[name]
    cfg = cs.train_config(spec)
    _published(cfg, name, remat=True, remat_policy="full", loss_chunks=8,
               n_layers=layers)
    assert name in cs.TRAIN_PAST_CARD_NAMES
    assert cfg.n_layers % len(cfg.pattern) == 0
    assert cfg.n_remainder_layers == 0
    assert cs.train_launches_want(cfg, spec["seq_len"], 1) == {
        "flash_attention": n, "flash_attention.mma": n,
        "flash_attention.decode": 0, "flash_attention.tf32x3": 0,
        "flash_attention_combine": 0}
    assert spec["batch"] % cfg.grad_accum == 0
    if cfg.sliding_window:
        assert spec["seq_len"] > cfg.sliding_window
        assert spec["batch"] == cfg.grad_accum
    assert not spec.get("ckpt_every") and spec["steps"] >= 3


@pytest.mark.parametrize("name", sorted(RUNS))
def test_bf16_runs_state_fits_one_card(name):
    """Each run's reckoned train state, 18 B a parameter of its
    ``model_specs``, stays under the card's 80 GB, and the config's whole
    depth would not: the depth cut is what makes it fit."""
    cs = _chip_smoke()
    (spec,) = [r for r in cs.TRAIN_BF16_RUNS if r["name"] == name]
    assert _params(cs.train_config(spec)) * STATE_BYTES < 80e9
    assert _params(ARCHS[name]) * STATE_BYTES > 80e9
    assert cs.TRAIN_PEAK_LIMIT <= 76e9


def test_past_card_golden_runs_are_published_widths():
    """The golden file's full-width runs: each config at its published
    width, one pattern group deep, the loss in one chunk, f32, under its
    own ``grad_accum``, three steps, a weights sha each; the MoE runs keep
    their smallest router margin. Checked from the file, without running
    it."""
    cs = _chip_smoke()
    runs = _runs(cs)
    assert sorted(runs) == ["gemma2-27b", "moonshot-v1-16b-a3b",
                            "moonshot-v1-16b-a3b-smoke",
                            "recurrentgemma-9b"]
    for name, layers in (("moonshot-v1-16b-a3b", 1),
                         ("recurrentgemma-9b", 3), ("gemma2-27b", 2)):
        run = runs[name]
        cfg = cs.lm_config(run)
        _published(cfg, name, n_layers=layers, dtype="float32",
                   loss_chunks=1)
        assert cfg.n_layers == len(cfg.pattern)
        assert run["data"]["batch"] % cfg.grad_accum == 0
        assert cfg.grad_accum > 1
        assert len(run["weights_sha256"]) == 64
        assert run["steps"] == len(run["per_step"]) == 3
        assert run["opt"]["lr"] == 1e-4
    for tag in ("moonshot-v1-16b-a3b", "moonshot-v1-16b-a3b-smoke"):
        assert runs[tag]["router_margin"] > 0
    assert "router_margin" not in runs["gemma2-27b"]


def test_moonshot_smoke_golden_holds_on_the_cpu():
    """Moonshot's smoke config through phase 8's golden check (the donated
    step): weights hash to the file's, each step's loss, grad_norm and lr
    within the limits."""
    cs = _chip_smoke()
    run = _runs(cs)["moonshot-v1-16b-a3b-smoke"]
    errs, row = cs.train_golden_errors(run, CPU)
    assert errs == {"weights": 0, "loss": 0, "grad_norm": 0, "lr": 0}, (
        errs, row)
    assert max(row["loss_rel_err"]) < 1e-6


def test_router_no_grad_fails_the_moonshot_smoke_golden(monkeypatch):
    """``train.moe_router_no_grad`` (the router's logits detached), planted
    in this process, fails the smoke golden: the first step's forward, and
    so its loss, are unchanged, but the router gets no gradient (at the
    smoke width its share of the squared gradient norm is 1.6e-4, so
    step 1's grad_norm moves under its limit) and stays as drawn, which
    moves the later steps' losses past theirs."""
    cs = _chip_smoke()
    _plant(monkeypatch, cs, "train.moe_router_no_grad")
    run = _runs(cs)["moonshot-v1-16b-a3b-smoke"]
    errs, row = cs.train_golden_errors(run, CPU)
    assert errs["weights"] == 0 and errs["loss"] + errs["grad_norm"] > 0, \
        errs
    assert row["loss_rel_err"][0] < cs.TRAIN_LOSS_RTOL, row
    assert max(row["loss_rel_err"][1:]) > cs.TRAIN_LOSS_RTOL, row


def _window_grads(window: int, sq: int) -> tuple:
    """dq, dk, dv of the port's attention (``FlashAttentionFn``: the plain
    forward on the CPU, ``flash_attention_backward``) and of autograd
    through ``flash_attention_plain``, on one seeded input of ``sq``
    tokens, a GQA group of 2, a softcap and ``window``."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    rng = np.random.default_rng(0)
    shapes = ((1, 4, sq, 16), (1, 2, sq, 16), (1, 2, sq, 16))
    base = [torch.tensor(rng.standard_normal(s, dtype=np.float32))
            for s in shapes]
    dout = torch.tensor(rng.standard_normal(shapes[0], dtype=np.float32))
    out = []
    for fn in (flash_attention, flash_attention_plain):
        q, k, v = (t.clone().requires_grad_() for t in base)
        fn(q, k, v, causal=True, window=window, softcap=20.0).backward(dout)
        out.append((q.grad, k.grad, v.grad))
    return out


def test_backward_window_dropped_fails_past_the_window(monkeypatch):
    """The attention backward against autograd through the plain forward,
    over 640 tokens in chunks of 256 rows with a window of 200, where the
    chunks from row 256 on see keys from k0 > 0: within 1e-5 as it is, and
    off by order 1 with ``train.backward_window_dropped`` planted (its
    chunks read keys from 0). Within the window (one chunk that starts at
    key 0) the fault changes nothing: the smoke configs cannot show it."""
    cs = _chip_smoke()
    got, want = _window_grads(200, 640)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) < 1e-5
    _plant(monkeypatch, cs, "train.backward_window_dropped")
    got, want = _window_grads(200, 640)
    assert max(float((g - w).norm() / w.norm())
               for g, w in zip(got, want)) > 0.1
    got, want = _window_grads(8, 32)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) < 1e-5


def test_past_card_route_runs_only_what_catches_its_faults():
    """``--plant-faults`` runs the past-card faults, and an unchanged
    control, on the route of ``train_checks``' "past_card" (the past-card
    golden files and the gradient checks of the six runs), which phase 8
    holds whole; a copy of that route runs alone on the card (its
    gradient checks held 52.87 GB there, and a copy beside it ran the
    card out of memory), the others three at a time."""
    cs = _chip_smoke()
    assert set(cs.PAST_CARD_FAULTS) <= set(cs.PLANTED_FAULTS)
    assert all(cs.PLANTED_FAULTS[f][0] == "train"
               for f in cs.PAST_CARD_FAULTS)
    assert "train.donate_block_tail" in cs.PAST_CARD_FAULTS
    assert set(cs.TRAIN_GOLDENS_PAST_CARD) == {
        cs.TRAIN_GOLDEN_PAST_CARD, cs.TRAIN_GOLDEN_PAST_CARD_LARGE}
    assert set(cs.TRAIN_GOLDENS_PAST_CARD) <= set(cs.TRAIN_GOLDENS)
    assert set(cs.TRAIN_PAST_CARD_NAMES) == set(RUNS)
    heavy, fits = cs.PAST_CARD_ROUTE, cs.fault_copy_fits
    assert heavy in cs.HEAVY_FAULT_ROUTES
    assert fits("train", ["mma", "lm"]) and not fits("train",
                                                     ["mma", "lm", "dse"])
    assert fits(heavy, []) and not fits(heavy, ["lm"])
    assert not fits(heavy, [heavy]) and not fits("train", [heavy])
