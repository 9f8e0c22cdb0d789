"""``chip_smoke.py`` phase 8's full-width training checks, rehearsed on
the CPU.

Phase 8 trains Qwen2-VL-2B, RWKV-6 1.6B and MusicGen-Large at full width
and depth in bf16 through the donated ``Trainer`` (``TRAIN_BF16_RUNS``),
and holds the golden file ``tests/golden/train_full_width_f32.json``
(``tests/make_train_golden.py --full-width``): the three at full width
cut to 2 layers, which only the card runs, and MusicGen's smoke config
under ``grad_accum`` 2, which goes through phase 8's
``train_golden_errors`` here, where the port's attention takes its plain
forward: every check 0. The planted faults of the donated step must fail
it.
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import ARCHS
from test_torch_session import _chip_smoke, _plant

CPU = torch.device("cpu")
# attention launches a step of each full-depth bf16 run (remat "full":
# each attention layer's forward twice, per microbatch)
LAUNCHES = {"qwen3-0.6b": 56, "qwen2-vl-2b": 56, "rwkv6-1.6b": 0,
            "musicgen-large": 192}


def _runs(cs) -> dict:
    """The full-width golden file's runs by ``chip_smoke.run_tag``."""
    return {cs.run_tag(r): r
            for r in cs.train_golden(cs.TRAIN_GOLDEN_FULL_WIDTH)}


def _published(cfg, name: str, **but) -> None:
    """``cfg`` is ``ARCHS[name]`` in every field but those of ``but``."""
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        ARCHS[name].replace(**but))


@pytest.mark.parametrize("name", sorted(LAUNCHES))
def test_bf16_runs_are_their_published_configs(name):
    """Each bf16 run of phase 8 trains its config at full width and depth
    (phase 8's remat and loss chunks the only changes), and expects one
    ``mma`` launch an attention layer, twice under remat, per microbatch:
    56 for Qwen3-0.6B and Qwen2-VL-2B, 0 for RWKV-6, 192 (48 x 2 x 2) for
    MusicGen-Large."""
    cs = _chip_smoke()
    (spec,) = [r for r in cs.TRAIN_BF16_RUNS if r["name"] == name]
    cfg = cs.train_config(spec)
    _published(cfg, name, remat=True, remat_policy="full", loss_chunks=8)
    n = LAUNCHES[name]
    assert cs.train_launches_want(cfg, spec["seq_len"], 1) == {
        "flash_attention": n, "flash_attention.mma": n,
        "flash_attention.decode": 0, "flash_attention.tf32x3": 0,
        "flash_attention_combine": 0}
    assert spec["batch"] % cfg.grad_accum == 0
    assert spec["seq_len"] >= (2 * cfg.scan_chunk if cfg.family == "ssm"
                                else 1024)
    # only Qwen3's run checkpoints; every run takes at least 3 steps, so
    # steps 2 on give a median
    assert bool(spec.get("ckpt_every")) == (name == "qwen3-0.6b")
    assert spec["steps"] >= 3


def test_full_width_runs_are_their_published_configs():
    """The golden file's full-width runs: each config at its published
    width, 2 layers, f32 (MusicGen-Large under its own ``grad_accum`` of
    2), three steps, a weights sha each; RWKV-6's sequence spans two
    ``scan_chunk``s, so the WKV state crosses a chunk; Qwen2-VL's
    embeddings kept by their sha256 alone. Checked from the file, without
    running it."""
    cs = _chip_smoke()
    runs = _runs(cs)
    assert sorted(runs) == ["musicgen-large", "musicgen-large-smoke-grad_accum2",
                            "qwen2-vl-2b", "rwkv6-1.6b"]
    for name in ("qwen2-vl-2b", "rwkv6-1.6b", "musicgen-large"):
        run = runs[name]
        cfg = cs.lm_config(run)
        _published(cfg, name, n_layers=2, dtype="float32")
        assert len(run["weights_sha256"]) == 64
        assert run["steps"] == len(run["per_step"]) == 3
        steps = run["per_step"]
        assert all(("embeds_sha256" in g) == (name == "qwen2-vl-2b")
                   and "embeds" not in g for g in steps)
    assert cs.lm_config(runs["musicgen-large"]).grad_accum == 2
    rwkv = runs["rwkv6-1.6b"]
    assert rwkv["data"]["seq_len"] >= 2 * cs.lm_config(rwkv).scan_chunk
    assert cs.lm_config(runs["qwen2-vl-2b"]).n_heads // \
        cs.lm_config(runs["qwen2-vl-2b"]).n_kv_heads == 6


def test_grad_accum_smoke_run_holds_on_the_cpu():
    """MusicGen's smoke config under ``grad_accum`` 2 through phase 8's
    golden check (the donated step): weights hash to the file's, each
    step's loss, grad_norm and lr within the limits."""
    cs = _chip_smoke()
    run = _runs(cs)["musicgen-large-smoke-grad_accum2"]
    errs, row = cs.train_golden_errors(run, CPU)
    assert errs == {"weights": 0, "loss": 0, "grad_norm": 0, "lr": 0}, (
        errs, row)
    assert row["grad_accum"] == 2 and max(row["loss_rel_err"]) < 1e-6


@pytest.mark.parametrize("fault", ["train.donate_keeps_nu",
                                   "train.accum_drops_microbatch"])
def test_donated_step_faults_fail_the_smoke_golden(monkeypatch, fault):
    """Each fault of the donated step, planted in this process, fails the
    grad_accum smoke run's golden check: an update that leaves the second
    moment as it was (the third step's update divides by a stale nu), and
    a microbatch sum that skips the second microbatch's gradients, which
    the first step's grad_norm shows though its loss, unlike under
    ``train.grad_accum_drops_last``, holds."""
    cs = _chip_smoke()
    _plant(monkeypatch, cs, fault)
    run = _runs(cs)["musicgen-large-smoke-grad_accum2"]
    errs, row = cs.train_golden_errors(run, CPU)
    assert errs["weights"] == 0 and errs["grad_norm"] + errs["loss"] > 0, errs
    if fault == "train.accum_drops_microbatch":
        assert row["loss_rel_err"][0] < cs.TRAIN_LOSS_RTOL, row
        assert row["grad_norm_rel_err"][0] > cs.TRAIN_GNORM_RTOL[0], row
