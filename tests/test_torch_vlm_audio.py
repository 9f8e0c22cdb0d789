"""``chip_smoke.py``'s checks of the vlm and audio families (phase 7) and
of training past the dense model (phase 8), rehearsed on the CPU.

The golden files ``tests/golden/lm_session_vlm_audio_f32.json`` and
``tests/golden/train_families_f32.json`` hold the JAX package's runs in
f32 (``tests/make_lm_golden.py --vlm-audio``, ``tests/make_train_golden.py
--families``). Their smoke runs go through phase 7's ``golden_errors``
and phase 8's ``train_golden_errors`` here, where the port's attention
takes its plain forward: every check 0. The full-width runs' configs are
the port's at the files' depths. A ``grad_accum=2`` step at the smoke
config is written by the train golden writer on the fly and held the
same way.

Each check must fail what it is there for: a logit moved in one codebook
alone (the golden keeps the top 8 of every codebook, not of the flat
(B, K * V) row, whose top 8 come from one codebook), M-RoPE positions
reduced to one row, and the three faults ``--plant-faults`` plants for
these paths (M-RoPE reading row 0 for every section, a codebook head
reading the next codebook's weights, a ``grad_accum`` loop dropping its
last microbatch).
"""
import numpy as np
import pytest
import torch

import make_train_golden
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import transformer
from test_torch_session import _chip_smoke, _plant

CPU = torch.device("cpu")
# the full-width runs: (d_model, heads, KV heads, head_dim, d_ff, vocab,
# layers, codebooks, M-RoPE sections) at the golden file's depth
FULL_WIDTH = {
    "qwen2-vl-2b": (1536, 12, 2, 128, 8960, 151936, 4, 0, (16, 24, 24)),
    "musicgen-large": (2048, 32, 32, 64, 8192, 2048, 4, 4, None),
}


def _lm_runs(cs, name: str) -> tuple:
    """(smoke run, full-width run) of ``name`` in the vlm/audio golden."""
    runs = [r for r in cs.lm_golden(cs.LM_GOLDEN_VLM_AUDIO)
            if r["name"] == name]
    (smoke,) = [r for r in runs if r["smoke"]]
    (full,) = [r for r in runs if not r["smoke"]]
    return smoke, full


def _shape(cfg) -> tuple:
    return (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            cfg.d_ff, cfg.vocab_size, cfg.n_layers, cfg.n_codebooks,
            cfg.mrope_sections)


@pytest.mark.parametrize("name", sorted(FULL_WIDTH))
def test_vlm_audio_golden_file_holds_on_the_cpu(name):
    """The smoke run of ``name`` through phase 7's golden check: weights
    (and Qwen2-VL's embeddings) hash to the file's, tokens and logits
    agree with the JAX package's run, every step compared. Each step
    keeps one row of top 8 per sequence and codebook. The full-width
    run's config is the port's at the file's depth, its positions those
    of one 1 x 6 x 8 image and then text (``image_text_positions``)."""
    cs = _chip_smoke()
    smoke, full = _lm_runs(cs, name)
    errs, row = cs.golden_errors(smoke, CPU)
    assert errs == {"weights": 0, "tokens": 0, "logits": 0}, (errs, row)
    assert row["tokens_compared"] == row["steps"] and row["max_err"] < 1e-4
    for run in (smoke, full):
        cfg = cs.lm_config(run)
        rows = run["batch"] * max(1, cfg.n_codebooks)
        assert all(len(t["index"]) == rows for t in run["top"])
    cfg = cs.lm_config(full)
    assert _shape(cfg) + (cfg.dtype,) == FULL_WIDTH[name] + ("float32",)
    if cfg.family == "vlm":
        pos = cs.image_text_positions(2, (1, 6, 8), 64)
        assert full["image"] == [1, 6, 8]
        np.testing.assert_array_equal(np.array(full["positions"]), pos)
        assert pos[:, 0, 47].tolist() == [0, 5, 7]
        assert pos[:, 0, 48].tolist() == [8, 8, 8]


def test_codebook_golden_fails_a_logit_moved_in_one_codebook(monkeypatch):
    """The largest logit of the last codebook alone, moved up by 1e-2
    (10x ``LM_F32_TOL``; no greedy token changes), fails the logits check
    of the MusicGen smoke run: each codebook's top 8 is held."""
    cs = _chip_smoke()
    smoke, _ = _lm_runs(cs, "musicgen-large")
    real = transformer.lm_head

    def moved(params, x, cfg):
        logits = real(params, x, cfg)
        bump = torch.zeros_like(logits)
        last = logits[..., -1, :]
        bump[..., -1, :].scatter_(-1, last.argmax(-1, keepdim=True), 1e-2)
        return logits + bump
    monkeypatch.setattr(transformer, "lm_head", moved)
    errs, _ = cs.golden_errors(smoke, CPU)
    assert errs == {"weights": 0, "tokens": 0, "logits": 9 * 2}, errs


def test_vlm_golden_fails_positions_on_one_row():
    """The Qwen2-VL smoke run's M-RoPE positions with row 0 (time) given
    to all three rows, which reduces M-RoPE to RoPE over the image's
    time index: the logits check fails."""
    cs = _chip_smoke()
    smoke, _ = _lm_runs(cs, "qwen2-vl-2b")
    one_row = dict(smoke, positions=[smoke["positions"][0]] * 3)
    errs, _ = cs.golden_errors(one_row, CPU)
    assert errs["weights"] == 0 and errs["logits"] > 0, errs


def test_step_tie_needs_both_runs_within_one_bf16_step():
    """``step_tie`` (phase 7's MusicGen run): two tokens one bf16 step apart
    in both runs, in opposite orders (a row of the card's run), is a tie;
    two steps apart in one run is not. A step is 2^-6 in [2, 4)."""
    cs = _chip_smoke()
    g = torch.tensor([2.671875, 2.65625, 1.0])
    r = torch.tensor([2.65625, 2.671875, 1.0])
    assert cs.step_tie(g, r) and not cs.exact_tie(g, r)
    assert not cs.step_tie(torch.tensor([2.6875, 2.65625, 1.0]), r)
    assert (cs.bf16_step(3.109375), cs.bf16_step(0.75)) == (2 ** -6, 2 ** -8)


@pytest.mark.parametrize("fault,name", [("lm.mrope_row0", "qwen2-vl-2b"),
                                        ("lm.codebook_head_next",
                                         "musicgen-large")])
def test_vlm_audio_golden_fails_planted_faults(monkeypatch, fault, name):
    """``--plant-faults``' vlm and audio faults, planted here, fail the
    logits check of the smoke run of ``name``."""
    cs = _chip_smoke()
    smoke, _ = _lm_runs(cs, name)
    _plant(monkeypatch, cs, fault)
    errs, _ = cs.golden_errors(smoke, CPU)
    assert errs["weights"] == 0 and errs["logits"] > 0, errs


# ---------------------------------------------------------------------------
# phase 8
# ---------------------------------------------------------------------------
def _family_runs(cs) -> list:
    return cs.train_golden(cs.TRAIN_GOLDEN_FAMILIES)


@pytest.mark.parametrize("name", ["mixtral-8x22b", "rwkv6-1.6b",
                                  "recurrentgemma-9b", "qwen2-vl-2b",
                                  "musicgen-large"])
def test_family_train_golden_holds_on_the_cpu(name):
    """The smoke run of ``name`` in the families' train golden through
    phase 8's check on the CPU: weights hash to the file's, each step's
    loss, grad_norm and lr within the limits (Qwen2-VL's batches carry
    its embeddings and positions)."""
    cs = _chip_smoke()
    (run,) = [r for r in _family_runs(cs) if r["name"] == name]
    errs, row = cs.train_golden_errors(run, CPU)
    assert errs == {"weights": 0, "loss": 0, "grad_norm": 0, "lr": 0}, (
        errs, row)
    assert max(row["loss_rel_err"]) < 1e-6


@pytest.fixture(scope="module")
def accum_smoke_run():
    """The families' ``grad_accum=2`` run at Qwen3-0.6B's smoke config, 4
    x 32 tokens, written by the train golden writer (the JAX package's
    ``lax.scan`` over two microbatches)."""
    (full,) = [r for r in make_train_golden.FAMILY_RUNS if not r["smoke"]]
    spec = dict(full, smoke=True,
                overrides=dict(full["overrides"], n_layers=2),
                data=dict(full["data"], seq_len=32))
    return make_train_golden.golden_run(spec)


def test_grad_accum_run_holds_on_the_cpu(monkeypatch, accum_smoke_run):
    """The ``grad_accum=2`` check at the smoke config: the port's loop over
    microbatches within phase 8's limits of the reference's scan, and the
    attention's forward calls those ``train_launches_want`` expects (two
    passes a step). The full-width run's config is Qwen3-0.6B at the
    file's depth with ``grad_accum`` 2, at 4 x 256 tokens."""
    cs = _chip_smoke()
    calls = []
    real = fa.attention_forward
    monkeypatch.setattr(fa, "attention_forward",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    errs, row = cs.train_golden_errors(accum_smoke_run, CPU)
    assert errs == {"weights": 0, "loss": 0, "grad_norm": 0, "lr": 0}, (
        errs, row)
    cfg = cs.lm_config(accum_smoke_run)
    assert row["grad_accum"] == 2 and len(calls) == cs.train_launches_want(
        cfg, 32, accum_smoke_run["steps"])["flash_attention"] == 3 * 2 * 4
    (full,) = [r for r in _family_runs(cs) if not r["smoke"]]
    cfg = cs.lm_config(full)
    assert (cfg.name, cfg.d_model, cfg.n_layers, cfg.grad_accum, cfg.dtype,
            full["data"]["batch"], full["data"]["seq_len"]) == (
        "qwen3-0.6b", 1024, 4, 2, "float32", 4, 256)
    assert cs.run_tag(full) == "qwen3-0.6b-grad_accum2"


def test_grad_accum_check_fails_a_dropped_microbatch(monkeypatch,
                                                     accum_smoke_run):
    """``train.grad_accum_drops_last``, planted here, fails the loss check
    of the ``grad_accum=2`` run."""
    cs = _chip_smoke()
    _plant(monkeypatch, cs, "train.grad_accum_drops_last")
    errs, _ = cs.train_golden_errors(accum_smoke_run, CPU)
    assert errs["weights"] == 0 and errs["loss"] == 3, errs
