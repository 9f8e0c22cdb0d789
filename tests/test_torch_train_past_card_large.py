"""The donated update's flat blocks, and ``chip_smoke.py`` phase 8's golden
file of Qwen2.5-32B, DeepSeek-67B and Mixtral-8x22B, on the CPU.

The donated update (``train/optimizer.py::adamw_update(..., donate=True)``)
takes a leaf in flat blocks of at most ``DONATE_BLOCK`` values
(``_blocks``), whatever its shape: a stacked leaf of one pattern group has
a leading dim of 1 (Mixtral-8x22B's experts at one layer, 805 M values a
leaf), which blocks of the leading dim would update whole. The update is
elementwise, so the blocks give the functional update's bits.

``tests/golden/train_past_card_large_f32.json`` (``tests/
make_train_golden.py --past-card-large``) holds the three at full width
and one layer, which only the card runs, and the Qwen2.5 and DeepSeek
smoke configs at their published GQA groups (5, with the q/k/v bias, and
8), which go through phase 8's ``train_golden_errors`` here. The planted
``train.donate_block_tail`` (a leaf's last partial block left out) must
fail both the bits and the golden.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, SMOKE_ARCHS
from repro_torch.models import build_model
from repro_torch.models.convert import numpy_params, params_from_numpy
from repro_torch.train import optimizer
from repro_torch.train.data import DataConfig, make_batch
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.step import make_train_step
from repro_torch.utils.tree import flatten_dict, tree_leaves
from test_torch_session import _chip_smoke, _plant

CPU = torch.device("cpu")
# below one row of every stacked leaf of the smoke configs (a layer's
# experts, 4 x 64 x 48 = 12,288 values) and odd, so that no leaf over it
# is a multiple of it: each has a last partial block
SMALL_BLOCK = 999
OPT = dict(lr=1e-3, warmup_steps=0, total_steps=10)
# the smoke configs of the donated-step test: Mixtral's experts, and
# Qwen2.5 at its golden's group of 5 with the q/k/v bias
SMOKE = {"mixtral-8x22b": {}, "qwen2.5-32b": dict(n_heads=10, n_kv_heads=2)}
FULL = {"qwen2.5-32b": 4, "deepseek-67b": 8, "mixtral-8x22b": 4}
SMOKE_TAGS = ("qwen2.5-32b-smoke-n_heads-n_kv_heads",
              "deepseek-67b-smoke-n_heads-n_kv_heads")


def _small_blocks(monkeypatch, n: int = SMALL_BLOCK) -> None:
    """``DONATE_BLOCK`` at ``n`` for the ``_blocks`` in use (a planted
    fault's own module has its own copy of the constant)."""
    monkeypatch.setitem(optimizer._blocks.__globals__, "DONATE_BLOCK", n)


def _runs(cs) -> dict:
    return {cs.run_tag(r): r
            for r in cs.train_golden(cs.TRAIN_GOLDEN_PAST_CARD_LARGE)}


@pytest.mark.parametrize("shape", [(1, 8, 64, 96), (3, 40, 96)])
def test_blocks_cover_a_leaf_once_in_flat_blocks(monkeypatch, shape):
    """A one-group stacked leaf (leading dim 1) and a (3, 40, 96) leaf go
    in views of at most ``DONATE_BLOCK`` values, in memory order, that
    cover each value exactly once: writing each block through its view
    numbers the leaf 0, 1, 2, ... and every block but the last is full."""
    _small_blocks(monkeypatch)
    t = torch.zeros(shape)
    blocks = optimizer._blocks(t)
    n = math.prod(shape)
    assert len(blocks) == -(-n // SMALL_BLOCK) > shape[0]
    assert all(b.numel() == SMALL_BLOCK for b in blocks[:-1])
    assert 0 < blocks[-1].numel() <= SMALL_BLOCK
    at = 0
    for b in blocks:
        assert b.untyped_storage().data_ptr() == t.untyped_storage().data_ptr()
        b.add_(torch.arange(at, at + b.numel(), dtype=t.dtype) + 1)
        at += b.numel()
    assert torch.equal(t.view(-1), torch.arange(n, dtype=t.dtype) + 1)


def test_blocks_keep_a_small_leaf_whole_and_refuse_a_strided_one(
        monkeypatch):
    """A leaf of at most ``DONATE_BLOCK`` values is its own block, a
    scalar too; a leaf over it that is not contiguous is refused, not
    copied (its blocks could not be written through)."""
    _small_blocks(monkeypatch)
    for t in (torch.zeros(()), torch.zeros(SMALL_BLOCK), torch.zeros(9, 111)):
        blocks = optimizer._blocks(t)
        assert len(blocks) == 1 and blocks[0] is t
    with pytest.raises(AssertionError):
        optimizer._blocks(torch.zeros(40, 96).t())


def _steps(name: str, donate: bool, steps: int = 2) -> dict:
    """``steps`` steps of ``name``'s smoke config (``SMOKE``'s heads) in
    its own dtypes from seeded numpy weights on ``make_batch``'s batches:
    the state after them and each step's metrics."""
    cfg = SMOKE_ARCHS[name].replace(**SMOKE[name])
    params = params_from_numpy(numpy_params(cfg, 0), CPU)
    state = init_opt_state(params)
    step = make_train_step(build_model(cfg), AdamWConfig(**OPT),
                           donate=donate)
    dcfg = DataConfig(seed=1, batch=4, seq_len=64)
    metrics = []
    for s in range(steps):
        batch = {k: torch.as_tensor(v)
                 for k, v in make_batch(dcfg, cfg, s).items()}
        params, state, m = step(params, state, batch)
        metrics.append(m)
    return dict(params=params, state=state, metrics=metrics)


def _same_bits(got: dict, want: dict) -> bool:
    leaves = zip(tree_leaves((got["params"], got["state"])),
                 tree_leaves((want["params"], want["state"])))
    return all(a.dtype == b.dtype and torch.equal(a, b) for a, b in leaves) \
        and all(torch.equal(a[k], b[k]) for a, b in zip(
            got["metrics"], want["metrics"]) for k in ("loss", "grad_norm"))


@pytest.mark.parametrize("name", sorted(SMOKE))
def test_donated_step_below_one_row_equals_the_functional_step(
        monkeypatch, name):
    """With ``DONATE_BLOCK`` below one row of every stacked leaf, the
    donated step's params, moments, loss and grad_norm after two steps
    are the functional step's by bits, and its stacked leaves did go in
    blocks inside their rows."""
    _small_blocks(monkeypatch)
    cfg = SMOKE_ARCHS[name].replace(**SMOKE[name])
    stacked = [v for k, v in flatten_dict(numpy_params(cfg, 0)).items()
               if k.startswith("scan/") and v.size > SMALL_BLOCK]
    assert stacked and all(v.size // v.shape[0] > SMALL_BLOCK
                           for v in stacked)
    assert _same_bits(_steps(name, True), _steps(name, False))


def test_donate_block_tail_fails_the_bits(monkeypatch):
    """``train.donate_block_tail`` planted (each leaf's last partial block
    left as it was): the donated step no longer gives the functional
    step's bits."""
    cs = _chip_smoke()
    _plant(monkeypatch, cs, "train.donate_block_tail")
    _small_blocks(monkeypatch)
    assert not _same_bits(_steps("qwen2.5-32b", True),
                          _steps("qwen2.5-32b", False))


@pytest.mark.parametrize("tag", SMOKE_TAGS)
def test_past_card_large_smoke_goldens_hold_on_the_cpu(tag):
    """Each smoke run of the golden file through phase 8's golden check
    (the donated step): weights hash to the file's, each step's loss,
    grad_norm and lr within the limits."""
    cs = _chip_smoke()
    errs, row = cs.train_golden_errors(_runs(cs)[tag], CPU)
    assert errs == {"weights": 0, "loss": 0, "grad_norm": 0, "lr": 0}, (
        errs, row)
    assert max(row["loss_rel_err"]) < 1e-6


def test_donate_block_tail_fails_the_smoke_golden(monkeypatch):
    """With the blocks small enough to have tails at the smoke width,
    the Qwen2.5 smoke golden holds as it is and fails with
    ``train.donate_block_tail`` planted: step 1 trains on the drawn
    weights, so its loss stays right; the later steps' do not."""
    cs = _chip_smoke()
    run = _runs(cs)[SMOKE_TAGS[0]]
    _small_blocks(monkeypatch)
    errs, _ = cs.train_golden_errors(run, CPU)
    assert errs == {"weights": 0, "loss": 0, "grad_norm": 0, "lr": 0}, errs
    _plant(monkeypatch, cs, "train.donate_block_tail")
    _small_blocks(monkeypatch)
    errs, row = cs.train_golden_errors(run, CPU)
    assert errs["weights"] == 0 and errs["loss"] > 0, errs
    assert row["loss_rel_err"][0] < cs.TRAIN_LOSS_RTOL, row


def test_past_card_large_golden_runs_are_published_widths():
    """The file's full-width runs: each config at its published width,
    one layer (one pattern group), the loss in one chunk, f32, under its
    own ``grad_accum`` (4, 8, 4), a microbatch of one sequence of 256,
    lr 1e-4, three steps, a weights sha each; Mixtral keeps its smallest
    router margin. The smoke runs at 10 / 2 and 16 / 2 heads. Checked
    from the file, without running it."""
    cs = _chip_smoke()
    runs = _runs(cs)
    assert sorted(runs) == sorted(list(FULL) + list(SMOKE_TAGS))
    for name, batch in FULL.items():
        run = runs[name]
        cfg = cs.lm_config(run)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(
            ARCHS[name].replace(n_layers=1, dtype="float32", loss_chunks=1))
        assert cfg.n_layers == len(cfg.pattern) == 1
        assert run["data"] == dict(seed=1, batch=batch, seq_len=256)
        assert batch == cfg.grad_accum > 1
        assert len(run["weights_sha256"]) == 64
        assert run["steps"] == len(run["per_step"]) == 3
        assert run["opt"]["lr"] == 1e-4
        losses = [s["loss"] for s in run["per_step"]]
        assert all(np.isfinite(losses))
    assert runs["mixtral-8x22b"]["router_margin"] > 0
    assert "router_margin" not in runs["qwen2.5-32b"]
    for tag, (heads, kv) in zip(SMOKE_TAGS, ((10, 2), (16, 2))):
        cfg = cs.lm_config(runs[tag])
        assert (cfg.n_heads, cfg.n_kv_heads) == (heads, kv)
    assert cs.lm_config(runs[SMOKE_TAGS[0]]).qkv_bias

