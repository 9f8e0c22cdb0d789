"""``chip_smoke.py`` phase 8's checks, rehearsed on the CPU.

The golden file's smoke run (Gemma-2 27B's smoke config: local and
global layers, both softcaps, GQA) goes through phase 8's own check
function, ``train_golden_errors``, on the CPU, where the port's attention
takes its plain forward and the backward the card runs: three AdamW steps
in f32 against the JAX package's run that wrote the file, within phase
8's limits (``TRAIN_LOSS_RTOL``, ``TRAIN_GNORM_RTOL``). Each of
``--plant-faults``' training faults, planted here, must fail it. The
attention launches phase 8 expects per step are held to the forward calls
a step makes here (the kernels cannot launch on the CPU).
"""
import pytest
import torch

from repro_torch.configs import ARCHS, SMOKE_ARCHS
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import build_model, registry
from repro_torch.models.convert import numpy_params, params_from_numpy
from repro_torch.train.data import DataConfig, make_batch
from repro_torch.train.step import compute_params, loss_and_grads
from test_torch_session import _chip_smoke, _plant


def _smoke_run(cs) -> dict:
    (run,) = [r for r in cs.train_golden() if r["smoke"]]
    return run


def test_train_golden_file_holds_on_the_cpu():
    """The smoke run through phase 8's golden check on the CPU: weights
    hash to the file's, each step's loss, grad_norm and lr within the
    limits. The full-width run's config is the port's ``qwen3-0.6b`` at
    the file's depth, in f32, at 2 x 256 tokens."""
    cs = _chip_smoke()
    errs, row = cs.train_golden_errors(_smoke_run(cs), torch.device("cpu"))
    assert errs == {"weights": 0, "loss": 0, "grad_norm": 0, "lr": 0}, (
        errs, row)
    assert max(row["loss_rel_err"]) < 1e-6
    (full,) = [r for r in cs.train_golden() if not r["smoke"]]
    cfg = cs.lm_config(full)
    assert (cfg.name, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            cfg.d_ff, cfg.vocab_size, cfg.n_layers, cfg.dtype) == (
        "qwen3-0.6b", 1024, 16, 8, 128, 3072, 151936, 4, "float32")
    assert (full["data"]["batch"], full["data"]["seq_len"]) == (2, 256)


@pytest.mark.parametrize("fault", ["train.no_grad_fn", "train.drops_gqa_sum"])
def test_train_golden_check_fails_planted_faults(monkeypatch, fault):
    """Each training fault of ``--plant-faults``, planted in this process,
    fails phase 8's golden check on the smoke run: a forward whose result
    has no ``grad_fn`` (the attention projections get no gradient: the
    wrapper's behaviour on the card before ``FlashAttentionFn``), and a
    backward that keeps one query head of each GQA group for dK and dV
    instead of their sum."""
    cs = _chip_smoke()
    _plant(monkeypatch, cs, fault)
    monkeypatch.setitem(registry.ATTENTION, "cuda", fa.flash_attention)
    errs, _ = cs.train_golden_errors(_smoke_run(cs), torch.device("cpu"))
    assert errs["weights"] == 0 and errs["grad_norm"] + errs["loss"] > 0, errs


@pytest.mark.parametrize("policy", ["full", "dots", "none"])
def test_attention_launches_per_step_are_the_forward_calls(monkeypatch,
                                                           policy):
    """``train_attention_launches`` (phase 8's expected launches a step)
    equals the calls of the kernels' wrapper in one forward and backward:
    each attention layer once, and once more in a checkpointed group's
    recompute. Qwen3-0.6B at full depth under remat "full": 56."""
    cs = _chip_smoke()
    calls = []
    real = fa.attention_forward
    monkeypatch.setattr(fa, "attention_forward",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    cfg = SMOKE_ARCHS["gemma2-27b"].replace(dtype="float32",
                                            remat_policy=policy)
    params = params_from_numpy(numpy_params(cfg, 0), "cpu")
    batch = {k: torch.as_tensor(v) for k, v in make_batch(
        DataConfig(batch=2, seq_len=16), cfg, 0).items()}
    loss_and_grads(build_model(cfg), compute_params(params, torch.float32),
                   batch)
    assert len(calls) == cs.train_attention_launches(cfg) == \
        cfg.n_layers * (1 if policy == "none" else 2)
    full = ARCHS["qwen3-0.6b"]
    assert cs.train_attention_launches(full) == 56
    assert cs.train_launches_want(full, 2048, 1) == {
        "flash_attention": 56, "flash_attention.mma": 56,
        "flash_attention.decode": 0, "flash_attention.tf32x3": 0,
        "flash_attention_combine": 0}
