"""The port's training substrate (repro_torch/train): optimizer,
checkpointing, data, fault tolerance and the Trainer, on the CPU.

Mirrors tests/test_train.py test by test, with the same limits, except
``test_surviving_mesh_and_elastic_restore``, whose mesh and logical
shardings wait for the port of ``sharding/`` and ``launch/``. The JAX
package is not imported here: tests/test_torch_train_parity.py holds the
port against it.

Tolerances, as the reference's: grad_accum=2 against one step, rtol 1e-5
on the loss and 1e-4 on the gradient norm (f32, sums in another order);
checkpoints equal exactly.
"""
import os

import numpy as np
import pytest
import torch

from repro_torch.configs import SMOKE_ARCHS
from repro_torch.models import build_model
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.data import DataConfig, DataLoader, make_batch
from repro_torch.train.fault_tolerance import (HeartbeatMonitor,
                                               StragglerDetector)
from repro_torch.train.loop import Trainer, TrainerConfig
from repro_torch.train.optimizer import (AdamWConfig, adamw_update,
                                         global_norm, init_opt_state,
                                         lr_schedule)
from repro_torch.train.step import make_train_step


def test_adamw_minimizes_quadratic():
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=0,
                      total_steps=200, grad_clip=10.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = init_opt_state(params)
    for _ in range(150):
        grads = {"w": 2 * params["w"]}
        params, state, _ = adamw_update(cfg, params, grads, state)
    assert float(torch.max(torch.abs(params["w"]))) < 0.05


def test_lr_schedule_shape():
    cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                      min_lr_frac=0.1)
    lrs = [float(lr_schedule(cfg, torch.tensor(s))) for s in range(0, 101, 10)]
    assert lrs[0] == 0.0
    assert abs(lrs[1] - 1.0) < 1e-6             # end of warmup
    assert lrs[-1] == pytest.approx(0.1, rel=1e-3)
    assert all(a >= b - 1e-9 for a, b in zip(lrs[1:], lrs[2:]))  # decaying


def test_grad_clip():
    cfg = AdamWConfig(grad_clip=1.0, lr=1.0, warmup_steps=0, total_steps=10)
    params = {"w": torch.zeros(4)}
    state = init_opt_state(params)
    big = {"w": torch.full((4,), 100.0)}
    p2, _, m = adamw_update(cfg, params, big, state)
    assert float(m["grad_norm"]) > 100
    assert float(torch.max(torch.abs(p2["w"]))) < 1.5   # clipped step


def test_adamw_changes_none_of_its_arguments():
    """``adamw_update`` returns new tensors: the params, gradients and
    state it was given hold what they held (the async checkpoint of a step
    relies on nothing changing them)."""
    cfg = AdamWConfig(lr=0.1, warmup_steps=0, total_steps=10)
    params = {"b": torch.ones(3), "a": {"w": torch.arange(4.0)}}
    grads = {"b": torch.full((3,), 0.5), "a": {"w": -torch.ones(4)}}
    state = init_opt_state(params)
    before = [t.clone() for t in (params["b"], params["a"]["w"],
                                  grads["b"], state["mu"]["b"])]
    p2, s2, _ = adamw_update(cfg, params, grads, state)
    after = (params["b"], params["a"]["w"], grads["b"], state["mu"]["b"])
    assert all(torch.equal(x, y) for x, y in zip(before, after))
    assert int(state["step"]) == 0 and int(s2["step"]) == 1
    assert not torch.equal(p2["b"], params["b"])


def test_global_norm_sums_leaves_in_sorted_key_order():
    """The leaves are summed in sorted key order, as jax.tree_util
    flattens dicts, whatever order the dict was built in: the same bits.
    (With seed 21 the insertion orders give other bits.)"""
    rng = np.random.default_rng(21)
    vals = {k: torch.as_tensor((rng.standard_normal(97)
                                * 10.0 ** rng.integers(-3, 3)).astype(
                                    np.float32))
            for k in ("c", "a", "b")}
    shuffled = {k: vals[k] for k in ("b", "c", "a")}
    want = torch.sqrt(sum(torch.sum(torch.square(vals[k]))
                          for k in ("a", "b", "c")))
    assert not torch.equal(torch.sqrt(sum(torch.sum(torch.square(x))
                                          for x in shuffled.values())), want)
    assert torch.equal(global_norm(shuffled), want)
    assert torch.equal(global_norm(vals), want)


def test_grad_accum_equivalence():
    """grad_accum=2 must reproduce the single-step loss and gradient norm
    (f32 compute; post-AdamW params are sign-sensitive to float noise, so the
    comparison targets the accumulated gradients)."""
    cfg = SMOKE_ARCHS["qwen3-0.6b"].replace(dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    opt = AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    gen = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 16), generator=gen),
             "labels": torch.randint(0, cfg.vocab_size, (4, 16), generator=gen)}
    s1 = make_train_step(model, opt, grad_accum=1)
    s2 = make_train_step(model, opt, grad_accum=2)
    st = init_opt_state(params)
    _, _, m1 = s1(params, st, batch)
    _, _, m2 = s2(params, st, batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m1["grad_norm"]), float(m2["grad_norm"]),
                               rtol=1e-4)


# ---------------------------------------------------------------------------
# checkpointing
# ---------------------------------------------------------------------------
def test_checkpoint_roundtrip_and_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last_k=2)
    tree = {"a": torch.arange(6).reshape(2, 3), "b": {"c": torch.ones(4)},
            "l": [torch.zeros(2), torch.ones(1)]}
    for step in (1, 2, 3):
        mgr.save(step, {"a": tree["a"] + step, "b": {"c": tree["b"]["c"] + step},
                        "l": [x + step for x in tree["l"]]})
    assert mgr.all_steps() == [2, 3]            # pruned to keep_last_k
    restored, step = mgr.restore(tree)
    assert step == 3
    np.testing.assert_array_equal(restored["a"].numpy(), tree["a"].numpy() + 3)
    assert isinstance(restored["l"], list)


def test_checkpoint_async(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    tree = {"w": torch.ones((32, 32))}
    mgr.save(5, tree)
    mgr.wait()
    r, s = mgr.restore(tree)
    assert s == 5
    np.testing.assert_array_equal(r["w"].numpy(), np.ones((32, 32)))


def test_checkpoint_async_holds_the_step_it_was_given(tmp_path):
    """The host copy is taken before the save thread starts: a tensor
    changed in place right after ``save`` returns is saved as it was."""
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    tree = {"w": torch.ones((256, 256)), "b": torch.full((3,), 2.0,
                                                         dtype=torch.bfloat16)}
    mgr.save(1, tree)
    tree["w"].add_(1.0)
    tree["b"].zero_()
    mgr.wait()
    r, _ = mgr.restore(tree)
    assert torch.equal(r["w"], torch.ones((256, 256)))
    assert r["b"].dtype == torch.bfloat16 and torch.equal(
        r["b"], torch.full((3,), 2.0, dtype=torch.bfloat16))


def test_trainer_resume(tmp_path):
    """Loss decreases and resume continues from the checkpointed step."""
    cfg = SMOKE_ARCHS["qwen3-0.6b"]
    dcfg = DataConfig(seed=0, batch=4, seq_len=32)
    ocfg = AdamWConfig(lr=5e-3, warmup_steps=5, total_steps=60)
    tcfg = TrainerConfig(num_steps=20, log_every=100, ckpt_every=10,
                         ckpt_dir=str(tmp_path), async_ckpt=False)
    tr = Trainer(cfg, dcfg, ocfg, tcfg, device="cpu")
    _, _, hist1 = tr.run(20)
    assert hist1[-1]["loss"] < hist1[0]["loss"]
    tr2 = Trainer(cfg, dcfg, ocfg, tcfg, device="cpu")
    _, _, hist2 = tr2.run(25)
    assert hist2[0]["step"] == 21               # resumed, not restarted


def test_trainer_defaults_to_the_card():
    """Without ``device`` the Trainer asks for CUDA, and raises where there
    is none; ``device="cpu"`` is explicit."""
    assert not torch.cuda.is_available()
    args = (SMOKE_ARCHS["qwen3-0.6b"], DataConfig(), AdamWConfig(),
            TrainerConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(*args)
    assert Trainer(*args, device="cpu").device == torch.device("cpu")


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------
def test_data_determinism_and_seek():
    cfg = SMOKE_ARCHS["qwen3-0.6b"]
    dcfg = DataConfig(seed=3, batch=4, seq_len=16)
    b1 = make_batch(dcfg, cfg, 7)
    b2 = make_batch(dcfg, cfg, 7)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    b3 = make_batch(dcfg, cfg, 8)
    assert not np.array_equal(b1["tokens"], b3["tokens"])
    # loader resumes mid-stream identically
    l1 = DataLoader(dcfg, cfg, start_step=0)
    seq_a = [next(l1)["tokens"] for _ in range(4)]
    l1.close()
    l2 = DataLoader(dcfg, cfg, start_step=2)
    seq_b = [next(l2)["tokens"] for _ in range(2)]
    l2.close()
    np.testing.assert_array_equal(seq_a[2], seq_b[0])
    np.testing.assert_array_equal(seq_a[3], seq_b[1])


def test_data_hosts_disjoint():
    cfg = SMOKE_ARCHS["qwen3-0.6b"]
    a = make_batch(DataConfig(batch=8, seq_len=16, host_id=0, n_hosts=2),
                   cfg, 0)
    b = make_batch(DataConfig(batch=8, seq_len=16, host_id=1, n_hosts=2),
                   cfg, 0)
    assert a["tokens"].shape == (4, 16)
    assert not np.array_equal(a["tokens"], b["tokens"])


# ---------------------------------------------------------------------------
# fault tolerance
# ---------------------------------------------------------------------------
def test_straggler_detector():
    det = StragglerDetector(window=16, threshold=2.0)
    for s in range(12):
        assert not det.record(s, 1.0)
    assert det.record(12, 5.0)
    assert det.flagged_steps == [12]


def test_heartbeat(tmp_path):
    hb = HeartbeatMonitor(str(tmp_path), "worker0")
    hb.beat(1)
    assert hb.dead_hosts(timeout_s=60.0) == []
    assert hb.dead_hosts(timeout_s=-1.0) == ["worker0"]
    assert os.path.exists(os.path.join(str(tmp_path), "worker0.hb"))
