"""The donated train step, the Trainer's, on the CPU.

``make_train_step(..., donate=True)`` is the port's counterpart of the
reference's ``jax.jit(step, donate_argnums=(0, 1))``: the update is
written over the params and the optimizer state a leaf at a time, and the
f32 sum of ``grad_accum``'s microbatches is added to in place. It must
give the functional step's bits (the same operations in the same order)
and hold one train state, not two. Smoke configs in their own dtypes
(bf16 compute over f32 master weights), two steps from the same numpy
weights and ``make_batch``'s batches.
"""
import contextlib
import functools
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKE_ARCHS as J_SMOKE
from repro.train.data import DataConfig as JDataConfig
from repro.train.loop import Trainer as JTrainer
from repro.train.loop import TrainerConfig as JTrainerConfig
from repro.train.optimizer import AdamWConfig as JAdamW
from repro.train.optimizer import init_opt_state as j_init_opt_state
from repro_torch.configs import SMOKE_ARCHS
from repro_torch.models import build_model
from repro_torch.models.convert import numpy_params, params_from_numpy
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.data import DataConfig, make_batch
from repro_torch.train.loop import Trainer, TrainerConfig
from repro_torch.train import optimizer
from repro_torch.train.optimizer import (AdamWConfig, adamw_update,
                                         init_opt_state)
from repro_torch.train.step import make_train_step
from repro_torch.utils.tree import tree_leaves, tree_map
from test_torch_session import _chip_smoke

# one smoke config a family whose step differs: tokens, embeddings at
# M-RoPE positions, codebooks under a microbatch sum, the chunked WKV
CONFIGS = {"dense": ("qwen3-0.6b", {}), "vlm": ("qwen2-vl-2b", {}),
           "audio": ("musicgen-large", {"grad_accum": 2}),
           "ssm": ("rwkv6-1.6b", {})}
OPT = dict(lr=1e-3, warmup_steps=0, total_steps=10)
STEPS = 2


def _state_ptrs(params, state) -> list:
    return [t.untyped_storage().data_ptr()
            for t in tree_leaves((params, state["mu"], state["nu"]))]


@functools.lru_cache(maxsize=None)
def _run(kind: str, donate: bool) -> dict:
    """``STEPS`` steps of the ``kind`` smoke config: the state after them,
    each step's metrics, and whether every param, mu and nu leaf kept its
    storage through the steps (and is the tensor it was given)."""
    name, kw = CONFIGS[kind]
    cfg = SMOKE_ARCHS[name].replace(**kw)
    dcfg = DataConfig(seed=1, batch=4, seq_len=64)
    params = params_from_numpy(numpy_params(cfg, 0), "cpu")
    state = init_opt_state(params)
    given = tree_leaves((params, state["mu"], state["nu"]))
    ptrs = _state_ptrs(params, state)
    step = make_train_step(build_model(cfg), AdamWConfig(**OPT),
                           donate=donate)
    metrics = []
    for s in range(STEPS):
        batch = {k: torch.as_tensor(v)
                 for k, v in make_batch(dcfg, cfg, s).items()}
        params, state, m = step(params, state, batch)
        metrics.append(m)
    kept = all(a is b for a, b in zip(
        given, tree_leaves((params, state["mu"], state["nu"]))))
    return dict(params=params, state=state, metrics=metrics,
                same_storage=_state_ptrs(params, state) == ptrs,
                same_tensors=kept)


@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_donated_step_equals_the_functional_step_by_bits(kind):
    """Params, mu, nu and the step count after two steps, and each step's
    loss and grad_norm: the donated step's bits are the functional
    step's."""
    got, want = _run(kind, True), _run(kind, False)
    for a, b in zip(tree_leaves((got["params"], got["state"])),
                    tree_leaves((want["params"], want["state"]))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(got["state"]["step"]) == STEPS
    for a, b in zip(got["metrics"], want["metrics"]):
        for k in ("loss", "grad_norm", "lr"):
            assert torch.equal(a[k], b[k]), (k, a[k], b[k])


@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_donated_step_keeps_every_leaf_storage(kind):
    """After the donated steps every param, mu and nu leaf is the tensor it
    was given, on the storage it had: no second state was allocated. The
    functional step's leaves are new ones."""
    got, want = _run(kind, True), _run(kind, False)
    assert got["same_storage"] and got["same_tensors"]
    assert not want["same_storage"] and not want["same_tensors"]


def test_donated_update_in_blocks_equals_the_functional_update(
        monkeypatch):
    """A leaf over ``DONATE_BLOCK`` elements is updated in blocks of its
    leading dim, views written in place: the bits of the functional
    update, nonzero moments and bf16 gradients, with a (3, 7, 5) stack in
    blocks of one row and an (11, 5) table in blocks of 7 and 4 rows; a
    vector and a scalar whole."""
    monkeypatch.setattr(optimizer, "DONATE_BLOCK", 35)
    gen = torch.Generator().manual_seed(0)
    shapes = {"stack": (3, 7, 5), "table": (11, 5), "vec": (13,),
              "scalar": ()}

    def draw(dtype=torch.float32, square=False):
        return {k: (torch.randn(s, generator=gen) ** (2 if square else 1)
                    ).to(dtype) for k, s in shapes.items()}
    params, grads = draw(), draw(torch.bfloat16)
    state = {"step": torch.tensor(3, dtype=torch.int32), "mu": draw(),
             "nu": draw(square=True)}
    assert [len(optimizer._blocks(params[k])) for k in shapes] == [3, 2, 1, 1]
    cfg = AdamWConfig(**OPT)
    copy = tree_map(torch.clone, {"p": params, **state})
    want = adamw_update(cfg, copy["p"], grads,
                        {k: copy[k] for k in ("step", "mu", "nu")})
    got = adamw_update(cfg, params, grads, state, donate=True)
    assert got[0] is params and got[1]["mu"] is state["mu"]
    for a, b in zip(tree_leaves(got[:2]), tree_leaves(want[:2])):
        assert torch.equal(a, b)
    assert torch.equal(got[2]["grad_norm"], want[2]["grad_norm"])


def test_async_checkpoint_keeps_its_step_under_donation(tmp_path):
    """A Trainer with ``async_ckpt`` saves every step while the next step
    overwrites the same tensors: each checkpoint restores to the hashes of
    the state taken right after its step (``chip_smoke.state_hashes``,
    phase 8's check), though the tensors hold a later step by then."""
    cs = _chip_smoke()
    cfg = SMOKE_ARCHS["qwen3-0.6b"]
    tr = Trainer(cfg, DataConfig(seed=0, batch=2, seq_len=32),
                 AdamWConfig(**OPT),
                 TrainerConfig(num_steps=3, log_every=100, ckpt_every=1,
                               ckpt_dir=str(tmp_path), keep_ckpts=5,
                               async_ckpt=True), device="cpu")
    inner, hashes, given = tr.step_fn, {}, []

    def step_fn(params, opt_state, batch):
        given.append(tree_leaves(params)[0])
        out = inner(params, opt_state, batch)
        hashes[len(hashes) + 1] = cs.state_hashes(out[:2])
        return out
    tr.step_fn = step_fn
    with contextlib.redirect_stdout(io.StringIO()):
        params, state, hist = tr.run(3)
    assert len(hist) == 3
    assert all(x is given[0] for x in given + tree_leaves(params)[:1])
    mgr = CheckpointManager(str(tmp_path))
    for step in (1, 2, 3):
        restored, at = mgr.restore((params, state), step=step)
        assert at == step and cs.state_hashes(restored) == hashes[step]
    assert hashes[1] != hashes[3]
    assert cs.state_hashes((params, state)) == hashes[3]


def test_donated_trainer_gives_the_jax_trainers_losses():
    """The port's Trainer (donated step) and the JAX package's Trainer
    (jitted, donated) from the same numpy weights, on the same
    ``make_batch`` stream, in f32: every step's loss within 1e-5 relative,
    grad_norm within the reference's 1e-4 (tests/test_train.py)."""
    cfg = SMOKE_ARCHS["qwen3-0.6b"].replace(dtype="float32")
    jcfg = J_SMOKE["qwen3-0.6b"].replace(dtype="float32")
    w = numpy_params(cfg, 0)
    steps = 4
    tcfg = dict(num_steps=steps, log_every=100)
    tr = Trainer(cfg, DataConfig(seed=0, batch=2, seq_len=32),
                 AdamWConfig(**OPT), TrainerConfig(**tcfg), device="cpu")
    # a fresh draw: on the CPU the params share the numpy arrays' memory,
    # which the donated step writes
    tr.init_params = lambda: params_from_numpy(numpy_params(cfg, 0), "cpu")
    jtr = JTrainer(jcfg, JDataConfig(seed=0, batch=2, seq_len=32),
                   JAdamW(**OPT), JTrainerConfig(**tcfg))

    def j_init():
        p = jax.tree_util.tree_map(jnp.asarray, w)
        return p, j_init_opt_state(p), 0
    jtr.init_or_resume = j_init
    with contextlib.redirect_stdout(io.StringIO()):
        got = tr.run(steps)[2]
        want = jtr.run(steps)[2]
    assert [h["step"] for h in got] == [h["step"] for h in want]
    np.testing.assert_allclose([h["loss"] for h in got],
                               [h["loss"] for h in want], rtol=1e-5)
    np.testing.assert_allclose([h["grad_norm"] for h in got],
                               [h["grad_norm"] for h in want], rtol=1e-4)
    assert got[-1]["loss"] < got[0]["loss"]
