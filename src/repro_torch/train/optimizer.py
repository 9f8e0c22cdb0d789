"""AdamW + schedules, the port of ``repro/train/optimizer.py``.

The optimizer state mirrors the param tree. Every update runs in f32 in
the reference's order of operations, and the leaves are visited in sorted
key order, as ``jax.tree_util`` flattens dicts, so that ``global_norm``
sums them as the reference does. ``adamw_update`` returns new tensors and
changes none of its arguments, unless it is told to take them over
(``donate``), as the reference's jitted step takes its donated buffers.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.utils.tree import tree_leaves, tree_map


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def lr_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_frac, in f32. ``step``: an
    integer tensor or a Python int."""
    step = _f32(step)
    warm = step / max(1.0, cfg.warmup_steps)
    prog = (step - cfg.warmup_steps) / max(
        1.0, cfg.total_steps - cfg.warmup_steps)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params) -> dict:
    leaf = tree_leaves(params)[0]
    return {
        "step": torch.zeros((), dtype=torch.int32, device=leaf.device),
        "mu": tree_map(torch.zeros_like, params),
        "nu": tree_map(torch.zeros_like, params),
    }


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum, leaf by leaf in sorted key order, of each leaf's
    sum of squares in f32."""
    total = 0
    for leaf in tree_leaves(tree):
        total = total + torch.sum(torch.square(leaf.to(torch.float32)))
    return torch.sqrt(total)


# the most values of a leaf the donated update holds at a time: the f32
# temporaries of one block's update (about ten of its size) stay under 1
# GB, whatever the leaf's shape. A whole 805 M-value leaf (MusicGen-Large's
# stacked ffn weights, or Mixtral-8x22B's expert group at one layer, whose
# leading dim is 1) took ~19 GB of temporaries on the card
DONATE_BLOCK = 1 << 24


def _blocks(t: torch.Tensor) -> tuple:
    """Views of ``t`` that cover each of its values once, in memory order:
    flat blocks of at most ``DONATE_BLOCK`` values; ``t`` itself where it
    holds no more. ``t`` must be contiguous (the views are written
    through), as the params, moments and gradients of a step are."""
    if t.numel() <= DONATE_BLOCK:
        return (t,)
    assert t.is_contiguous(), f"a {tuple(t.shape)} leaf is not contiguous"
    return t.view(-1).split(DONATE_BLOCK)


def adamw_update(cfg: AdamWConfig, params, grads, state, donate=False):
    """Returns (new_params, new_state, metrics).

    ``donate=True`` writes the update over ``params`` and ``state``, a leaf
    at a time, in flat blocks of at most ``DONATE_BLOCK`` values
    (``_blocks``): each block's new
    (p, mu, nu) are computed exactly as without (the same elementwise
    operations, so the same bits), copied into its tensors, and dropped
    before the next block, so the update holds one block's temporaries,
    not a second state. It returns the tensors it was given,
    ``state["step"]`` counted up in place."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = lr_schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - _f32(b1, step.device) ** step.to(torch.float32)
    bc2 = 1 - _f32(b2, step.device) ** step.to(torch.float32)

    def upd(p, g, mu, nu):
        g = g.to(torch.float32) * scale
        mu = b1 * mu + (1 - b1) * g
        nu = b2 * nu + (1 - b2) * torch.square(g)
        mhat = mu / bc1
        nhat = nu / bc2
        step_ = mhat / (torch.sqrt(nhat) + cfg.eps)
        pf = p.to(torch.float32)
        newp = pf - lr * (step_ + cfg.weight_decay * pf)
        return newp.to(p.dtype), mu.to(p.dtype), nu.to(p.dtype)

    metrics = {"grad_norm": gnorm, "lr": lr}
    if donate:
        for leaf in zip(*(tree_leaves(t) for t in (
                params, grads, state["mu"], state["nu"]))):
            for p, g, mu, nu in zip(*map(_blocks, leaf)):
                for old, new in zip((p, mu, nu), upd(p, g, mu, nu)):
                    old.copy_(new)
                del new
        state["step"].copy_(step)
        return params, {"step": state["step"], "mu": state["mu"],
                        "nu": state["nu"]}, metrics
    outs = tree_map(upd, params, grads, state["mu"], state["nu"])
    return _pick(outs, 0), {"step": step, "mu": _pick(outs, 1),
                            "nu": _pick(outs, 2)}, metrics


def _pick(tree: dict, i: int):
    """The ``i``-th item of every (p, mu, nu) leaf of a dict tree."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    return tree[i]
