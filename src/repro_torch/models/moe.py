"""Capacity-based top-k Mixture-of-Experts (GShard/Switch-style dispatch).

The port of ``repro/models/moe.py``, with the same static-shape dispatch:
  1. router softmax over experts, top-k per token;
  2. position-in-expert via cumsum over a (T, E) one-hot; tokens beyond the
     per-expert capacity C are dropped (standard capacity-factor semantics);
  3. gather tokens to (E, C, d), batched expert FFN, weighted scatter-add back.

What changes with the framework: the reference's log-depth
``associative_scan`` (chosen for XLA's cost model) is ``torch.cumsum``; its
``.at[].set/add`` scatters are ``index_put_``/``index_add_``. Dropped
tokens all land in row E of the slot tables, which is thrown away, so which
of their duplicate writes wins does not matter. ``jax.lax.top_k`` breaks
ties toward the lower expert index; ``torch.topk`` does not promise an
order, so ``top_k`` takes the first K of a stable sort.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import Spec, act_fn
from repro_torch.sharding import lshard
from repro_torch.sharding.logical import merge_dims


def moe_specs(cfg: ModelConfig) -> dict:
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    return {
        "router": Spec((d, e), ("d_model", "experts"), scale=0.02),
        "wi": Spec((e, d, f), ("experts", "d_model", "moe_d_ff")),
        "wg": Spec((e, d, f), ("experts", "d_model", "moe_d_ff")),
        "wo": Spec((e, f, d), ("experts", "moe_d_ff", "d_model")),
    }


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    c = int(cfg.capacity_factor * cfg.top_k * n_tokens / cfg.n_experts)
    return max(cfg.top_k, -(-c // 8) * 8)  # round up to 8 for tiling


def top_k(x, k: int) -> tuple:
    """(values, indices) of the k largest along the last axis, largest
    first, ties to the lower index: ``jax.lax.top_k``'s order on x without
    NaN or -0.0, as a softmax gives."""
    idx = torch.sort(-x, dim=-1, stable=True).indices[..., :k]
    return torch.gather(x, -1, idx), idx


def moe_apply(p, x, cfg: ModelConfig):
    """x: (B, S, d) -> (y, aux) with load-balance aux loss."""
    B, S, d = x.shape
    T = B * S
    E, K = cfg.n_experts, cfg.top_k
    C = capacity(cfg, T)
    dt, dev = x.dtype, x.device
    xf = merge_dims(x, 0)

    # --- routing (f32 for numerics) ---
    logits = torch.matmul(xf.to(torch.float32),
                          p["router"].to(torch.float32))
    probs = torch.softmax(logits, dim=-1)                        # (T, E)
    gate_vals, expert_idx = top_k(probs, K)                      # (T, K)
    gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)

    # --- load-balancing aux loss (Switch eq. 4) ---
    me = probs.mean(0)                                           # (E,)
    ce = F.one_hot(expert_idx[:, 0], E).to(torch.float32).mean(0)
    aux = E * torch.sum(me * ce)

    # --- position within expert (capacity assignment) ---
    flat_expert = expert_idx.reshape(T * K)                      # token-major
    sel = F.one_hot(flat_expert, E).to(torch.int32)              # (T*K, E)
    csum = torch.cumsum(sel, dim=0)
    pos = ((csum - sel) * sel).sum(-1)                           # (T*K,)
    keep = pos < C
    gate_flat = gate_vals.reshape(T * K) * keep.to(torch.float32)

    # --- dispatch: scatter token ids into (E, C) slot table ---
    token_id = torch.arange(T, device=dev).repeat_interleave(K)
    slot = (torch.where(keep, flat_expert, E),                   # drop -> row E
            torch.where(keep, pos, 0))
    slot_table = torch.zeros((E + 1, C), dtype=torch.long,
                             device=dev).index_put_(slot, token_id)[:E]
    slot_valid = torch.zeros((E + 1, C), dtype=torch.bool,
                             device=dev).index_put_(slot, keep)[:E]

    xe = xf[slot_table]                                          # (E, C, d)
    xe = xe * slot_valid[..., None].to(dt)
    cap_name = "batch" if cfg.moe_shard_tokens else "expert_cap"
    d_name = None if cfg.moe_shard_tokens else "d_model"
    xe = lshard(xe, "experts", cap_name, d_name)

    # --- expert FFN ---
    a = act_fn(cfg.mlp_act)
    h = a(torch.bmm(xe, p["wg"].to(dt)))
    h = h * torch.bmm(xe, p["wi"].to(dt))
    h = lshard(h, "experts", cap_name, "moe_d_ff")
    ye = torch.bmm(h, p["wo"].to(dt))
    ye = lshard(ye, "experts", cap_name, d_name)

    # --- combine: weighted scatter-add back to tokens ---
    gate_ec = torch.zeros((E + 1, C), dtype=torch.float32,
                          device=dev).index_put_(slot, gate_flat)[:E]
    y = torch.zeros((T, d), dtype=torch.float32, device=dev)
    y.index_add_(0, slot_table.reshape(-1),
                 (ye * gate_ec[..., None].to(dt)).reshape(E * C, d)
                 .to(torch.float32))
    # invalid slots all point at token 0 with gate 0 -> contribute nothing
    return y.reshape(B, S, d).to(dt), aux
