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

Under logical rules (DTensors; ``sharding.logical.on_shards``), where the
reference leaves the dispatch to GSPMD: each token is routed on the rank
that holds it; the (T*K) expert choices and gates are gathered to every
rank, which builds the whole (E, C) slot tables from them (capacity and
positions over the step's T tokens, in token-major order, so the same
tokens drop and the slots are ordered as on one device); each rank gathers
the tokens of its block of the dispatch buffer, whose placements are the
rules' for ("experts", cap, d), and adds its block's outputs into the
tokens' rows, a ``Partial`` over the mesh dims that split the experts,
which the rules' activation placements then reduce. The experts' products
are ``torch.bmm`` on DTensors, as the reference's are einsums outside any
kernel. Plain tensors take the same ops as before, by bits.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import Spec, act_fn
from repro_torch.sharding import get_rules, lshard
from repro_torch.sharding.logical import (linear, merge_dims, on_shards,
                                          replicated, split_dim)


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


def _route(logits, k: int) -> tuple:
    """Per token: the softmax over the experts, the top k with their gates
    renormalized, and the top-1 choice one-hot. Rows are independent."""
    probs = torch.softmax(logits, dim=-1)                        # (T, E)
    gate_vals, expert_idx = top_k(probs, k)                      # (T, K)
    gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)
    top1 = F.one_hot(expert_idx[:, 0], logits.shape[-1]).to(torch.float32)
    return probs, gate_vals, expert_idx, top1


def _slots(flat_expert, E: int, C: int, K: int) -> tuple:
    """From each (token, choice)'s expert, token-major: kept or dropped
    (position in expert from a cumsum, against the capacity C), the slot
    index of each (dropped ones to row E), and the (E, C) tables of token
    ids and of valid slots."""
    T = flat_expert.shape[0] // K
    dev = flat_expert.device
    sel = F.one_hot(flat_expert, E).to(torch.int32)              # (T*K, E)
    csum = torch.cumsum(sel, dim=0)
    pos = ((csum - sel) * sel).sum(-1)                           # (T*K,)
    keep = pos < C
    token_id = torch.arange(T, device=dev).repeat_interleave(K)
    slot = (torch.where(keep, flat_expert, E),                   # drop -> row E
            torch.where(keep, pos, 0))
    slot_table = torch.zeros((E + 1, C), dtype=torch.long,
                             device=dev).index_put_(slot, token_id)[:E]
    slot_valid = torch.zeros((E + 1, C), dtype=torch.bool,
                             device=dev).index_put_(slot, keep)[:E]
    return keep, slot, slot_table, slot_valid


def _placements(x, names, shape) -> tuple:
    """For DTensor ``x``: the rules' placements of an activation of
    ``names`` and ``shape`` on ``x``'s mesh (all ``Replicate()`` without
    rules), and a replicated DTensor maker on that mesh. For a plain
    ``x``: no placements, and the identity."""
    if not isinstance(x, DTensor):
        return [], lambda t: t
    mesh, r = x.device_mesh, get_rules()
    pl = r.sharding(names, shape, is_act=True).placements() if r else \
        [Replicate()] * mesh.ndim

    def rep(t):
        return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                  run_check=False)
    return pl, rep


def moe_apply(p, x, cfg: ModelConfig):
    """x: (B, S, d) -> (y, aux) with load-balance aux loss."""
    B, S, d = x.shape
    T = B * S
    E, K = cfg.n_experts, cfg.top_k
    C = capacity(cfg, T)
    dt = x.dtype
    f32 = torch.float32
    xf = merge_dims(x, 0)
    cap_name = "batch" if cfg.moe_shard_tokens else "expert_cap"
    d_name = None if cfg.moe_shard_tokens else "d_model"
    # under rules a rank gathers the tokens of its block of the (E, C, d)
    # dispatch buffer (``pl``) from all T rows, its d slice (``xpl``), by
    # its block of the slot tables (``tpl``), and adds its block's outputs
    # into all T rows: its d slice, a ``Partial`` over the mesh dims that
    # split E or C (``tok``), as is the rows' gradient of its gather
    pl, rep = _placements(x, ("experts", cap_name, d_name), (E, C, d))
    xpl = [Shard(1) if q.is_shard(2) else Replicate() for q in pl]
    tpl = [q if q.is_shard() and q.dim < 2 else Replicate() for q in pl]
    tok = [Shard(1) if q.is_shard(2) else Partial() if q.is_shard()
           else Replicate() for q in pl]
    full = [Replicate()] * len(pl)

    # --- routing (f32 for numerics), each token where it is held ---
    logits = linear(xf.to(f32), p["router"].to(f32))
    rows = [q if q.is_shard(0) else Replicate()
            for q in getattr(logits, "placements", ())]
    probs, gate_vals, expert_idx, top1 = on_shards(
        functools.partial(_route, k=K), (logits,), (rows,), (rows,) * 4)

    # --- load-balancing aux loss (Switch eq. 4) ---
    me = probs.mean(0)                                           # (E,)
    ce = top1.mean(0)
    aux = E * torch.sum(me * ce)

    # --- position within expert (capacity assignment), over all T ---
    flat_expert = replicated(merge_dims(expert_idx, 0))          # token-major
    keep, slot, slot_table, slot_valid = _slots(flat_expert, E, C, K)
    gate_ec = on_shards(
        lambda g: torch.zeros((E + 1, C), dtype=f32, device=g.device)
        .index_put_(slot, g * keep.to(f32))[:E],
        (merge_dims(gate_vals, 0),), (full,), (full,))

    # --- dispatch: gather the tokens of the (E, C) slots ---
    tabs = (rep(slot_table), rep(slot_valid))
    xe = on_shards(lambda t, tab, valid: t[tab] * valid[..., None].to(dt),
                   (xf,) + tabs, (xpl, tpl, tpl), (pl,), (tok, None, None))
    xe = lshard(xe, "experts", cap_name, d_name)                 # (E, C, d)

    # --- expert FFN ---
    a = act_fn(cfg.mlp_act)
    h = a(torch.bmm(xe, p["wg"].to(dt)))
    h = h * torch.bmm(xe, p["wi"].to(dt))
    h = lshard(h, "experts", cap_name, "moe_d_ff")
    ye = torch.bmm(h, p["wo"].to(dt))
    ye = lshard(ye, "experts", cap_name, d_name)

    # --- combine: weighted scatter-add back to tokens ---
    # invalid slots all point at token 0 with gate 0 -> contribute nothing
    y = on_shards(
        lambda c, tab: torch.zeros((T, c.shape[-1]), dtype=f32,
                                   device=c.device).index_add_(
            0, tab.reshape(-1), c.reshape(-1, c.shape[-1]).to(f32)),
        (ye * gate_ec[..., None].to(dt), tabs[0]), (pl, tpl), (tok,))
    y = lshard(split_dim(y, 0, (B, S)), "batch", "seq", "d_model")
    return y.to(dt), aux
