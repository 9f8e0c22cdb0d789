"""Griffin / RecurrentGemma RG-LRU recurrent block (arXiv:2402.19427).

The port of ``repro/models/griffin.py``. Recurrent block:
    x -> [linear -> causal conv1d(w=4) -> RG-LRU]  *  [linear -> GeLU] -> linear

RG-LRU (elementwise gated linear recurrence; block-diagonal gate projections
with n_heads blocks, as in the released RecurrentGemma code):
    r_t = sigmoid(W_a u_t);  i_t = sigmoid(W_x u_t)
    log a_t = -c * softplus(Lambda) * r_t            (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)

The recurrence runs through ``layers.associative_scan`` in the reference's
association: log2(T) levels of elementwise kernels on the card, no loop
over T. The gates and the recurrence run in f32 on the f32 weights, as the
reference reads them; the projections, the conv and the gelu run in the
activation dtype, each step rounded where the reference rounds.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (Spec, act_fn, associative_scan,
                                       sigmoid, softplus)
from repro_torch.sharding import lshard

RGLRU_C = 8.0


def rglru_specs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    w = cfg.lru_width or d
    h = cfg.n_heads
    bw = w // h
    return {
        "wx": Spec((d, w), ("d_model", "lru")),
        "wy": Spec((d, w), ("d_model", "lru")),
        "conv_w": Spec((cfg.conv1d_width, w), ("conv_w", "lru"), scale=0.02),
        "conv_b": Spec((w,), ("lru",), "zeros"),
        "gate_a": Spec((h, bw, bw), ("heads", "lru", "lru")),
        "gate_a_b": Spec((h, bw), ("heads", "lru"), "zeros"),
        "gate_x": Spec((h, bw, bw), ("heads", "lru", "lru")),
        "gate_x_b": Spec((h, bw), ("heads", "lru"), "zeros"),
        "lam": Spec((w,), ("lru",), "lambda"),
        "wo": Spec((w, d), ("lru", "d_model")),
    }


def _causal_conv1d(u, w, b, *, state=None):
    """Depthwise causal conv, width K. u (B,T,W); state (B,K-1,W) or None.

    K shifted multiplies added in the reference's order, ``+ b`` last, each
    step rounded to u's dtype (a ``conv1d`` call would round once).
    Returns (y, new_state)."""
    K = w.shape[0]
    B, T, W = u.shape
    if state is None:
        state = torch.zeros((B, K - 1, W), dtype=u.dtype, device=u.device)
    ext = torch.cat([state, u], dim=1)                  # (B, T+K-1, W)
    y = torch.zeros_like(u)
    for i in range(K):
        # tap i multiplies input delayed by (K-1-i)
        y = y + ext[:, i:i + T] * w[i]
    y = y + b
    return y, ext[:, -(K - 1):] if K > 1 else state


def _gates(p, u, cfg: ModelConfig):
    """Block-diagonal gate projections. u (B,T,W) -> (log_a, gated_in) f32."""
    B, T, W = u.shape
    h = cfg.n_heads
    bw = W // h
    f32 = torch.float32
    ub = u.reshape(B, T, h, bw).to(f32)
    r = sigmoid(torch.einsum("bthw,hwv->bthv", ub, p["gate_a"].to(f32))
                + p["gate_a_b"].to(f32))
    i = sigmoid(torch.einsum("bthw,hwv->bthv", ub, p["gate_x"].to(f32))
                + p["gate_x_b"].to(f32))
    r = r.reshape(B, T, W)
    i = i.reshape(B, T, W)
    log_a = -RGLRU_C * softplus(p["lam"].to(f32)) * r     # <= 0
    # sqrt(1 - a^2) computed stably as sqrt(-expm1(2 log a))
    beta = torch.sqrt(-torch.expm1(2.0 * log_a))
    gated = beta * (i * u.to(f32))
    return log_a, gated


def _combine(c1, c2):
    """(a1, b1) then (a2, b2): a2 * b1 + b2 as one fused multiply-add,
    rounded once, as XLA's CPU build of the reference contracts it."""
    a1, b1 = c1
    a2, b2 = c2
    return a1 * a2, torch.addcmul(b2, a2, b1)


def rglru_scan(log_a, x, h0=None):
    """h_t = a_t h_{t-1} + x_t via associative scan. (B,T,W) f32."""
    a = torch.exp(log_a)
    if h0 is not None:
        x = x.clone()
        x[:, 0] += a[:, 0] * h0
    _, h = associative_scan(_combine, (a, x), dim=1)
    return h


def rglru_block(p, x, cfg: ModelConfig, *, conv_state=None, h0=None):
    """Full recurrent block. x (B,T,d). Returns (y, (conv_state, h_last))."""
    dt = x.dtype
    u = torch.matmul(x, p["wx"].to(dt))
    u = lshard(u, "batch", "seq", "lru")
    gate = act_fn("gelu")(torch.matmul(x, p["wy"].to(dt)))
    u, new_conv = _causal_conv1d(u, p["conv_w"].to(dt), p["conv_b"].to(dt),
                                 state=conv_state)
    log_a, gated = _gates(p, u, cfg)
    h = rglru_scan(log_a, gated, h0)
    # the last state leaves in the activation dtype, as the reference's
    # (its h is re-bound to the cast); rglru_decode's is f32
    h = lshard(h.to(dt), "batch", "seq", "lru")
    y = torch.matmul(h * gate, p["wo"].to(dt))
    return y, (new_conv, h[:, -1])


def rglru_decode(p, x, conv_state, h_prev, cfg: ModelConfig):
    """Single-step decode: x (B,1,d); h_prev (B,W) f32."""
    dt = x.dtype
    u = torch.matmul(x, p["wx"].to(dt))
    gate = act_fn("gelu")(torch.matmul(x, p["wy"].to(dt)))
    u, new_conv = _causal_conv1d(u, p["conv_w"].to(dt), p["conv_b"].to(dt),
                                 state=conv_state)
    log_a, gated = _gates(p, u, cfg)
    h = torch.exp(log_a[:, 0]) * h_prev + gated[:, 0]     # (B,W) f32
    y = torch.matmul(h[:, None].to(dt) * gate, p["wo"].to(dt))
    return y, (new_conv, h)


def init_rglru_state(cfg: ModelConfig, batch: int, dtype, device):
    w = cfg.lru_width or cfg.d_model
    return (torch.zeros((batch, cfg.conv1d_width - 1, w), dtype=dtype,
                        device=device),
            torch.zeros((batch, w), dtype=torch.float32, device=device))
