"""RWKV-6 "Finch" (arXiv:2404.05892): data-dependent-decay linear attention.

The port of ``repro/models/rwkv6.py``. Layer = time-mix (WKV6 recurrence) +
channel-mix, both with data-dependent token-shift lerp (the ddlerp LoRA).

WKV6 recurrence per head (key dim N, value dim N):
    S_t = diag(exp(lw_t)) S_{t-1} + k_t v_t^T          lw_t = -exp(w_t) <= 0
    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)

Prefill uses the reference's chunk-parallel form:
  * a Python loop over chunks of ``cfg.scan_chunk``, the state carried from
    one chunk to the next; a length that is no multiple of the chunk takes
    one chunk, padded to a multiple of ``SUB``, as in the reference;
  * within a chunk, sub-blocks of SUB=16: intra-sub-block terms use the
    factored r*exp(+cum) / k*exp(-cum) trick, safe in f32 because the
    per-step log-decay is clamped at -5 (exponents bounded by 5*SUB=80 <
    log(f32max)=88);
  * sub-block boundary states via ``layers.associative_scan`` over (decay,
    M) pairs, in the reference's association; every cross-block factor is
    <= 1.

The exact sequential oracle is ``kernels/ref.py::wkv6_ref``. The recurrence
runs in f32 on the f32 decay weights (``w0``, ``wd1``, ``wd2``, ``u``) and
the group norm on f32 scales, as the reference reads them; the projections
run in the activation dtype, each step rounded where the reference rounds.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (Spec, act_fn, associative_scan,
                                       group_norm, sigmoid)
from repro_torch.sharding import lshard
from repro_torch.sharding.logical import (linear, merge_dims, on_shards,
                                          shift_right, split_dim)

LW_CLAMP = -5.0   # per-step log-decay floor (exp(-5) ~ 0.0067: effectively 0)
SUB = 16          # intra-chunk sub-block size


def rwkv6_specs(cfg: ModelConfig) -> dict:
    c = cfg.d_model
    n = cfg.rwkv_head_dim
    h = c // n
    lora = 32
    return {
        "maa": Spec((6, c), ("low_rank", "d_model"), "zeros"),       # mu x,w,k,v,r,g
        "maa_w1": Spec((c, 5 * lora), ("d_model", "low_rank"), scale=0.02),
        "maa_w2": Spec((5, lora, c), ("low_rank", "low_rank", "d_model"), scale=0.02),
        "w0": Spec((c,), ("d_model",), "decay"),
        "wd1": Spec((c, 64), ("d_model", "low_rank"), scale=0.02),
        "wd2": Spec((64, c), ("low_rank", "d_model"), scale=0.02),
        "u": Spec((h, n), ("heads", "head_dim"), "uniform_small"),
        "wr": Spec((c, c), ("d_model", "d_ff")),
        "wk": Spec((c, c), ("d_model", "d_ff")),
        "wv": Spec((c, c), ("d_model", "d_ff")),
        "wg": Spec((c, c), ("d_model", "d_ff")),
        "wo": Spec((c, c), ("d_ff", "d_model")),
        "ln_x_scale": Spec((c,), ("d_model",), "ones"),
        "ln_x_bias": Spec((c,), ("d_model",), "zeros"),
    }


def rwkv6_cm_specs(cfg: ModelConfig) -> dict:
    c, f = cfg.d_model, cfg.d_ff
    return {
        "mu_k": Spec((c,), ("d_model",), "zeros"),
        "mu_r": Spec((c,), ("d_model",), "zeros"),
        "wk": Spec((c, f), ("d_model", "d_ff")),
        "wv": Spec((f, c), ("d_ff", "d_model")),
        "wr": Spec((c, c), ("d_model", "d_ff")),
    }


def _shift(x):
    """x delayed by one step along T, a zero first: the reference's
    ``pad(x, 1 before)[:, :-1]``, across shard edges under rules
    (``shift_right``)."""
    return shift_right(x, 1)


def _on_heads(fn, r, k, v, lw, u, S):
    """``fn(r, k, v, lw, u, S)`` on each rank's (batch, head) block: r, k,
    v, lw (B, ..., H, N) and S (B, H, N, N) split as r splits B and H, the
    steps and N whole; u (H, N) as r splits H. Its outputs (y like r, the
    state like S). The recurrence is independent across batch and heads,
    so the block's result is the whole one's, by bits on one rank."""
    if not isinstance(r, DTensor):
        return fn(r, k, v, lw, u, S)
    hd = r.dim() - 2
    rpl = [q if q.is_shard(0) or q.is_shard(hd) else Replicate()
           for q in r.placements]
    spl = [Shard(1) if q.is_shard(hd) else q for q in rpl]
    upl = [Shard(0) if q.is_shard(hd) else Replicate() for q in rpl]
    # u's gradient sums over the batch: a Partial where the batch is split
    ugrad = [Partial() if q.is_shard(0) else p for q, p in zip(rpl, upl)]
    return on_shards(fn, (r, k, v, lw, u, S), (rpl,) * 4 + (upl, spl),
                     (rpl, spl), (None,) * 4 + (ugrad, None))


# ---------------------------------------------------------------------------
# ddlerp projections
# ---------------------------------------------------------------------------
def _ddlerp(p, x, xprev):
    """Returns (x_w, x_k, x_v, x_r, x_g) token-shift mixes. x: (B,T,C)."""
    dt = x.dtype
    xx = xprev - x
    mx = p["maa"].to(dt)
    xxx = x + xx * mx[0]
    lora = torch.tanh(linear(xxx, p["maa_w1"].to(dt)))
    B, T, L5 = lora.shape
    lora = split_dim(lora, -1, (5, L5 // 5))
    w2 = p["maa_w2"].to(dt)
    # each token's mixes from its own LoRA: a map over (B, T) under rules
    pl = [q if q.is_shard() and q.dim < 2 else Replicate()
          for q in getattr(lora, "placements", ())]
    m = on_shards(lambda lo, w: torch.einsum("btfl,flc->fbtc", lo, w),
                  (lora, w2), (pl, [Replicate()] * len(pl)),
                  ([Shard(q.dim + 1) if q.is_shard() else q for q in pl],),
                  (None, [Partial() if q.is_shard() else q for q in pl]))
    return [x + xx * (mx[i + 1] + m[i]) for i in range(5)]


def _project(p, x, xprev, cfg: ModelConfig):
    """Compute r,k,v,g,(log-decay lw) from x and its token-shift."""
    dt = x.dtype
    f32 = torch.float32
    x_w, x_k, x_v, x_r, x_g = _ddlerp(p, x, xprev)
    r = linear(x_r, p["wr"].to(dt))
    k = linear(x_k, p["wk"].to(dt))
    v = linear(x_v, p["wv"].to(dt))
    g = act_fn("silu")(linear(x_g, p["wg"].to(dt)))
    w = p["w0"].to(f32) + linear(
        linear(x_w.to(f32), p["wd1"].to(f32)), p["wd2"].to(f32))
    lw = torch.clamp(-torch.exp(w), min=LW_CLAMP)      # (B,T,C) log decay <= 0
    B, T, C = x.shape
    n = cfg.rwkv_head_dim
    h = C // n

    def heads(z):
        return split_dim(z, -1, (h, n)).to(f32)
    return heads(r), heads(k), heads(v), g, heads(lw)


# ---------------------------------------------------------------------------
# chunk-parallel WKV6
# ---------------------------------------------------------------------------
def _combine(a, b):
    """(d1, m1) then (d2, m2): d2 * m1 + m2 as one fused multiply-add,
    rounded once, as XLA's CPU build of the reference contracts it."""
    d1, m1 = a
    d2, m2 = b
    return d2 * d1, torch.addcmul(m2, d2[..., None], m1)


def _wkv_chunk(r, k, v, lw, u, S):
    """One chunk. r,k,v,lw: (B,L,H,N) f32; u: (H,N); S: (B,H,N,N).

    Returns (y (B,L,H,N), S_out)."""
    B, L, H, N = r.shape
    nb = L // SUB
    rb = r.reshape(B, nb, SUB, H, N)
    kb = k.reshape(B, nb, SUB, H, N)
    vb = v.reshape(B, nb, SUB, H, N)
    lwb = lw.reshape(B, nb, SUB, H, N)

    cl = torch.cumsum(lwb, dim=2)                 # (B,nb,Q,H,N): cl_{t+1} incl t
    cl_in = cl - lwb                              # cl_t: cum before t
    cl_tot = cl[:, :, -1]                         # (B,nb,H,N) per-block total

    # ---- intra-sub-block (exact, factored; exponents bounded by 5*SUB) ----
    rr = rb * torch.exp(cl_in)                    # r_t * e^{cl_t}
    kk = kb * torch.exp(-cl)                      # k_s * e^{-cl_{s+1}}
    scores = torch.einsum("bnthd,bnshd->bnhts", rr, kk)
    tri = torch.tril(torch.ones((SUB, SUB), dtype=torch.bool,
                                device=r.device), -1)
    scores = torch.where(tri, scores, 0.0)
    y_intra = torch.einsum("bnhts,bnshd->bnthd", scores, vb)
    diag = torch.einsum("bnthd,hd,bnthd->bnth", rb, u, kb)  # u bonus (s == t)
    y_intra = y_intra + diag[..., None] * vb      # diagonal term

    # ---- sub-block summaries ----
    # M_b = sum_s k_s e^{cl_tot - cl_{s+1}} v_s^T  (all factors <= 1)
    kdec = kb * torch.exp(cl_tot[:, :, None] - cl)
    M = torch.einsum("bnshd,bnshe->bnhde", kdec, vb)        # (B,nb,H,N,N)
    D = torch.exp(cl_tot)                                   # (B,nb,H,N)

    # ---- boundary states via associative scan over sub-blocks ----
    Dc, Mc = associative_scan(_combine, (D, M), dim=1)
    # state at START of block b: P_b = prod_{p<b} D_p ; S_b = P_b*S_in + Mc_{b-1}
    P = torch.cat([torch.ones_like(Dc[:, :1]), Dc[:, :-1]], dim=1)
    Mprev = torch.cat([torch.zeros_like(Mc[:, :1]), Mc[:, :-1]], dim=1)
    S_b = P[..., None] * S[:, None] + Mprev                 # (B,nb,H,N,N)

    # ---- inter contribution: y_t += (r_t e^{cl_t})^T S_b ----
    y_inter = torch.einsum("bnthd,bnhde->bnthe", rr, S_b)

    y = (y_intra + y_inter).reshape(B, L, H, N)
    S_out = Dc[:, -1][..., None] * S + Mc[:, -1]
    return y, S_out


def wkv6(r, k, v, lw, u, S, chunk: int):
    """Full-sequence WKV6. Shapes (B,T,H,N) f32; Python loop over chunks."""
    B, T, H, N = r.shape
    chunk = min(chunk, T)
    if T % chunk != 0 or chunk % SUB != 0:
        # a single chunk, padded to a multiple of SUB, as the reference
        # falls back for odd shapes
        pad = (-T) % SUB
        if pad:
            def z(a):
                return F.pad(a, (0, 0, 0, 0, 0, pad))
            y, S = _wkv_chunk(z(r), z(k), z(v), z(lw), u, S)
            return y[:, :T], S
        return _wkv_chunk(r, k, v, lw, u, S)
    ys = []
    for t0 in range(0, T, chunk):
        sl = slice(t0, t0 + chunk)
        y, S = _wkv_chunk(r[:, sl], k[:, sl], v[:, sl], lw[:, sl], u, S)
        ys.append(y)
    return torch.cat(ys, dim=1), S


# ---------------------------------------------------------------------------
# layer-level apply
# ---------------------------------------------------------------------------
def rwkv6_time_mix(p, x, cfg: ModelConfig, *, xprev=None, state=None):
    """x (B,T,C). Returns (y, (last_x, S_out)). xprev/state for decode."""
    B, T, C = x.shape
    n = cfg.rwkv_head_dim
    h = C // n
    dt = x.dtype
    if xprev is None:
        xprev = _shift(x)
    r, k, v, g, lw = _project(p, x, xprev, cfg)
    u = p["u"].to(torch.float32)

    def run(r, k, v, lw, u, S):
        if S is None:
            S = torch.zeros((r.shape[0], r.shape[2], n, n),
                            dtype=torch.float32, device=r.device)
        return wkv6(r, k, v, lw, u, S, cfg.scan_chunk)
    y, S_out = _on_heads(run, r, k, v, lw, u, state)
    y = merge_dims(y, 2).to(dt)
    y = group_norm(y, p["ln_x_scale"], p["ln_x_bias"], h)
    y = y * g
    y = lshard(y, "batch", "seq", "d_ff")
    out = linear(y, p["wo"].to(dt))
    return out, (x[:, -1], S_out)


def rwkv6_decode(p, x, prev_x, S, cfg: ModelConfig):
    """Single-token exact decode. x (B,1,C); prev_x (B,C); S (B,H,N,N)."""
    xprev = prev_x[:, None]
    r, k, v, g, lw = _project(p, x, xprev, cfg)   # (B,1,H,N)
    r1, k1, v1, lw1 = (z[:, 0] for z in (r, k, v, lw))
    u = p["u"].to(torch.float32)

    def step(r1, k1, v1, lw1, u, S):
        # y = r^T (S + diag(u) k v^T)
        y = torch.einsum("bhd,bhde->bhe", r1, S) + \
            torch.einsum("bhd,hd,bhd,bhe->bhe", r1, u, k1, v1)
        return y, torch.exp(lw1)[..., None] * S + \
            k1[..., None] * v1[..., None, :]
    y, S_out = _on_heads(step, r1, k1, v1, lw1, u, S)
    B, _, C = x.shape
    h = C // cfg.rwkv_head_dim
    y = merge_dims(y, 1)[:, None].to(x.dtype)
    y = group_norm(y, p["ln_x_scale"], p["ln_x_bias"], h)
    y = y * g
    out = linear(y, p["wo"].to(x.dtype))
    return out, (x[:, -1], S_out)


def rwkv6_channel_mix(p, x, cfg: ModelConfig, *, xprev=None):
    """Channel mix. Returns (y, last_x)."""
    dt = x.dtype
    if xprev is None:
        xprev = _shift(x)
    xx = xprev - x
    xk = x + xx * p["mu_k"].to(dt)
    xr = x + xx * p["mu_r"].to(dt)
    kk = F.relu(linear(xk, p["wk"].to(dt)))
    kk = kk * kk
    kk = lshard(kk, "batch", "seq", "d_ff")
    kv = linear(kk, p["wv"].to(dt))
    return sigmoid(linear(xr, p["wr"].to(dt))) * kv, x[:, -1]
