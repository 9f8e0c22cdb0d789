"""GQA attention: the train/prefill path and the decode path, on the port's
attention kernels.

The port of ``repro/models/attention.py``. The module's functions keep the
reference's layout, (B, S, H, head_dim); the attention itself is one call
of ``attend`` (``repro_torch.kernels.ops.flash_attention`` by default, or
its plain version ``flash_attention_plain``), which takes (B, H, S, D): q,
k and v are transposed to it, contiguous, at the call and back after.

- GQA goes to the kernel as it is: q-head ``h`` reads kv-head
  ``h // (H // KV)``, so K and V are never repeated per q-head; only under
  logical rules whose mesh shards q's heads but cannot shard the KV heads
  alike are they repeated (``_repeat_kv_for_mesh``), as the reference
  always repeats them.
- Prefill is one call with ``causal=True`` and, on local layers,
  ``window=sliding_window``. The kernel's mask (``kpos <= qpos``, ``kpos >
  qpos - window``) is the reference's, so the reference's q-chunk loop,
  which exists to bound the TPU's memory and to keep XLA's cost analysis
  honest, has no counterpart.
- Decode keeps the reference's ring buffer: the new K/V go to slot ``pos %
  L`` of the cache, written in place (the reference returns a new cache;
  its session donates the old one), and the kernel attends, without a
  mask, over the first ``min(pos + 1, L)`` slots. Attention does not
  depend on the order of its keys.
- Logit softcap (gemma2) and the query scale go to the kernel as its
  ``softcap`` and ``scale``.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ops import flash_attention
from repro_torch.models.layers import Spec, apply_rope, rms_norm
from repro_torch.sharding import get_rules, lshard
from repro_torch.sharding.logical import linear, merge_dims, split_dim


def attn_specs(cfg: ModelConfig) -> dict:
    d, hd = cfg.d_model, cfg.head_dim
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    s = {
        "wq": Spec((d, nq, hd), ("d_model", "heads", "head_dim")),
        "wk": Spec((d, nkv, hd), ("d_model", "kv_heads", "head_dim")),
        "wv": Spec((d, nkv, hd), ("d_model", "kv_heads", "head_dim")),
        "wo": Spec((nq, hd, d), ("heads", "head_dim", "d_model")),
    }
    if cfg.qkv_bias:
        s["bq"] = Spec((nq, hd), ("heads", "head_dim"), "zeros")
        s["bk"] = Spec((nkv, hd), ("kv_heads", "head_dim"), "zeros")
        s["bv"] = Spec((nkv, hd), ("kv_heads", "head_dim"), "zeros")
    if cfg.qk_norm:
        s["q_norm"] = Spec((hd,), ("head_dim",), "zeros")
        s["k_norm"] = Spec((hd,), ("head_dim",), "zeros")
    return s


def _heads(x, w):
    """x (B, S, d) @ w (d, H, hd) -> (B, S, H, hd)."""
    d, h, hd = w.shape
    return split_dim(linear(x, merge_dims(w.to(x.dtype), 1)), -1, (h, hd))


def _project_qkv(p, x, cfg: ModelConfig, sin, cos):
    dt = x.dtype
    q, k, v = _heads(x, p["wq"]), _heads(x, p["wk"]), _heads(x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if sin is not None:
        q = apply_rope(q, sin, cos)
        k = apply_rope(k, sin, cos)
    q = lshard(q, "batch", "seq", "heads", "head_dim")
    k = lshard(k, "batch", "seq", "kv_heads", "head_dim")
    v = lshard(v, "batch", "seq", "kv_heads", "head_dim")
    return q, k, v


def _scale(cfg: ModelConfig) -> float:
    return cfg.query_scale if cfg.query_scale is not None \
        else cfg.head_dim ** -0.5


def _attend(attend: Callable, q, k, v, **kw):
    """``attend`` on q (B, Sq, H, hd) against k, v (B, Sk, KV, hd), each
    transposed to the kernel's (B, heads, S, hd), contiguous; the output
    back in (B, Sq, H, hd)."""
    out = attend(*(t.transpose(1, 2).contiguous() for t in (q, k, v)), **kw)
    return out.transpose(1, 2)


def _out_proj(p, out, dt):
    """out (B, S, H, hd) @ wo (H, hd, d) -> (B, S, d)."""
    return linear(merge_dims(out, 2), merge_dims(p["wo"].to(dt), 0))


def _repeat_kv_for_mesh(cfg: ModelConfig, q, k, v) -> tuple:
    """k and v for the attention call: as they are, or, under logical rules
    that shard q's heads over an axis that does not divide the KV heads,
    repeated to the q heads (``cfg.repeat_kv``, the reference's expansion,
    head ``h`` taking kv head ``h // group``), so that each rank attends
    its own heads. The values are the same either way; the caches keep
    the compact k and v."""
    r = get_rules()
    h, kv = q.shape[2], k.shape[2]
    if r is None or not cfg.repeat_kv or kv == h:
        return k, v
    qs = r.spec(("batch", "seq", "heads", "head_dim"), q.shape, is_act=True)
    ks = r.spec(("batch", "seq", "kv_heads", "head_dim"), k.shape,
                is_act=True)
    if qs[2] is None or ks[2] == qs[2]:
        return k, v
    names = ("batch", "seq", "heads", "head_dim")
    # t[:, :, g] to heads g * rep ... g * rep + rep - 1, as
    # repeat_interleave; a merge, whose gradient is a split that takes
    # heads sharded unevenly for the KV heads (repeat_interleave's is a view
    # DTensor refuses there)
    return tuple(lshard(merge_dims(t[:, :, :, None].expand(
        -1, -1, -1, h // kv, -1), 2), *names) for t in (k, v))


def attention_full(p, x, cfg: ModelConfig, sin, cos, *, local: bool,
                   attend: Callable = flash_attention):
    """Train / prefill attention over the full sequence, one ``attend``
    call. Returns (y, (k, v)), k and v in (B, S, KV, hd)."""
    q, k, v = _project_qkv(p, x, cfg, sin, cos)
    ka, va = _repeat_kv_for_mesh(cfg, q, k, v)
    out = _attend(attend, q, ka, va, causal=True,
                  window=cfg.sliding_window if local else None,
                  softcap=cfg.attn_logit_softcap, scale=_scale(cfg))
    out = lshard(out, "batch", "seq", "heads", "head_dim")
    return _out_proj(p, out, x.dtype), (k, v)


def cache_len(cfg: ModelConfig, seq_len: int, *, local: bool) -> int:
    """KV cache length: sliding-window layers only keep `window` entries."""
    if local and cfg.sliding_window is not None:
        return min(seq_len, cfg.sliding_window)
    return seq_len


# --- quantized KV cache (beyond-paper; halves decode cache bytes) ---------
KV_QSCALE = 16.0     # symmetric fixed-scale int8: q = round(x * 127/16)


def kv_cache_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.int8 if cfg.kv_cache_dtype == "int8" \
        else getattr(torch, cfg.dtype)


def quantize_kv(cfg: ModelConfig, x):
    if cfg.kv_cache_dtype != "int8":
        return x
    scaled = torch.clamp(x.to(torch.float32) * (127.0 / KV_QSCALE), -127, 127)
    return torch.round(scaled).to(torch.int8)


def dequantize_kv(cfg: ModelConfig, x, dtype):
    if cfg.kv_cache_dtype != "int8":
        return x
    return (x.to(torch.float32) * (KV_QSCALE / 127.0)).to(dtype)


def init_kv_cache(cfg: ModelConfig, batch: int, seq_len: int, *, local: bool,
                  dtype, device) -> dict:
    L = cache_len(cfg, seq_len, local=local)
    shp = (batch, L, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shp, dtype=dtype, device=device),
            "v": torch.zeros(shp, dtype=dtype, device=device)}


def write_slot(buf, slot: int, x) -> None:
    """``buf[:, slot:slot + 1] = x``, in place. For a DTensor ``buf``, each
    rank writes into its own shard, where the slot falls in it: DTensor's
    slice of a dim sharded over the mesh (``kv_seq``) is a gathered copy,
    so the write would be lost."""
    if not isinstance(buf, DTensor):
        buf[:, slot:slot + 1] = x
        return
    mesh = buf.device_mesh
    x = x.redistribute(mesh, [Replicate() if p.is_shard(1) else p
                              for p in buf.placements])
    shape, offset = compute_local_shape_and_global_offset(
        buf.shape, mesh, buf.placements)
    lo = slot - offset[1]
    if 0 <= lo < shape[1]:
        buf.to_local()[:, lo:lo + 1] = x.to_local()


def attention_decode(p, x, cache: dict, pos: int, cfg: ModelConfig,
                     sin, cos, *, local: bool,
                     attend: Callable = flash_attention):
    """One-token decode: x (B,1,d); cache {"k","v"} (B,L,KV,hd); pos the
    current absolute position (a Python int).

    As in the reference, the new K/V overwrite the slot at ``pos % L`` (a
    ring buffer) and the first ``min(pos + 1, L)`` slots are attended to:
    at steady state (pos >= L) every slot. The cache is written in place
    and returned.
    """
    q, k, v = _project_qkv(p, x, cfg, sin, cos)
    L = cache["k"].shape[1]
    slot = pos % L
    write_slot(cache["k"], slot, quantize_kv(cfg, k))
    write_slot(cache["v"], slot, quantize_kv(cfg, v))
    valid = min(pos + 1, L)
    out = _attend(attend, q,
                  dequantize_kv(cfg, cache["k"][:, :valid], q.dtype),
                  dequantize_kv(cfg, cache["v"][:, :valid], q.dtype),
                  causal=False, window=None,
                  softcap=cfg.attn_logit_softcap, scale=_scale(cfg))
    return _out_proj(p, out, x.dtype), cache
