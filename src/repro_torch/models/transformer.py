"""Generic decoder over the attention families: dense, vlm, audio and moe.

The port of ``repro/models/transformer.py``. A model is a tiled repeating
``pattern`` of layers (see ModelConfig). The params of one pattern group
are stacked over ``n_groups``, as in the reference, and a Python loop over
the groups takes the place of its ``lax.scan`` (remat has no meaning
without a backward pass). Pattern remainders are unstacked trailing
layers. Params and caches are nested dicts of tensors in the reference's
layout, so ``models/convert.py`` carries its weights across unchanged.

Numerics are the reference's: the activations run in ``cfg.dtype`` (bf16
by default) over f32 master weights cast to it at use. ``cast_params``
makes those casts once, ahead of time: casting the same weights yields the
same bits, so a model given its output computes what it computes on the
master weights, without casting them again at every step. The weights the
reference reads in f32 (the norm scales, the MoE router, a codebook
model's embeddings, which it sums before the cast) stay f32.

Attention runs through ``attend`` (``repro_torch.kernels.ops.
flash_attention``, or its plain version: ``models/registry.py``). The
RWKV-6 and RG-LRU blocks, and ``forward_backbone``, ``fused_head_loss``
and ``loss_fn`` (training), wait for later slices.
"""
from __future__ import annotations

import functools
from collections import namedtuple
from typing import Callable

import torch

from repro_torch.configs.base import (ATTN_GLOBAL, ATTN_LOCAL, RGLRU, RWKV6,
                                      ModelConfig)
from repro_torch.kernels.ops import flash_attention
from repro_torch.models import attention as attn
from repro_torch.models import moe
from repro_torch.models.layers import (Spec, init_tree, mlp_apply, mlp_specs,
                                       names_tree, rms_norm, rope_angles,
                                       softcap, stack_specs, tree_map)
from repro_torch.sharding import lshard

RECURRENT_SLICE = "RWKV-6 and RG-LRU blocks wait for the next slice"

# a cache leaf's shape and dtype (the reference's ShapeDtypeStruct)
TensorSpec = namedtuple("TensorSpec", "shape dtype")


def _is_local(kind: str) -> bool:
    """Whether an attention layer is a local (sliding-window) one; raises
    for the recurrent kinds."""
    if kind in (RWKV6, RGLRU):
        raise NotImplementedError(RECURRENT_SLICE)
    if kind not in (ATTN_GLOBAL, ATTN_LOCAL):
        raise ValueError(kind)
    return kind == ATTN_LOCAL


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------
def layer_specs(cfg: ModelConfig, kind: str) -> dict:
    _is_local(kind)                     # raises for the recurrent kinds
    d = cfg.d_model
    s: dict = {"mixer_norm": Spec((d,), ("d_model",), "zeros"),
               "ffn_norm": Spec((d,), ("d_model",), "zeros")}
    if cfg.post_norms:
        s["mixer_post_norm"] = Spec((d,), ("d_model",), "zeros")
        s["ffn_post_norm"] = Spec((d,), ("d_model",), "zeros")
    s["mixer"] = attn.attn_specs(cfg)
    s["ffn"] = moe.moe_specs(cfg) if cfg.family == "moe" else mlp_specs(cfg)
    return s


def _rem_kinds(cfg: ModelConfig) -> list:
    return cfg.layer_kinds[cfg.n_groups * len(cfg.pattern):]


def model_specs(cfg: ModelConfig) -> dict:
    d, v = cfg.d_model, cfg.vocab_size
    emb_shape = (cfg.n_codebooks, v, d) if cfg.n_codebooks else (v, d)
    emb_names = (("codebooks", "vocab", "d_model") if cfg.n_codebooks
                 else ("vocab", "d_model"))
    specs: dict = {
        "embed": Spec(emb_shape, emb_names, scale=0.02),
        "final_norm": Spec((d,), ("d_model",), "zeros"),
    }
    if not cfg.tie_embeddings:
        head_shape = (cfg.n_codebooks, d, v) if cfg.n_codebooks else (d, v)
        head_names = (("codebooks", "d_model", "vocab") if cfg.n_codebooks
                      else ("d_model", "vocab"))
        specs["head"] = Spec(head_shape, head_names, scale=0.02)
    group = {f"l{i}": layer_specs(cfg, k) for i, k in enumerate(cfg.pattern)}
    if cfg.n_groups > 0:
        specs["scan"] = stack_specs(group, cfg.n_groups)
    rem_kinds = _rem_kinds(cfg)
    if rem_kinds:
        specs["rem"] = {f"l{j}": layer_specs(cfg, k)
                        for j, k in enumerate(rem_kinds)}
    return specs


def _group(tree, g: int):
    """Group ``g``'s slice of a stacked tree: views, so a write into a
    cache slice is a write into the stacked cache."""
    return tree_map(lambda a: a[g], tree)


# ---------------------------------------------------------------------------
# Layer application (full-sequence path)
# ---------------------------------------------------------------------------
def _apply_layer(p, x, kind: str, cfg: ModelConfig, ctx: dict):
    """Residual layer. Returns (x, aux, cache_out)."""
    local = _is_local(kind)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = rms_norm(x, p["mixer_norm"], cfg.norm_eps, cfg.norm_upcast)
    cache = None
    y, (k, v) = attn.attention_full(p["mixer"], h, cfg, ctx["sin"],
                                    ctx["cos"], local=local,
                                    attend=ctx["attend"])
    if ctx.get("want_cache"):
        L = attn.cache_len(cfg, x.shape[1], local=local)
        cache = {"k": attn.quantize_kv(cfg, k[:, -L:]),
                 "v": attn.quantize_kv(cfg, v[:, -L:])}
    if cfg.post_norms:
        y = rms_norm(y, p["mixer_post_norm"], cfg.norm_eps, cfg.norm_upcast)
    x = x + y
    x = lshard(x, "batch", "seq", "d_model")

    h = rms_norm(x, p["ffn_norm"], cfg.norm_eps, cfg.norm_upcast)
    if cfg.family == "moe":
        y, aux = moe.moe_apply(p["ffn"], h, cfg)
    else:
        y = mlp_apply(p["ffn"], h, cfg)
    if cfg.post_norms:
        y = rms_norm(y, p["ffn_post_norm"], cfg.norm_eps, cfg.norm_upcast)
    x = x + y
    x = lshard(x, "batch", "seq", "d_model")
    return x, aux, cache


def _apply_group(gp, x, cfg: ModelConfig, ctx: dict):
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    caches = {}
    for i, kind in enumerate(cfg.pattern):
        x, a, c = _apply_layer(gp[f"l{i}"], x, kind, cfg, ctx)
        aux = aux + a
        if ctx.get("want_cache"):
            caches[f"l{i}"] = c
    return x, aux, caches


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------
def embed(params, batch, cfg: ModelConfig):
    dt = getattr(torch, cfg.dtype)
    if "embeds" in batch:                      # vlm stub frontend
        x = batch["embeds"].to(dt)
    else:
        tok = batch["tokens"].long()
        w = params["embed"]
        if cfg.n_codebooks:                    # (B,K,S) -> sum_k E_k[tok_k]
            xs = [w[k][tok[:, k]] for k in range(cfg.n_codebooks)]
            x = functools.reduce(torch.add, xs).to(dt)
        else:
            x = w[tok].to(dt)
    if cfg.emb_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=dt)
    return lshard(x, "batch", "seq", "d_model")


def lm_head(params, x, cfg: ModelConfig):
    if cfg.tie_embeddings:
        logits = torch.matmul(x, params["embed"].to(x.dtype).t())
    elif cfg.n_codebooks:
        logits = torch.einsum("bsd,kdv->bskv", x, params["head"].to(x.dtype))
    else:
        logits = torch.matmul(x, params["head"].to(x.dtype))
    return lshard(logits, "batch", "seq", None, "vocab") \
        if cfg.n_codebooks else lshard(logits, "batch", "seq", "vocab")


def _make_ctx(cfg: ModelConfig, batch, B: int, S: int, *, device,
              want_cache=False, attend: Callable = flash_attention):
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=device).expand(B, S)
    sin, cos = rope_angles(positions, cfg.head_dim, cfg.rope_theta,
                           cfg.mrope_sections)
    return {"sin": sin, "cos": cos, "want_cache": want_cache,
            "attend": attend}


# ---------------------------------------------------------------------------
# Full-sequence forward (train / prefill)
# ---------------------------------------------------------------------------
def forward(params, batch, cfg: ModelConfig, *, want_cache: bool = False,
            last_only: bool = False, attend: Callable = flash_attention):
    """Returns (logits, aux, caches). ``last_only``: the final norm and the
    head at the last position only, logits (B, 1, ...): the rows a prefill
    step keeps (each position is normed and projected on its own)."""
    x = embed(params, batch, cfg)
    B, S, _ = x.shape
    ctx = _make_ctx(cfg, batch, B, S, device=x.device, want_cache=want_cache,
                    attend=attend)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    caches: dict = {}
    if "scan" in params:
        group_caches = []
        for g in range(cfg.n_groups):
            x, a, c = _apply_group(_group(params["scan"], g), x, cfg, ctx)
            aux_total = aux_total + a
            group_caches.append(c)
        if want_cache:
            caches["scan"] = tree_map(lambda *cs: torch.stack(cs),
                                      *group_caches)
    if "rem" in params:
        rem_caches = {}
        for j, kind in enumerate(_rem_kinds(cfg)):
            x, a, c = _apply_layer(params["rem"][f"l{j}"], x, kind, cfg, ctx)
            aux_total = aux_total + a
            rem_caches[f"l{j}"] = c
        if want_cache:
            caches["rem"] = rem_caches
    if last_only:
        x = x[:, -1:]
    x = rms_norm(x, params["final_norm"], cfg.norm_eps, cfg.norm_upcast)
    logits = lm_head(params, x, cfg)
    return logits, aux_total, (caches if want_cache else None)


# ---------------------------------------------------------------------------
# Decode (single token against caches)
# ---------------------------------------------------------------------------
def _decode_layer(p, x, kind: str, cfg: ModelConfig, cache, ctx):
    local = _is_local(kind)
    h = rms_norm(x, p["mixer_norm"], cfg.norm_eps, cfg.norm_upcast)
    y, new_cache = attn.attention_decode(
        p["mixer"], h, cache, ctx["pos"], cfg, ctx["sin"], ctx["cos"],
        local=local, attend=ctx["attend"])
    if cfg.post_norms:
        y = rms_norm(y, p["mixer_post_norm"], cfg.norm_eps, cfg.norm_upcast)
    x = x + y

    h = rms_norm(x, p["ffn_norm"], cfg.norm_eps, cfg.norm_upcast)
    if cfg.family == "moe":
        y, _ = moe.moe_apply(p["ffn"], h, cfg)
    else:
        y = mlp_apply(p["ffn"], h, cfg)
    if cfg.post_norms:
        y = rms_norm(y, p["ffn_post_norm"], cfg.norm_eps, cfg.norm_upcast)
    return x + y, new_cache


def decode_step(params, batch, caches, pos: int, cfg: ModelConfig, *,
                attend: Callable = flash_attention):
    """One-token decode. batch: {"tokens": (B,1)[,(B,K,1)]} or {"embeds"}.

    pos: the current absolute position, a Python int. The caches are
    updated in place (``attention_decode``); returns (logits, caches)."""
    x = embed(params, batch, cfg)
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    if cfg.mrope_sections is not None:
        positions = positions.expand(3, B, 1)
    ctx = _make_ctx(cfg, {"positions": positions}, B, 1, device=x.device,
                    attend=attend)
    ctx["pos"] = int(pos)
    if "scan" in params:
        for g in range(cfg.n_groups):
            gp, gc = _group(params["scan"], g), _group(caches["scan"], g)
            for i, kind in enumerate(cfg.pattern):
                x, _ = _decode_layer(gp[f"l{i}"], x, kind, cfg, gc[f"l{i}"],
                                     ctx)
    if "rem" in params:
        for j, kind in enumerate(_rem_kinds(cfg)):
            x, _ = _decode_layer(params["rem"][f"l{j}"], x, kind, cfg,
                                 caches["rem"][f"l{j}"], ctx)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps, cfg.norm_upcast)
    logits = lm_head(params, x, cfg)
    logits = softcap(logits, cfg.final_logit_softcap)
    return logits, caches


# ---------------------------------------------------------------------------
# Cache initialization (steady-state decode at a given context length)
# ---------------------------------------------------------------------------
def _layer_cache_spec(cfg: ModelConfig, kind: str, B: int, S: int) -> dict:
    L = attn.cache_len(cfg, S, local=_is_local(kind))
    shp = (B, L, cfg.n_kv_heads, cfg.head_dim)
    kv_dt = attn.kv_cache_dtype(cfg)
    return {"k": TensorSpec(shp, kv_dt), "v": TensorSpec(shp, kv_dt)}


def cache_specs(cfg: ModelConfig, batch: int, seq_len: int) -> dict:
    """Cache tree of ``TensorSpec``s for decode at context seq_len."""
    out: dict = {}
    if cfg.n_groups > 0:
        group = {f"l{i}": _layer_cache_spec(cfg, k, batch, seq_len)
                 for i, k in enumerate(cfg.pattern)}
        out["scan"] = tree_map(
            lambda s: TensorSpec((cfg.n_groups,) + s.shape, s.dtype), group)
    rem_kinds = _rem_kinds(cfg)
    if rem_kinds:
        out["rem"] = {f"l{j}": _layer_cache_spec(cfg, k, batch, seq_len)
                      for j, k in enumerate(rem_kinds)}
    return out


def init_caches(cfg: ModelConfig, batch: int, seq_len: int, device):
    return tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                          device=device),
                    cache_specs(cfg, batch, seq_len))


# ---------------------------------------------------------------------------
# Init and the casts at load
# ---------------------------------------------------------------------------
def init_params(cfg: ModelConfig, generator: torch.Generator, device):
    return init_tree(model_specs(cfg), generator,
                     getattr(torch, cfg.param_dtype), device)


def param_logical_names(cfg: ModelConfig):
    return names_tree(model_specs(cfg))


def _read_in_f32(path: tuple, cfg: ModelConfig) -> bool:
    """Whether the reference reads the weight at ``path`` (its keys) in
    f32, not cast to the activation dtype."""
    leaf = path[-1]
    return leaf.endswith("norm") or leaf == "router" or (
        leaf == "embed" and bool(cfg.n_codebooks))


def cast_params(params, cfg: ModelConfig):
    """``params`` with every weight the layers cast to ``cfg.dtype`` at use
    cast once, the rest as they are (see the module docstring)."""
    dt = getattr(torch, cfg.dtype)

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        return tree if _read_in_f32(path, cfg) else tree.to(dt)
    return walk(params, ())
