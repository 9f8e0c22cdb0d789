"""Generic decoder composing all assigned families.

The port of ``repro/models/transformer.py``. A model is a tiled repeating
``pattern`` of layers (see ModelConfig). The params of one pattern group
are stacked over ``n_groups``, as in the reference, and a Python loop over
the groups takes the place of its ``lax.scan``. Pattern remainders are
unstacked trailing layers. Params and caches are nested dicts of tensors
in the reference's layout, so ``models/convert.py`` carries its weights
across unchanged.

Numerics are the reference's: the activations run in ``cfg.dtype`` (bf16
by default) over f32 master weights cast to it at use. ``cast_params``
makes those casts once, ahead of time: casting the same weights yields the
same bits, so a model given its output computes what it computes on the
master weights, without casting them again at every step. The weights the
reference reads in f32 (the norm scales, the MoE router, a codebook
model's embeddings, which it sums before the cast, RWKV-6's decay weights,
bonus and group-norm affine, and the RG-LRU's gates and Lambda) stay f32.

Attention runs through ``attend`` (``repro_torch.kernels.ops.
flash_attention``, or its plain version: ``models/registry.py``). The
RWKV-6 and RG-LRU blocks (``models/rwkv6.py``, ``models/griffin.py``) run
in PyTorch: their scans have no kernel in the reference either.

Training: ``loss_fn`` is ``forward_backbone`` (each pattern group under
``_remat``'s checkpoint) then ``fused_head_loss``, which projects and
scores the sequence a chunk at a time, each chunk checkpointed, so that
the (tokens, vocab) logits never exist whole. The gradient of every
attention layer is the attention op's backward; a group's recompute
launches its attention kernels again. The reference's ``_sched_barrier``
only orders its attention's q-chunks in the forward and passes the
gradient through; the port's attention is one call and needs none.
"""
from __future__ import annotations

import functools
import math
from collections import namedtuple
from typing import Callable

import torch
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import (ATTN_GLOBAL, ATTN_LOCAL, RGLRU, RWKV6,
                                      ModelConfig)
from repro_torch.kernels.ops import flash_attention
from repro_torch.models import attention as attn
from repro_torch.models import griffin, moe, rwkv6
from repro_torch.models.layers import (Spec, cross_entropy, embed_lookup,
                                       init_tree, mlp_apply, mlp_specs,
                                       names_tree, rms_norm, rope_angles,
                                       softcap, stack_specs, tree_map)
from repro_torch.sharding import lshard
from repro_torch.sharding.logical import linear, merge_dims, split_dim

# a cache leaf's shape and dtype (the reference's ShapeDtypeStruct)
TensorSpec = namedtuple("TensorSpec", "shape dtype")
RECURRENT = (RWKV6, RGLRU)


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------
def layer_specs(cfg: ModelConfig, kind: str) -> dict:
    d = cfg.d_model
    s: dict = {"mixer_norm": Spec((d,), ("d_model",), "zeros"),
               "ffn_norm": Spec((d,), ("d_model",), "zeros")}
    if cfg.post_norms:
        s["mixer_post_norm"] = Spec((d,), ("d_model",), "zeros")
        s["ffn_post_norm"] = Spec((d,), ("d_model",), "zeros")
    if kind in (ATTN_GLOBAL, ATTN_LOCAL):
        s["mixer"] = attn.attn_specs(cfg)
    elif kind == RWKV6:
        s["mixer"] = rwkv6.rwkv6_specs(cfg)
    elif kind == RGLRU:
        s["mixer"] = griffin.rglru_specs(cfg)
    if kind == RWKV6:
        s["ffn"] = rwkv6.rwkv6_cm_specs(cfg)
    elif cfg.family == "moe":
        s["ffn"] = moe.moe_specs(cfg)
    else:
        s["ffn"] = mlp_specs(cfg)
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
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = rms_norm(x, p["mixer_norm"], cfg.norm_eps, cfg.norm_upcast)
    cache = None
    if kind in (ATTN_GLOBAL, ATTN_LOCAL):
        local = kind == ATTN_LOCAL
        y, (k, v) = attn.attention_full(p["mixer"], h, cfg, ctx["sin"],
                                        ctx["cos"], local=local,
                                        attend=ctx["attend"])
        if ctx.get("want_cache"):
            L = attn.cache_len(cfg, x.shape[1], local=local)
            cache = {"k": attn.quantize_kv(cfg, k[:, -L:]),
                     "v": attn.quantize_kv(cfg, v[:, -L:])}
    elif kind == RWKV6:
        y, (tm_x, tm_S) = rwkv6.rwkv6_time_mix(p["mixer"], h, cfg)
        cache = {"tm_x": tm_x, "tm_S": tm_S}
    elif kind == RGLRU:
        y, (conv, hlast) = griffin.rglru_block(p["mixer"], h, cfg)
        cache = {"conv": conv, "h": hlast}
    else:
        raise ValueError(kind)
    if cfg.post_norms:
        y = rms_norm(y, p["mixer_post_norm"], cfg.norm_eps, cfg.norm_upcast)
    x = x + y
    x = lshard(x, "batch", "seq", "d_model")

    h = rms_norm(x, p["ffn_norm"], cfg.norm_eps, cfg.norm_upcast)
    if kind == RWKV6:
        y, cm_x = rwkv6.rwkv6_channel_mix(p["ffn"], h, cfg)
        cache["cm_x"] = cm_x
    elif cfg.family == "moe":
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
            xs = [embed_lookup(w[k], tok[:, k])
                  for k in range(cfg.n_codebooks)]
            x = functools.reduce(torch.add, xs).to(dt)
        else:
            x = embed_lookup(w, tok).to(dt)
    if cfg.emb_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=dt)
    return lshard(x, "batch", "seq", "d_model")


def lm_head(params, x, cfg: ModelConfig):
    if cfg.tie_embeddings:
        logits = linear(x, params["embed"].to(x.dtype).t())
    elif cfg.n_codebooks and isinstance(x, DTensor):
        # the einsum's own reshapes merge a sharded sequence, which DTensor
        # refuses: the same product by linear, (d, K * V) split to (K, V)
        head = params["head"].to(x.dtype)
        logits = split_dim(linear(x, merge_dims(head.permute(1, 0, 2), 1)),
                           -1, tuple(head.shape[::2]))
    elif cfg.n_codebooks:
        logits = torch.einsum("bsd,kdv->bskv", x, params["head"].to(x.dtype))
    else:
        logits = linear(x, params["head"].to(x.dtype))
    return lshard(logits, "batch", "seq", None, "vocab") \
        if cfg.n_codebooks else lshard(logits, "batch", "seq", "vocab")


def _make_ctx(cfg: ModelConfig, batch, B: int, S: int, *, device,
              want_cache=False, attend: Callable = flash_attention):
    if cfg.attention_free and ATTN_GLOBAL not in cfg.pattern \
            and ATTN_LOCAL not in cfg.pattern:
        return {"sin": None, "cos": None, "want_cache": want_cache,
                "attend": attend}
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


def _save_dots(ctx, op, *args, **kwargs):
    """The selective checkpoint's policy for ``remat_policy="dots"``: keep
    the outputs of matrix products without batch dims (``aten.mm``, what
    a (B, S, d) @ (d, f) product runs as), recompute the rest, as
    ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``."""
    return CheckpointPolicy.MUST_SAVE if op is torch.ops.aten.mm.default \
        else CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn: Callable, cfg: ModelConfig) -> Callable:
    """``fn`` checkpointed as the reference's ``_remat``: nothing for
    ``cfg.remat`` false or ``remat_policy="none"``; the matrix products'
    outputs kept and the rest recomputed for ``"dots"``; everything
    recomputed in the backward otherwise (``"full"``)."""
    if not cfg.remat or cfg.remat_policy == "none":
        return fn
    kw = {}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)
    return lambda *args: checkpoint(fn, *args, use_reentrant=False, **kw)


def forward_backbone(params, batch, cfg: ModelConfig, *,
                     attend: Callable = flash_attention):
    """Forward through embed + blocks + final norm; no LM head. Returns
    (x, aux). Each pattern group runs under ``_remat``, the trailing
    layers as they are, as in the reference."""
    x = embed(params, batch, cfg)
    B, S, _ = x.shape
    ctx = _make_ctx(cfg, batch, B, S, device=x.device, attend=attend)
    body = _remat(lambda x, gp: _apply_group(gp, x, cfg, ctx)[:2], cfg)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    if "scan" in params:
        for g in range(cfg.n_groups):
            x, a = body(x, _group(params["scan"], g))
            aux_total = aux_total + a
    if "rem" in params:
        for j, kind in enumerate(_rem_kinds(cfg)):
            x, a, _ = _apply_layer(params["rem"][f"l{j}"], x, kind, cfg, ctx)
            aux_total = aux_total + a
    x = rms_norm(x, params["final_norm"], cfg.norm_eps, cfg.norm_upcast)
    return x, aux_total


def fused_head_loss(params, x, labels, cfg: ModelConfig,
                    n_chunks: int = 0):
    """Mean cross-entropy of the LM head over ``x`` (B, S, d), a sequence
    chunk at a time: ``n_chunks`` (``cfg.loss_chunks`` by default, cut
    until it divides S) chunks, each projected and scored under a
    checkpoint, so that a chunk's logits live only while it is computed,
    in the forward and again in the backward."""
    B, S, _ = x.shape
    n_chunks = min(n_chunks or cfg.loss_chunks, S)
    while S % n_chunks:
        n_chunks -= 1
    c = S // n_chunks

    def chunk_loss(xc, lc):
        logits = lm_head(params, xc, cfg)
        # cross_entropy means over every label position; rescale to a sum
        return cross_entropy(logits, lc, cfg.final_logit_softcap) \
            * lc.numel()

    total = torch.zeros((), dtype=torch.float32, device=x.device)
    count = 0
    for s0 in range(0, S, c):
        lc = labels[:, s0:s0 + c]
        total = total + checkpoint(chunk_loss, x[:, s0:s0 + c], lc,
                                   use_reentrant=False)
        count += lc.numel()
    return total / count


def loss_fn(params, batch, cfg: ModelConfig, aux_weight: float = 0.01, *,
            attend: Callable = flash_attention):
    """(loss, {"xent", "moe_aux"}): the head's cross-entropy plus
    ``aux_weight`` times the MoE balance loss averaged over the layers."""
    x, aux = forward_backbone(params, batch, cfg, attend=attend)
    loss = fused_head_loss(params, x, batch["labels"], cfg)
    n_aux_layers = len(cfg.layer_kinds) or 1
    return loss + aux_weight * aux / n_aux_layers, \
        {"xent": loss, "moe_aux": aux}


# ---------------------------------------------------------------------------
# Decode (single token against caches)
# ---------------------------------------------------------------------------
def _decode_layer(p, x, kind: str, cfg: ModelConfig, cache, ctx):
    """One layer's decode step. Returns (x, cache): an attention layer's
    cache written in place, a recurrent layer's new states in a new dict
    (RG-LRU's ``h`` turns f32 here from the prefill's activation dtype, as
    in the reference)."""
    h = rms_norm(x, p["mixer_norm"], cfg.norm_eps, cfg.norm_upcast)
    if kind in (ATTN_GLOBAL, ATTN_LOCAL):
        y, new_cache = attn.attention_decode(
            p["mixer"], h, cache, ctx["pos"], cfg, ctx["sin"], ctx["cos"],
            local=(kind == ATTN_LOCAL), attend=ctx["attend"])
    elif kind == RWKV6:
        y, (tm_x, tm_S) = rwkv6.rwkv6_decode(p["mixer"], h, cache["tm_x"],
                                             cache["tm_S"], cfg)
        new_cache = {"tm_x": tm_x, "tm_S": tm_S, "cm_x": cache["cm_x"]}
    elif kind == RGLRU:
        y, (conv, hh) = griffin.rglru_decode(p["mixer"], h, cache["conv"],
                                             cache["h"], cfg)
        new_cache = {"conv": conv, "h": hh}
    else:
        raise ValueError(kind)
    if cfg.post_norms:
        y = rms_norm(y, p["mixer_post_norm"], cfg.norm_eps, cfg.norm_upcast)
    x = x + y

    h = rms_norm(x, p["ffn_norm"], cfg.norm_eps, cfg.norm_upcast)
    if kind == RWKV6:
        y, cm_x = rwkv6.rwkv6_channel_mix(p["ffn"], h, cfg,
                                          xprev=cache["cm_x"][:, None])
        new_cache["cm_x"] = cm_x
    elif cfg.family == "moe":
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
    updated in place: attention writes its slot (``attention_decode``),
    and each recurrent layer's new states replace its entries in
    ``caches`` (stacked again over the groups). Returns (logits, caches)."""
    x = embed(params, batch, cfg)
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    if cfg.mrope_sections is not None:
        positions = positions.expand(3, B, 1)
    ctx = _make_ctx(cfg, {"positions": positions}, B, 1, device=x.device,
                    attend=attend)
    ctx["pos"] = int(pos)
    if "scan" in params:
        states = {f"l{i}": [] for i, kind in enumerate(cfg.pattern)
                  if kind in RECURRENT}
        for g in range(cfg.n_groups):
            gp, gc = _group(params["scan"], g), _group(caches["scan"], g)
            for i, kind in enumerate(cfg.pattern):
                x, nc = _decode_layer(gp[f"l{i}"], x, kind, cfg, gc[f"l{i}"],
                                      ctx)
                if kind in RECURRENT:
                    states[f"l{i}"].append(nc)
        for key, per_group in states.items():
            caches["scan"][key] = tree_map(lambda *t: torch.stack(t),
                                           *per_group)
    if "rem" in params:
        for j, kind in enumerate(_rem_kinds(cfg)):
            x, caches["rem"][f"l{j}"] = _decode_layer(
                params["rem"][f"l{j}"], x, kind, cfg, caches["rem"][f"l{j}"],
                ctx)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps, cfg.norm_upcast)
    logits = lm_head(params, x, cfg)
    logits = softcap(logits, cfg.final_logit_softcap)
    return logits, caches


# ---------------------------------------------------------------------------
# Cache initialization (steady-state decode at a given context length)
# ---------------------------------------------------------------------------
def _layer_cache_spec(cfg: ModelConfig, kind: str, B: int, S: int) -> dict:
    dt = getattr(torch, cfg.dtype)
    if kind in (ATTN_GLOBAL, ATTN_LOCAL):
        L = attn.cache_len(cfg, S, local=(kind == ATTN_LOCAL))
        shp = (B, L, cfg.n_kv_heads, cfg.head_dim)
        kv_dt = attn.kv_cache_dtype(cfg)
        return {"k": TensorSpec(shp, kv_dt), "v": TensorSpec(shp, kv_dt)}
    if kind == RWKV6:
        C, n = cfg.d_model, cfg.rwkv_head_dim
        return {"tm_x": TensorSpec((B, C), dt),
                "tm_S": TensorSpec((B, C // n, n, n), torch.float32),
                "cm_x": TensorSpec((B, C), dt)}
    if kind == RGLRU:
        w = cfg.lru_width or cfg.d_model
        return {"conv": TensorSpec((B, cfg.conv1d_width - 1, w), dt),
                "h": TensorSpec((B, w), torch.float32)}
    raise ValueError(kind)


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


# a stacked leaf whose f32 draw is larger is drawn a group at a time by
# ``init_cast_params``: the draw and its cast then stay under 2.5 GB above
# the cast tree (Moonshot-v1-16B-A3B's expert leaves, 35.4 GB each in f32,
# draw 738 MB at a time)
SLICE_BYTES = 3 << 29


def init_cast_params(cfg: ModelConfig, generator: torch.Generator, device):
    """The params in their serving dtypes: ``init_params``' draws, in its
    order from the same generator, each leaf cast as ``cast_params`` casts
    it before the next leaf is drawn, so that init holds the cast tree and
    one leaf in f32, never the f32 tree. A stacked leaf (under ``"scan"``)
    of more than ``SLICE_BYTES`` in f32 is drawn one group at a time into
    its cast. On the CPU the result is ``cast_params(init_params(...))`` by
    bits; on CUDA a sliced leaf draws other values (Philox draws a slice
    from its own offset)."""
    dt = getattr(torch, cfg.dtype)
    return init_tree(
        model_specs(cfg), generator, getattr(torch, cfg.param_dtype), device,
        lambda path: None if _read_in_f32(path, cfg) else dt,
        lambda path, spec: path[0] == "scan"
        and 4 * math.prod(spec.shape) > SLICE_BYTES)


def param_logical_names(cfg: ModelConfig):
    return names_tree(model_specs(cfg))


# the recurrent mixers' weights the reference reads from its f32 master:
# RWKV-6's decay LoRA, bonus and group-norm affine (``rwkv6._project``,
# ``group_norm``) and the RG-LRU's gates and Lambda (``griffin._gates``);
# no other mixer has a weight of these names
F32_MIXER_WEIGHTS = frozenset({"w0", "wd1", "wd2", "u", "ln_x_scale",
                               "ln_x_bias", "gate_a", "gate_a_b", "gate_x",
                               "gate_x_b", "lam"})


def _read_in_f32(path: tuple, cfg: ModelConfig) -> bool:
    """Whether the reference reads the weight at ``path`` (its keys) in
    f32, not cast to the activation dtype."""
    leaf = path[-1]
    return leaf.endswith("norm") or leaf == "router" or (
        leaf == "embed" and bool(cfg.n_codebooks)) or (
        path[-2:-1] == ("mixer",) and leaf in F32_MIXER_WEIGHTS)


def cast_params(params, cfg: ModelConfig):
    """``params`` with every weight the layers cast to ``cfg.dtype`` at use
    cast once, the rest as they are (see the module docstring)."""
    dt = getattr(torch, cfg.dtype)

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        return tree if _read_in_f32(path, cfg) else tree.to(dt)
    return walk(params, ())
