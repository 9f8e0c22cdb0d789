"""Abstract input specs for every (architecture x input-shape) dry-run cell;
the port of ``repro/launch/specs.py``.

An abstract input is a meta tensor of its shape and dtype, distributed by its
logical names where rules are given (``models/layers.py::abstract_leaf``):
a DTensor whose local shard has the shape one rank holds and no memory. The
step then runs on these tensors as it runs on real ones, so the dry-run
needs no second description of the step; a ``(shape, dtype, sharding)``
record would need one. The modality frontends of the [vlm]/[audio] archs are
stubs per the assignment: qwen2-vl receives precomputed patch embeddings
(+ M-RoPE positions); musicgen receives EnCodec token codes.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig
from repro_torch.models.layers import abstract_leaf
from repro_torch.models.registry import Model
from repro_torch.sharding.logical import LogicalRules, get_rules
from repro_torch.utils.tree import tree_map_with_path


def _sds(shape, dtype, names, rules: Optional[LogicalRules]):
    return abstract_leaf(shape, dtype, None if rules is None else
                         rules.sharding(names, shape, is_act=True))


def batch_specs(cfg: ModelConfig, shape: ShapeConfig, *, with_labels: bool,
                rules: Optional[LogicalRules] = None) -> dict:
    rules = rules or get_rules()
    B = shape.global_batch
    S = shape.seq_len if shape.kind != "decode" else 1
    out: dict = {}
    if cfg.family == "vlm" and cfg.vision_stub:
        out["embeds"] = _sds((B, S, cfg.d_model), torch.bfloat16,
                             ("batch", "seq", "d_model"), rules)
        out["positions"] = _sds((3, B, S), torch.int32,
                                (None, "batch", "seq"), rules)
    elif cfg.n_codebooks:
        out["tokens"] = _sds((B, cfg.n_codebooks, S), torch.int32,
                             ("batch", "codebooks", "seq"), rules)
    else:
        out["tokens"] = _sds((B, S), torch.int32, ("batch", "seq"), rules)
    if with_labels:
        if cfg.n_codebooks:
            out["labels"] = _sds((B, S, cfg.n_codebooks), torch.int32,
                                 ("batch", "seq", "codebooks"), rules)
        else:
            out["labels"] = _sds((B, S), torch.int32, ("batch", "seq"), rules)
    return out


_CACHE_DIM_NAMES = {
    "k": ("layers", "batch", "kv_seq", "kv_heads", "head_dim"),
    "v": ("layers", "batch", "kv_seq", "kv_heads", "head_dim"),
    "tm_x": ("layers", "batch", "d_model"),
    "tm_S": ("layers", "batch", "heads", "head_dim", "head_dim"),
    "cm_x": ("layers", "batch", "d_model"),
    "conv": ("layers", "batch", "conv_w", "lru"),
    "h": ("layers", "batch", "lru"),
}


def cache_names(key: str, ndim: int) -> Optional[tuple]:
    """The logical names of a cache leaf of ``ndim`` dims under ``key``:
    the stacked names less leading ones when it has fewer dims, padded with
    leading ``None`` when it has more; ``None`` for an unknown key."""
    names = _CACHE_DIM_NAMES.get(key)
    if names is None:
        return None
    names = names[-ndim:] if ndim < len(names) else names
    # unscanned remainder-layer caches have no leading "layers" dim
    if ndim > len(names):
        names = (None,) * (ndim - len(names)) + names
    return names


def cache_specs_sharded(model: Model, shape: ShapeConfig,
                        rules: Optional[LogicalRules] = None) -> dict:
    """Abstract KV/state cache tree (``model.cache_specs``' TensorSpecs as
    meta tensors) with logical shardings attached."""
    rules = rules or get_rules()
    tree = model.cache_specs(shape.global_batch, shape.seq_len)

    def annotate(path, leaf):
        names = cache_names(path[-1], len(leaf.shape))
        if names is None or rules is None:
            return abstract_leaf(leaf.shape, leaf.dtype)
        return abstract_leaf(leaf.shape, leaf.dtype, rules.sharding(
            names, leaf.shape, is_act=True))

    return tree_map_with_path(annotate, tree)


def input_specs(model: Model, shape_name: str,
                rules: Optional[LogicalRules] = None) -> dict:
    """All abstract inputs for the given cell, keyed by step-arg name. The
    decode position is a Python int, as the port's decode step takes it."""
    shape = SHAPES[shape_name]
    cfg = model.cfg
    rules = rules or get_rules()
    if shape.kind == "train":
        return {"batch": batch_specs(cfg, shape, with_labels=True, rules=rules)}
    if shape.kind == "prefill":
        return {"batch": batch_specs(cfg, shape, with_labels=False, rules=rules)}
    # decode: one new token against a seq_len cache
    return {
        "batch": batch_specs(cfg, shape, with_labels=False, rules=rules),
        "caches": cache_specs_sharded(model, shape, rules=rules),
        "pos": shape.seq_len - 1,
    }
