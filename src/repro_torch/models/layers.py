"""Shared building blocks: param specs, norms, rotary embeddings, MLPs.

The port of ``repro/models/layers.py``. Every parameter is declared as a
``Spec`` (shape + logical dim names + initializer); one spec tree is the
source of truth for initialization and the logical names. A tree is a
nested dict whose leaves are Specs or tensors, flattened in sorted key
order, as JAX flattens dicts. ``group_norm`` and ``cross_entropy`` wait for
the RWKV-6 and training slices.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.sharding import lshard


# ---------------------------------------------------------------------------
# Param specs
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class Spec:
    shape: tuple
    names: tuple                       # logical dim names (len == len(shape))
    init: str = "normal"               # normal|zeros|ones|decay|lambda|uniform_small
    scale: Optional[float] = None      # stddev override for "normal"

    def __post_init__(self):
        assert len(self.shape) == len(self.names), (self.shape, self.names)


def _fan_in(shape) -> int:
    if len(shape) == 1:
        return shape[0]
    return int(np.prod(shape[:-1]))


def std_of(spec: Spec) -> float:
    """The standard deviation of a ``"normal"`` Spec: its scale, else
    1/sqrt(fan_in)."""
    if spec.scale is not None:
        return spec.scale
    return 1.0 / math.sqrt(max(1, _fan_in(spec.shape)))


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of nested dicts (``rest``: trees of the same
    structure, whose leaves are passed alongside)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def materialize(spec: Spec, generator: torch.Generator, dtype,
                device) -> torch.Tensor:
    """Turn one Spec into an initialized tensor on ``device``, its random
    draws from ``generator`` (which must live on ``device``)."""
    shp = spec.shape
    f32 = dict(dtype=torch.float32, device=device)
    if spec.init == "zeros":
        return torch.zeros(shp, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(shp, dtype=dtype, device=device)
    if spec.init == "normal":
        return (torch.randn(shp, generator=generator, **f32)
                * std_of(spec)).to(dtype)
    if spec.init == "decay":       # RWKV6 per-channel log-log decay base
        base = torch.linspace(-6.0, -0.5, shp[-1], **f32)
        return base.expand(shp).to(dtype).contiguous()
    if spec.init == "lambda":      # RG-LRU Λ s.t. a = exp(-8*softplus(Λ)) ∈ [.9,.999]
        sp = torch.linspace(1.25e-4, 1.32e-2, shp[-1], **f32)
        return torch.log(torch.expm1(sp)).expand(shp).to(dtype).contiguous()
    if spec.init == "uniform_small":
        u = torch.rand(shp, generator=generator, **f32)
        return (u * 0.02 - 0.01).to(dtype)
    raise ValueError(f"unknown init {spec.init}")


def init_tree(specs, generator: torch.Generator, dtype, device):
    """Materialize a tree of Specs, leaf after leaf in sorted key order
    from one generator."""
    if isinstance(specs, dict):
        return {k: init_tree(specs[k], generator, dtype, device)
                for k in sorted(specs)}
    return materialize(specs, generator, dtype, device)


def names_tree(specs):
    return tree_map(lambda s: s.names, specs)


def stack_specs(specs, n: int, name: str = "layers"):
    """Prepend a stacked leading dim (for the groups' params)."""
    return tree_map(
        lambda s: Spec((n,) + s.shape, (name,) + s.names, s.init, s.scale),
        specs)


# ---------------------------------------------------------------------------
# Numerics
# ---------------------------------------------------------------------------
def rms_norm(x, scale, eps: float = 1e-6, upcast: bool = True):
    """RMSNorm. upcast=True materializes the f32 normalized tensor (safest);
    upcast=False keeps the reduction in f32 but applies the inverse-rms and
    scale in the input dtype."""
    dt = x.dtype
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps)
    if upcast:
        return (xf * inv * (1.0 + scale.to(torch.float32))).to(dt)
    return x * inv.to(dt) * (1.0 + scale).to(dt)


def softcap(x, cap: Optional[float]):
    if cap is None:
        return x
    return (cap * torch.tanh(x.to(torch.float32) / cap)).to(x.dtype)


def _silu(x):
    """x * sigmoid(x) in the reference's steps, each rounded to x's dtype:
    XLA expands the logistic to 1 / (1 + exp(-x))."""
    return x * (1 / (1 + torch.exp(-x)))


def _gelu_tanh(x):
    """The tanh approximation of gelu in the reference's steps
    (``jax.nn.gelu(approximate=True)``), each rounded to x's dtype, its
    constants too."""
    def const(v):
        return torch.tensor(v, dtype=x.dtype)
    inner = const(math.sqrt(2 / math.pi)) * (x + const(0.044715) * (x * x * x))
    return x * (0.5 * (1.0 + torch.tanh(inner)))


def act_fn(name: str):
    """silu, gelu (the tanh approximation, as the reference's) or relu,
    each rounding where the reference's does."""
    return {"silu": _silu, "gelu": _gelu_tanh, "relu": F.relu}[name]


# ---------------------------------------------------------------------------
# Rotary embeddings (incl. M-RoPE for qwen2-vl)
# ---------------------------------------------------------------------------
def rope_angles(positions, head_dim: int, theta: float,
                mrope_sections: Optional[Sequence[int]] = None):
    """positions: (B, S) integers, or (3, B, S) for M-RoPE.

    Returns (sin, cos) of shape (B, S, head_dim//2) float32.
    """
    half = head_dim // 2
    f32 = dict(dtype=torch.float32, device=positions.device)
    inv_freq = 1.0 / (theta ** (torch.arange(0, half, **f32) / half))
    if mrope_sections is None:
        if positions.dim() == 3:         # tolerate (3,B,S) given to plain rope
            positions = positions[0]
        ang = positions.to(torch.float32)[..., None] * inv_freq  # (B,S,half)
    else:
        assert positions.dim() == 3 and \
            positions.shape[0] == len(mrope_sections)
        sec_id = np.repeat(np.arange(len(mrope_sections)), mrope_sections)
        assert sec_id.shape[0] == half, (mrope_sections, half)
        pos = positions.to(torch.float32)            # (3,B,S)
        pos_per_band = pos[torch.as_tensor(sec_id, device=pos.device)]
        ang = torch.movedim(pos_per_band, 0, -1) * inv_freq
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x, sin, cos):
    """x: (B, S, H, head_dim); sin/cos: (B, S, half). Rotate-half convention."""
    dt = x.dtype
    x = x.to(torch.float32)
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    s, c = sin[:, :, None, :], cos[:, :, None, :]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(dt)


# ---------------------------------------------------------------------------
# Dense (gated) MLP
# ---------------------------------------------------------------------------
def mlp_specs(cfg: ModelConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "wi": Spec((d, f), ("d_model", "d_ff")),
        "wg": Spec((d, f), ("d_model", "d_ff")),
        "wo": Spec((f, d), ("d_ff", "d_model")),
    }


def mlp_apply(p, x, cfg: ModelConfig):
    a = act_fn(cfg.mlp_act)
    h = a(torch.matmul(x, p["wg"].to(x.dtype)))
    h = h * torch.matmul(x, p["wi"].to(x.dtype))
    h = lshard(h, "batch", "seq", "d_ff")
    return torch.matmul(h, p["wo"].to(x.dtype))
