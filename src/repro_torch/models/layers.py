"""Shared building blocks: param specs, norms, rotary embeddings, MLPs.

The port of ``repro/models/layers.py``. Every parameter is declared as a
``Spec`` (shape + logical dim names + initializer); one spec tree is the
source of truth for initialization and the logical names. A tree is a
nested dict whose leaves are Specs or tensors, flattened in sorted key
order, as JAX flattens dicts. ``associative_scan`` is the port of
``jax.lax.associative_scan``, which the recurrent blocks use;
``cross_entropy`` is the training loss.
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                      distribute_tensor)
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset

from repro_torch.configs.base import ModelConfig
from repro_torch.sharding import lshard
from repro_torch.sharding.logical import (constrain, like_channels, linear,
                                          merge_dims, split_dim)
from repro_torch.utils.tree import tree_map


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


def is_spec(x) -> bool:
    return isinstance(x, Spec)


def abstract_leaf(shape, dtype, sharding=None) -> torch.Tensor:
    """A tensor of ``shape`` and ``dtype`` on the meta device (no memory):
    plain without ``sharding``, else a DTensor of the sharding's placements
    over its mesh, its local shard the shape one rank holds."""
    t = torch.empty(tuple(shape), dtype=dtype, device="meta")
    if sharding is None:
        return t
    return distribute_tensor(t, sharding.mesh, sharding.placements(),
                             src_data_rank=None)


def abstract_tree(specs, dtype, sharding_fn=None):
    """Spec tree -> tree of meta tensors (``abstract_leaf``), each
    distributed by ``sharding_fn(names, shape)`` where one is given."""
    return tree_map(lambda s: abstract_leaf(
        s.shape, dtype, None if sharding_fn is None
        else sharding_fn(s.names, s.shape)), specs)


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


def materialize(spec: Spec, generator: torch.Generator, dtype,
                device, shape=None) -> torch.Tensor:
    """Turn one Spec into an initialized tensor on ``device``, its random
    draws from ``generator`` (which must live on ``device``). ``shape``:
    only a block of the leaf, of that shape, drawn as the leaf's own
    values are (the same scale) from the generator's next draws; on the
    CPU the blocks of a leaf drawn one after another in its memory order
    are its whole draw by bits where each block holds a multiple of 16
    elements (the normal and uniform fills go 16 values at a time)."""
    shp = spec.shape if shape is None else tuple(shape)
    f32 = dict(dtype=torch.float32, device=device)
    if spec.init == "zeros":
        return torch.zeros(shp, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(shp, dtype=dtype, device=device)
    if spec.init == "normal":
        return torch.randn(shp, generator=generator, **f32).mul_(
            std_of(spec)).to(dtype)
    if spec.init == "decay":       # RWKV6 per-channel log-log decay base
        base = torch.linspace(-6.0, -0.5, shp[-1], **f32)
        return base.expand(shp).to(dtype).contiguous()
    if spec.init == "lambda":      # RG-LRU Λ s.t. a = exp(-8*softplus(Λ)) ∈ [.9,.999]
        sp = torch.linspace(1.25e-4, 1.32e-2, shp[-1], **f32)
        return torch.log(torch.expm1(sp)).expand(shp).to(dtype).contiguous()
    if spec.init == "uniform_small":
        u = torch.rand(shp, generator=generator, **f32)
        return u.mul_(0.02).sub_(0.01).to(dtype)
    raise ValueError(f"unknown init {spec.init}")


def init_tree(specs, generator: torch.Generator, dtype, device,
              cast_to: Callable = lambda path: None,
              block_rows: Callable = lambda path, spec: (),
              path: tuple = ()):
    """Materialize a tree of Specs in ``dtype``, leaf after leaf in sorted
    key order from one generator, each leaf cast to ``cast_to(path)``
    (``None``: kept in ``dtype``) before the next leaf is drawn, so that no
    more than one leaf is ever held in ``dtype``. A leaf for which
    ``block_rows(path, spec)`` is a block (n0, ..., nk), not ``()``, is
    drawn a block of that extent in its leading dims at a time, in row-major
    order, each block cast into the leaf: the whole leaf's draw by bits on
    the CPU where every dim of the block but its last is 1 and every block
    but the last holds a multiple of 16 elements and the last at least 16
    (the normal fill goes 16 values at a time)."""
    if isinstance(specs, dict):
        return {k: init_tree(specs[k], generator, dtype, device, cast_to,
                             block_rows, path + (k,))
                for k in sorted(specs)}
    dt = cast_to(path) or dtype
    if specs.init in ("zeros", "ones"):
        return materialize(specs, generator, dt, device)
    block = tuple(block_rows(path, specs))
    if not block:
        return materialize(specs, generator, dtype, device).to(dt)
    out = torch.empty(specs.shape, dtype=dt, device=device)
    lead, rest = specs.shape[:len(block)], tuple(specs.shape[len(block):])
    for at in itertools.product(*(range(0, n, r)
                                  for n, r in zip(lead, block))):
        extent = tuple(min(r, n - i) for i, r, n in zip(at, block, lead))
        out[tuple(slice(i, i + m) for i, m in zip(at, extent))].copy_(
            materialize(specs, generator, dtype, device, extent + rest))
    return out


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


def group_norm(x, scale, bias, n_groups: int, eps: float = 1e-5):
    """GroupNorm over the channel dim (used by RWKV6 after WKV): f32 inside,
    the variance the mean of squared deviations, as ``jnp.var``."""
    dt = x.dtype
    *lead, c = x.shape
    if isinstance(x, DTensor):
        # each group whole on its rank; the affine placed as the channels
        xf = split_dim(x.to(torch.float32), -1, (n_groups, c // n_groups))
    else:
        xf = x.to(torch.float32).reshape(*lead, n_groups, c // n_groups)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    centered = xf - mu
    var = torch.mean(centered * centered, dim=-1, keepdim=True)
    y = merge_dims(centered * torch.rsqrt(var + eps), -2)
    return (y * like_channels(scale.to(torch.float32), y)
            + like_channels(bias.to(torch.float32), y)).to(dt)


def _along(x, dim: int, start: int, stop: Optional[int] = None,
           step: int = 1):
    """x[start:stop:step] along ``dim``, a view."""
    idx = [slice(None)] * x.dim()
    idx[dim] = slice(start, stop, step)
    return x[tuple(idx)]


def associative_scan(fn: Callable, elems: Sequence, dim: int = 0) -> tuple:
    """Inclusive scan of the tuple of tensors ``elems`` along ``dim`` under
    the associative ``fn(a, b) -> c`` (tuples of tensors): the k-th result
    combines the first k + 1 elements.

    The recursion of ``jax.lax.associative_scan``, so that the results
    are associated as the reference's are: combine the even and odd pairs,
    scan the half-length result, combine its results with the remaining
    even elements, and interleave. log2(T) levels of elementwise ``fn``
    calls on the card, not T steps. (JAX interleaves by padding both
    halves with zeros and adding them, which turns a -0.0 into +0.0; this
    writes each value as it is.)"""
    elems = tuple(elems)
    dim = dim % elems[0].dim()

    def scan(xs: tuple) -> tuple:
        n = xs[0].shape[dim]
        if n < 2:
            return xs
        odd = scan(tuple(fn(tuple(_along(x, dim, 0, n - 1, 2) for x in xs),
                            tuple(_along(x, dim, 1, None, 2) for x in xs))))
        rest = tuple(_along(x, dim, 2, None, 2) for x in xs)
        if n % 2 == 0:
            even = fn(tuple(_along(o, dim, 0, -1) for o in odd), rest)
        else:
            even = fn(odd, rest)
        out = []
        for x, e, o in zip(xs, even, odd):
            y = torch.empty_like(x)
            _along(y, dim, 0, 1).copy_(_along(x, dim, 0, 1))
            _along(y, dim, 2, None, 2).copy_(e)
            _along(y, dim, 1, None, 2).copy_(o)
            out.append(y)
        return tuple(out)
    return scan(elems)


def softcap(x, cap: Optional[float]):
    if cap is None:
        return x
    return (cap * torch.tanh(x.to(torch.float32) / cap)).to(x.dtype)


def sigmoid(x):
    """The logistic in the reference's steps, each rounded to x's dtype:
    XLA expands it to 1 / (1 + exp(-x))."""
    return 1 / (1 + torch.exp(-x))


def softplus(x):
    """``jax.nn.softplus``'s form, ``jnp.logaddexp(x, 0)``: max(x, 0) +
    log1p(exp(-|x|))."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))


def _silu(x):
    """x * sigmoid(x) in the reference's steps, each rounded to x's dtype."""
    return x * sigmoid(x)


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
    h = a(linear(x, p["wg"].to(x.dtype)))
    h = h * linear(x, p["wi"].to(x.dtype))
    h = lshard(h, "batch", "seq", "d_ff")
    return linear(h, p["wo"].to(x.dtype))


def _vocab_sharded(w, dim: int) -> bool:
    return isinstance(w, DTensor) and any(p.is_shard(dim)
                                          for p in w.placements)


def _vocab_local(t, idx, dim: int, pl: list):
    """For DTensor ``t`` sharded on vocab dim ``dim`` and integer ``idx``
    (redistributed to ``pl``, which replicates it over the mesh dims that
    shard the vocab): (t's local shard, the local index into it clamped
    into it, a mask of the indices it holds, the output placements:
    ``Partial()`` where the vocab is sharded, ``pl``'s elsewhere, the
    output's leading shape)."""
    mesh = t.device_mesh
    if not isinstance(idx, DTensor):
        idx = distribute_tensor(idx, mesh, [Replicate()] * mesh.ndim,
                                src_data_rank=None)
    loc = t.to_local()
    start = compute_local_shape_and_global_offset(
        t.shape, mesh, t.placements)[1][dim]
    i = idx.redistribute(mesh, pl).to_local().long() - start
    inside = (i >= 0) & (i < loc.shape[dim])
    out = [Partial() if p.is_shard(dim) else q
           for p, q in zip(t.placements, pl)]
    return loc, i.clamp(0, loc.shape[dim] - 1), inside, out, idx.shape


def _from_local(x, t, placements, shape):
    return DTensor.from_local(x, t.device_mesh, placements, run_check=False,
                              shape=shape, stride=torch.empty(
                                  shape, device="meta").stride())


def embed_lookup(w, tokens):
    """``w[tokens]``: the rows of table ``w`` (V, d) at integer
    ``tokens``. For a DTensor table with its vocab dim sharded, each rank
    looks up the tokens that fall in its slice of the vocab (zeros
    elsewhere) on its table gathered over d_model, and the result is their
    ``Partial(sum)``; the tokens are gathered over the vocab's mesh dims
    and keep their sharding on the others: the vocab-parallel embedding. DTensor's own rule for the lookup keeps a
    mask whose reduction compares tensors by value (meta tensors, the
    dry-run's, cannot), and has no strategy on a 3-D mesh."""
    if not _vocab_sharded(w, 0):
        return w[tokens]
    w = w.redistribute(w.device_mesh, [p if p.is_shard(0) else Replicate()
                                       for p in w.placements])
    tok_pl = tokens.placements if isinstance(tokens, DTensor) else \
        [Replicate()] * w.device_mesh.ndim
    pl = [Replicate() if p.is_shard(0) or not q.is_shard() else q
          for p, q in zip(w.placements, tok_pl)]
    loc, i, inside, out, shape = _vocab_local(w, tokens, 0, pl)
    rows = torch.where(inside[..., None], loc[i], 0.0)
    return _from_local(rows.to(w.dtype), w, out, tuple(shape) + (w.shape[1],))


def gold_logit(logits, labels):
    """``logits[..., labels]``: the logit of each label. For a DTensor with
    its vocab dim sharded, each rank picks the labels that fall in its
    slice of the vocab (0 elsewhere) and the result is their
    ``Partial(sum)``: DTensor's own rule for a vocab-sharded gather keeps a
    mask whose reduction compares tensors by value, which meta tensors (the
    dry-run's) cannot."""
    vd = logits.dim() - 1
    if not _vocab_sharded(logits, vd):
        return torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    pl = [p if p.is_shard() and p.dim < vd else Replicate()
          for p in logits.placements]
    loc, i, inside, out, shape = _vocab_local(logits, labels, vd, pl)
    g = torch.gather(loc, -1, i[..., None])[..., 0]
    return _from_local(torch.where(inside, g, 0.0), logits, out, shape)


def vocab_logsumexp(logits):
    """``torch.logsumexp(logits, -1)``. For a DTensor with its vocab dim
    sharded, ``max + log(sum(exp(logits - max)))`` over each rank's slice,
    the max and the sum reduced across the ranks (a ``Partial`` each):
    DTensor's own rule gathers the whole vocab onto every rank first. The
    max and the sum, and the sum's gradient, are held replicated over the
    vocab's mesh dims (DTensor would reduce-scatter them over the batch),
    so that the softmax's gradient is formed on each rank's slice."""
    vd = logits.dim() - 1
    if not _vocab_sharded(logits, vd):
        return torch.logsumexp(logits, dim=-1)
    pl = [p if p.is_shard() and p.dim < vd else Replicate()
          for p in logits.placements]
    m = constrain(logits.detach().amax(dim=-1, keepdim=True), pl)
    s = constrain(torch.exp(logits - m).sum(dim=-1, keepdim=True), pl)
    return (m + torch.log(s))[..., 0]


def cross_entropy(logits, labels, final_cap: Optional[float] = None,
                  z_loss: float = 0.0):
    """Mean token cross-entropy in f32. logits (..., V), labels (...) int:
    the softcapped f32 logits' logsumexp minus the gold logit, plus
    ``z_loss * lse^2``, averaged over every label position."""
    logits = softcap(logits.to(torch.float32), final_cap)
    lse = vocab_logsumexp(logits)
    gold = gold_logit(logits, labels)
    loss = lse - gold
    if z_loss:
        loss = loss + z_loss * torch.square(lse)
    return torch.mean(loss)
