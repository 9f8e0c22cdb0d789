"""Float GEMM with the fused epilogue: CUDA kernels + plain version.

Replaces the float branch of ``repro/kernels/vta_gemm.py::blocked_gemm``, the
kernel behind ``repro/kernels/gemm.py::gemm``:

    out = clip(act(x @ w + bias), -clip, clip)      act: None|relu|silu|gelu

x (M, K), w (K, N), bias (N,) or None; f32 accumulation, gelu in its tanh
approximation, the result in x's dtype. For CUDA tensors (f32 or bf16, w and
bias of x's dtype) ``gemm`` launches one of two kernels by a fixed rule on
dtype and shape (``gemm_route``), and counts the launch under the kernel's
key in ``LAUNCHES``:

- ``"gemm_bf16"``, ``csrc/gemm_bf16_sm90.cu``: bf16 with K % 8 == 0 and
  N % 8 == 0 (the 16-byte row strides TMA needs; M is free), on ``wgmma``;
- ``"gemm_float"``, ``csrc/gemm_f32.cu``: every other shape in bf16, and
  every f32 case (TF32 would round f32 operands to 10 mantissa bits), on
  the CUDA cores with the tile and split count of K that
  ``gemm_float_plan`` picks. With more than one split the kernel writes
  f32 partial sums per split to a workspace (``gemm_partials``) and a
  second kernel (``gemm_float_reduce``, launch key ``"gemm_float_reduce"``)
  sums them in split order and applies the epilogue once; its plain
  version is ``gemm_float_reduce_plain``.

For CPU tensors it takes ``gemm_plain``, which repeats the reference (an f32
``torch.matmul``, then the epilogue one tensor op at a time) and runs on
either device. Sums are taken in another order than the plain version's, so
the kernels and it agree to a tolerance, not bit for bit.

This is not the registry's ``"gemm"`` kernel: that name is the VTA
instruction's exact int8 contract (``kernels/vta_gemm.py``).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build, count_launch

LAUNCHES = {"gemm_float": 0, "gemm_float_reduce": 0, "gemm_bf16": 0}
ACTS = (None, "relu", "silu", "gelu")


def _check(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
           act: Optional[str]) -> None:
    if act not in ACTS:
        raise ValueError(f"gemm act must be one of {ACTS}, got {act!r}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"gemm takes x (M, K) and w (K, N), got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    if bias is not None and tuple(bias.shape) != (w.shape[1],):
        raise ValueError(f"gemm bias must have shape ({w.shape[1]},), got "
                         f"{tuple(bias.shape)}")


def gemm_plain(x: torch.Tensor, w: torch.Tensor,
               bias: Optional[torch.Tensor] = None, *,
               act: Optional[str] = None,
               clip: Optional[float] = None) -> torch.Tensor:
    """Plain version: f32 product, then bias, activation and clip."""
    _check(x, w, bias, act)
    out = torch.matmul(x.to(torch.float32), w.to(torch.float32))
    return _epilogue(out, bias, act, clip, x.dtype)


def _epilogue(out: torch.Tensor, bias: Optional[torch.Tensor],
              act: Optional[str], clip: Optional[float],
              dtype: torch.dtype) -> torch.Tensor:
    """Bias, activation and clip on an f32 sum, rounded to ``dtype``."""
    if bias is not None:
        out = out + bias.to(torch.float32)
    if act == "relu":
        out = torch.relu(out)
    elif act == "silu":
        out = F.silu(out)
    elif act == "gelu":
        out = F.gelu(out, approximate="tanh")
    if clip is not None:
        out = torch.clamp(out, -clip, clip)
    return out.to(dtype)


def gemm_route(dtype: torch.dtype, k: int, n: int) -> str:
    """The launch key of the kernel that takes a (M, K) @ (K, N) product of
    ``dtype`` on the card: ``"gemm_bf16"`` for bf16 with K (not 0) and N
    multiples of 8, else ``"gemm_float"``."""
    if dtype == torch.bfloat16 and k > 0 and k % 8 == 0 and n % 8 == 0:
        return "gemm_bf16"
    return "gemm_float"


SMS = 132                    # streaming multiprocessors of the H100 SXM
SPLIT_UNIT = 16              # splits of csrc/gemm_f32.cu start on it
MIN_SPLIT = 64               # the least K depth of a split
MAX_SPLITS = 16
TILE = (64, 64)              # csrc/gemm_f32.cu's output tile, M > 16
THIN_TILE = (16, 32)         # and for M <= 16
TARGET_BLOCKS = 6 * SMS      # a split grid's size: 6 blocks an SM


def gemm_float_splits(k: int, splits: int) -> list:
    """The K range [k0, k1) of each split, in order, as csrc/gemm_f32.cu's
    ``split_range`` computes it: split s covers the 16-deep K units
    floor(s U / S) to floor((s + 1) U / S), U = ceil(K / 16), the last
    ending at K."""
    units = -(-k // SPLIT_UNIT)
    return [(s * units // splits * SPLIT_UNIT,
             k if s == splits - 1 else (s + 1) * units // splits * SPLIT_UNIT)
            for s in range(splits)]


def _max_splits(k: int) -> int:
    s = min(MAX_SPLITS, max(1, k // MIN_SPLIT))
    while s > 1 and min(b - a for a, b in gemm_float_splits(k, s)) < MIN_SPLIT:
        s -= 1
    return s


def gemm_float_plan(m: int, n: int, k: int) -> tuple:
    """(bm, bn, splits) of csrc/gemm_f32.cu for an (M, K) @ (K, N) product:
    ``THIN_TILE`` for M <= 16, else ``TILE``; no split where the tiles fill
    the ``SMS`` SMs twice, else the power of two nearest to
    ``TARGET_BLOCKS`` / tiles, within 1 and ``_max_splits(K)`` (1 for K <=
    64, every split at least ``MIN_SPLIT`` deep, at most ``MAX_SPLITS``).
    The rule is the one that came nearest to the best plan of every
    phase-4 shape in a sweep on the H100."""
    bm, bn = THIN_TILE if m <= 16 else TILE
    tiles = -(-m // bm) * -(-n // bn)
    if tiles >= 2 * SMS:
        return bm, bn, 1
    splits = 2 ** round(math.log2(TARGET_BLOCKS / tiles))
    return bm, bn, max(1, min(splits, _max_splits(k)))


def gemm_float_reduce_plain(parts: torch.Tensor,
                            bias: Optional[torch.Tensor],
                            act: Optional[str], clip: Optional[float],
                            dtype: torch.dtype) -> torch.Tensor:
    """Plain version of the reduce kernel: the (splits, M, N) f32 partial
    sums added in split order 0, 1, ..., then bias, activation and clip,
    rounded to ``dtype``."""
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return _epilogue(out, bias, act, clip, dtype)


_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry point -> (source, argument types)
_ENTRIES = {
    # x, w, bias, out, M, N, K, act, has_clip, lo, hi, stream
    "gemm_bf16_launch": ("gemm_bf16_sm90", [_VP] * 4 + [_I] * 5
                         + [_F, _F, _VP]),
    # x, w, bias, out, work, M, N, K, dtype, act, has_clip, lo, hi, bm, bn,
    # splits, stream
    "gemm_f32_launch": ("gemm_f32", [_VP] * 5 + [_I] * 6 + [_F, _F]
                        + [_I] * 3 + [_VP]),
    # work, bias, out, M, N, splits, dtype, act, has_clip, lo, hi, stream
    "gemm_f32_reduce_launch": ("gemm_f32", [_VP] * 3 + [_I] * 6
                               + [_F, _F, _VP]),
}


def _fn(name: str):
    source, argtypes = _ENTRIES[name]
    fn = getattr(_build.library(source), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _clip_args(clip: Optional[float]) -> tuple:
    return (clip is not None,) + ((0.0, 0.0) if clip is None
                                  else (-clip, clip))


def gemm_partials(x: torch.Tensor, w: torch.Tensor, plan: tuple
                  ) -> torch.Tensor:
    """The split kernel on CUDA tensors (contiguous, 16-byte aligned, f32
    or bf16 of one dtype): launches csrc/gemm_f32.cu once with ``plan``
    (bm, bn, splits > 1), counted in ``LAUNCHES["gemm_float"]``, and
    returns its (splits, M, N) f32 workspace of partial sums."""
    (m, k), n = x.shape, w.shape[1]
    bm, bn, splits = plan
    work = torch.empty((splits, m, n), dtype=torch.float32, device=x.device)
    status = _fn("gemm_f32_launch")(
        x.data_ptr(), w.data_ptr(), None, None, work.data_ptr(), m, n, k,
        _build.FLOAT_CODES[x.dtype], 0, 0, 0.0, 0.0, bm, bn, splits,
        _stream(x))
    _build.check(status, "gemm")
    count_launch(LAUNCHES, "gemm_float")
    return work


def gemm_float_reduce(parts: torch.Tensor, bias: Optional[torch.Tensor],
                      act: Optional[str], clip: Optional[float],
                      dtype: torch.dtype) -> torch.Tensor:
    """The reduce kernel: (splits, M, N) f32 partials to the (M, N) output
    in ``dtype``. CUDA tensors launch csrc/gemm_f32.cu's reduce kernel
    once, counted in ``LAUNCHES["gemm_float_reduce"]``; CPU tensors take
    ``gemm_float_reduce_plain``."""
    if not _build.on_card("gemm", parts, bias):
        return gemm_float_reduce_plain(parts, bias, act, clip, dtype)
    splits, m, n = parts.shape
    parts = parts.contiguous()
    bias = None if bias is None else bias.contiguous()
    out = torch.empty((m, n), dtype=dtype, device=parts.device)
    status = _fn("gemm_f32_reduce_launch")(
        parts.data_ptr(), None if bias is None else bias.data_ptr(),
        out.data_ptr(), m, n, splits, _build.FLOAT_CODES[dtype],
        ACTS.index(act), *_clip_args(clip), _stream(parts))
    _build.check(status, "gemm")
    count_launch(LAUNCHES, "gemm_float_reduce")
    return out


def gemm(x: torch.Tensor, w: torch.Tensor,
         bias: Optional[torch.Tensor] = None, *, act: Optional[str] = None,
         clip: Optional[float] = None) -> torch.Tensor:
    """The kernels' wrapper: CUDA tensors launch the kernel ``gemm_route``
    names, once (``gemm_float`` with the plan of ``gemm_float_plan``, and
    after it the reduce kernel where the plan splits K); CPU tensors take
    ``gemm_plain``. Raises on anything the kernels do not take."""
    _check(x, w, bias, act)
    if not _build.on_card("gemm", x, w, bias):
        return gemm_plain(x, w, bias, act=act, clip=clip)
    code = _build.float_code("gemm", x, w, bias)
    (m, k), n = x.shape, w.shape[1]
    route = gemm_route(x.dtype, k, n)
    x, w = _build.aligned(x), _build.aligned(w)
    bias = None if bias is None else bias.contiguous()
    if route == "gemm_float":
        plan = gemm_float_plan(m, n, k)
        if plan[2] > 1:
            return gemm_float_reduce(gemm_partials(x, w, plan), bias, act,
                                     clip, x.dtype)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    args = [x.data_ptr(), w.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr()]
    if route == "gemm_float":
        status = _fn("gemm_f32_launch")(
            *args, None, m, n, k, code, ACTS.index(act), *_clip_args(clip),
            *plan, _stream(x))
    else:
        status = _fn("gemm_bf16_launch")(
            *args, m, n, k, ACTS.index(act), *_clip_args(clip), _stream(x))
    _build.check(status, "gemm")
    count_launch(LAUNCHES, route)
    return out
