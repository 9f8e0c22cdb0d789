"""NHWC pooling with a selectable pad value: CUDA kernel + plain version.

Replaces ``repro/kernels/pool2d.py::pool2d``: x (B, H, W, C), a k x k window
at stride ``stride`` over the input padded by ``pad`` on both spatial sides.
``max`` pads with -inf; ``avg`` pads with 0, sums the k*k taps in f32 in tap
order and divides by k*k everywhere (padding counts). The result is in x's
dtype. ``pool2d`` launches ``csrc/pool2d.cu`` for CUDA tensors (f32 or bf16)
and counts the launch in ``LAUNCHES["pool2d"]``; for CPU tensors it takes
``pool2d_plain``, which runs on either device and agrees with the kernel bit
for bit.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

LAUNCHES = {"pool2d": 0}
MODES = ("max", "avg")


def _out_hw(x: torch.Tensor, k: int, stride: int, pad: int,
            mode: str) -> tuple:
    if mode not in MODES:
        raise ValueError(f"pool2d mode must be one of {MODES}, got {mode!r}")
    if x.dim() != 4:
        raise ValueError(f"pool2d takes x (B, H, W, C), got {tuple(x.shape)}")
    if k < 1 or stride < 1 or pad < 0:
        raise ValueError(f"pool2d: k {k}, stride {stride}, pad {pad}")
    _, h, w, _ = x.shape
    oh = (h + 2 * pad - k) // stride + 1
    ow = (w + 2 * pad - k) // stride + 1
    if oh < 1 or ow < 1:
        raise ValueError(f"pool2d: window {k} larger than the padded {h}x{w} "
                         f"input")
    return oh, ow


def pool2d_plain(x: torch.Tensor, *, k: int, stride: int, pad: int = 0,
                 mode: str = "max") -> torch.Tensor:
    """Plain version: pad in f32 with the mode's fill, then fold the taps in
    dy-major order with ``torch.maximum`` or ``+``; avg divides by k*k
    held in a tensor (a true division, not a multiply by the reciprocal)."""
    oh, ow = _out_hw(x, k, stride, pad, mode)
    b, h, w, c = x.shape
    fill = float("-inf") if mode == "max" else 0.0
    xp = torch.full((b, h + 2 * pad, w + 2 * pad, c), fill,
                    dtype=torch.float32, device=x.device)
    xp[:, pad:pad + h, pad:pad + w] = x.to(torch.float32)
    acc = torch.full((b, oh, ow, c), fill, dtype=torch.float32,
                     device=x.device)
    for dy in range(k):
        for dx in range(k):
            sub = xp[:, dy:dy + stride * oh:stride, dx:dx + stride * ow:stride]
            acc = torch.maximum(acc, sub) if mode == "max" else acc + sub
    if mode == "avg":
        acc = acc / torch.tensor(float(k * k), device=x.device)
    return acc.to(x.dtype)


def _lib():
    fn = _build.library("pool2d").pool2d_launch
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp] + [i] * 11 + [vp]
        fn.restype = ctypes.c_int
    return fn


def pool2d(x: torch.Tensor, *, k: int, stride: int, pad: int = 0,
           mode: str = "max") -> torch.Tensor:
    """The kernel's wrapper: CUDA tensors launch ``csrc/pool2d.cu``; CPU
    tensors take ``pool2d_plain``. Raises on anything the kernel does not
    take."""
    oh, ow = _out_hw(x, k, stride, pad, mode)
    if not _build.on_card("pool2d", x):
        return pool2d_plain(x, k=k, stride=stride, pad=pad, mode=mode)
    code = _build.float_code("pool2d", x)
    x = x.contiguous()
    b, h, w, c = x.shape
    out = torch.empty((b, oh, ow, c), dtype=x.dtype, device=x.device)
    status = _lib()(x.data_ptr(), out.data_ptr(), b, h, w, c, k, stride, pad,
                    oh, ow, code, MODES.index(mode),
                    torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(status, "pool2d")
    LAUNCHES["pool2d"] += 1
    return out
