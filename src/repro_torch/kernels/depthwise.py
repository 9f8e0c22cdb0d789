"""NHWC depthwise convolution: CUDA kernel + plain version.

Replaces ``repro/kernels/depthwise.py::depthwise_conv``: x (B, H, W, C), w
(KH, KW, C), zero padding ``pad`` on both spatial sides, stride ``stride``;
f32 accumulation of the KH*KW taps in dy-major order, no bias, the result in
x's dtype. ``depthwise_conv`` launches ``csrc/depthwise.cu`` for CUDA tensors
(f32 or bf16, w of x's dtype) and counts the launch in
``LAUNCHES["depthwise"]``; for CPU tensors it takes ``depthwise_plain``, which
repeats the reference step by step (a separate multiply and add per tap) and
runs on either device. The two agree bit for bit.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

LAUNCHES = {"depthwise": 0}


def _out_hw(x: torch.Tensor, w: torch.Tensor, stride: int, pad: int) -> tuple:
    if x.dim() != 4 or w.dim() != 3 or w.shape[2] != x.shape[3]:
        raise ValueError(f"depthwise_conv takes x (B, H, W, C) and w (KH, KW,"
                         f" C), got {tuple(x.shape)}, {tuple(w.shape)}")
    if stride < 1 or pad < 0:
        raise ValueError(f"depthwise_conv: stride {stride}, pad {pad}")
    _, h, wd, _ = x.shape
    kh, kw, _ = w.shape
    oh = (h + 2 * pad - kh) // stride + 1
    ow = (wd + 2 * pad - kw) // stride + 1
    if oh < 1 or ow < 1:
        raise ValueError(f"depthwise_conv: kernel {kh}x{kw} larger than the "
                         f"padded {h}x{wd} input")
    return oh, ow


def depthwise_plain(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
                    pad: int = 0) -> torch.Tensor:
    """Plain version: pad in f32, then ``out = out + sub * w[dy, dx]`` per
    tap, as the reference does."""
    oh, ow = _out_hw(x, w, stride, pad)
    b, h, wd, c = x.shape
    kh, kw, _ = w.shape
    xp = torch.zeros((b, h + 2 * pad, wd + 2 * pad, c), dtype=torch.float32,
                     device=x.device)
    xp[:, pad:pad + h, pad:pad + wd] = x.to(torch.float32)
    wf = w.to(torch.float32)
    out = torch.zeros((b, oh, ow, c), dtype=torch.float32, device=x.device)
    for dy in range(kh):
        for dx in range(kw):
            sub = xp[:, dy:dy + stride * oh:stride, dx:dx + stride * ow:stride]
            out = out + sub * wf[dy, dx]
    return out.to(x.dtype)


def _lib():
    fn = _build.library("depthwise").depthwise_launch
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp] + [i] * 11 + [vp]
        fn.restype = ctypes.c_int
    return fn


def depthwise_conv(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
                   pad: int = 0) -> torch.Tensor:
    """The kernel's wrapper: CUDA tensors launch ``csrc/depthwise.cu``; CPU
    tensors take ``depthwise_plain``. Raises on anything the kernel does not
    take."""
    oh, ow = _out_hw(x, w, stride, pad)
    if not _build.on_card("depthwise_conv", x, w):
        return depthwise_plain(x, w, stride=stride, pad=pad)
    code = _build.float_code("depthwise_conv", x, w)
    x = x.contiguous()
    w = w.contiguous()
    b, h, wd, c = x.shape
    kh, kw, _ = w.shape
    out = torch.empty((b, oh, ow, c), dtype=x.dtype, device=x.device)
    status = _lib()(x.data_ptr(), w.data_ptr(), out.data_ptr(), b, h, wd, c,
                    kh, kw, stride, pad, oh, ow, code,
                    torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(status, "depthwise_conv")
    LAUNCHES["depthwise"] += 1
    return out
