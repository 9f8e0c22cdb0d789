"""Float GEMM with the fused epilogue: CUDA kernel + plain version.

Replaces the float branch of ``repro/kernels/vta_gemm.py::blocked_gemm``, the
kernel behind ``repro/kernels/gemm.py::gemm``:

    out = clip(act(x @ w + bias), -clip, clip)      act: None|relu|silu|gelu

x (M, K), w (K, N), bias (N,) or None; f32 accumulation, gelu in its tanh
approximation, the result in x's dtype. ``gemm`` launches ``csrc/gemm_f32.cu``
for CUDA tensors (f32 or bf16, w and bias of x's dtype) and counts the launch
in ``LAUNCHES["gemm_float"]``; for CPU tensors it takes ``gemm_plain``, which
repeats the reference (an f32 ``torch.matmul``, then the epilogue one tensor
op at a time) and runs on either device. Sums are taken in another order
than the plain version's, so the two agree to a tolerance, not bit for bit.

This is not the registry's ``"gemm"`` kernel: that name is the VTA
instruction's exact int8 contract (``kernels/vta_gemm.py``).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

LAUNCHES = {"gemm_float": 0}
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
    return out.to(x.dtype)


def _lib():
    fn = _build.library("gemm_f32").gemm_f32_launch
    if fn.argtypes is None:
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [vp, vp, vp, vp, i, i, i, i, i, i, f, f, vp]
        fn.restype = ctypes.c_int
    return fn


def gemm(x: torch.Tensor, w: torch.Tensor,
         bias: Optional[torch.Tensor] = None, *, act: Optional[str] = None,
         clip: Optional[float] = None) -> torch.Tensor:
    """The kernel's wrapper: CUDA tensors launch ``csrc/gemm_f32.cu``; CPU
    tensors take ``gemm_plain``. Raises on anything the kernel does not
    take."""
    _check(x, w, bias, act)
    if not _build.on_card("gemm", x, w, bias):
        return gemm_plain(x, w, bias, act=act, clip=clip)
    code = _build.float_code("gemm", x, w, bias)
    x = x.contiguous()
    w = w.contiguous()
    bias = None if bias is None else bias.contiguous()
    (m, k), n = x.shape, w.shape[1]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    lo, hi = (0.0, 0.0) if clip is None else (-clip, clip)
    status = _lib()(x.data_ptr(), w.data_ptr(),
                    None if bias is None else bias.data_ptr(), out.data_ptr(),
                    m, n, k, code, ACTS.index(act), clip is not None, lo, hi,
                    torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(status, "gemm")
    LAUNCHES["gemm_float"] += 1
    return out
