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
  every f32 case (TF32 would round f32 operands to 10 mantissa bits).

For CPU tensors it takes ``gemm_plain``, which repeats the reference (an f32
``torch.matmul``, then the epilogue one tensor op at a time) and runs on
either device. Sums are taken in another order than the plain version's, so
the kernels and it agree to a tolerance, not bit for bit.

This is not the registry's ``"gemm"`` kernel: that name is the VTA
instruction's exact int8 contract (``kernels/vta_gemm.py``).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

LAUNCHES = {"gemm_float": 0, "gemm_bf16": 0}
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


def gemm_route(dtype: torch.dtype, k: int, n: int) -> str:
    """The launch key of the kernel that takes a (M, K) @ (K, N) product of
    ``dtype`` on the card: ``"gemm_bf16"`` for bf16 with K (not 0) and N
    multiples of 8, else ``"gemm_float"``."""
    if dtype == torch.bfloat16 and k > 0 and k % 8 == 0 and n % 8 == 0:
        return "gemm_bf16"
    return "gemm_float"


_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# launch key -> (source, C entry point, its argument types): x, w, bias, out,
# M, N, K, [dtype code,] act, has_clip, lo, hi, stream
_ENTRIES = {
    "gemm_bf16": ("gemm_bf16_sm90", "gemm_bf16_launch",
                  [_VP] * 4 + [_I] * 5 + [_F, _F, _VP]),
    "gemm_float": ("gemm_f32", "gemm_f32_launch",
                   [_VP] * 4 + [_I] * 6 + [_F, _F, _VP]),
}


def _lib(route: str):
    source, name, argtypes = _ENTRIES[route]
    fn = getattr(_build.library(source), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def gemm(x: torch.Tensor, w: torch.Tensor,
         bias: Optional[torch.Tensor] = None, *, act: Optional[str] = None,
         clip: Optional[float] = None) -> torch.Tensor:
    """The kernels' wrapper: CUDA tensors launch the kernel ``gemm_route``
    names, once; CPU tensors take ``gemm_plain``. Raises on anything the
    kernels do not take."""
    _check(x, w, bias, act)
    if not _build.on_card("gemm", x, w, bias):
        return gemm_plain(x, w, bias, act=act, clip=clip)
    code = _build.float_code("gemm", x, w, bias)
    (m, k), n = x.shape, w.shape[1]
    route = gemm_route(x.dtype, k, n)
    x, w = _build.aligned(x), _build.aligned(w)
    bias = None if bias is None else bias.contiguous()
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    lo, hi = (0.0, 0.0) if clip is None else (-clip, clip)
    args = [x.data_ptr(), w.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(), m, n, k]
    if route == "gemm_float":
        args.append(code)
    status = _lib(route)(*args, ACTS.index(act), clip is not None, lo, hi,
                         torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(status, "gemm")
    LAUNCHES[route] += 1
    return out
