"""Exact int8 GEMM for one VTA GEMM instruction: CUDA kernel + plain version.

Replaces ``repro/kernels/vta_gemm.py::blocked_gemm`` (the Pallas kernel the
JAX backend reaches through ``fsim_jax._gemm_product``). Contract: x
(N, w_d, M, K) int8 — per image, the instruction's gathered input rows
grouped by weight block; w (Nw, w_d, K, 16) int8 with Nw = 1 when the weight
scratchpad is shared by the batch, else N; returns (N, w_d, M, 16) int32,
bit-identical to the reference's blocked-f32 contraction.

``vta_gemm`` launches ``csrc/vta_gemm.cu`` for CUDA tensors and counts the
launch in ``LAUNCHES["gemm"]``; for CPU tensors it takes ``gemm_plain``.
``gemm_plain`` contracts in f32 blocks of at most ``F32_EXACT_TERMS`` terms
accumulated in int32, as ``_gemm_product`` does, and runs on either device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.registry import register_kernel
from repro_torch.vta.lowering import F32_EXACT_TERMS

LAUNCHES = {"gemm": 0}


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"gemm takes int8 operands, got {x.dtype}, {w.dtype}")
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"gemm takes x (N, w_d, M, K) and w (Nw, w_d, K, 16),"
                         f" got {tuple(x.shape)}, {tuple(w.shape)}")
    n, w_d, _, k = x.shape
    if w.shape[1:3] != (w_d, k) or w.shape[0] not in (1, n):
        raise ValueError(f"gemm shape mismatch: x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}")


def gemm_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version: exact f32 matmul blocks of <= F32_EXACT_TERMS terms
    (every partial sum of int8 products stays below 2^24), summed in int32."""
    _check(x, w)
    K = x.shape[-1]
    xf = x.to(torch.float32)
    wf = w.to(torch.float32)
    out = torch.zeros(x.shape[:3] + (w.shape[-1],), dtype=torch.int32,
                      device=x.device)
    for k0 in range(0, K, F32_EXACT_TERMS):
        part = torch.matmul(xf[..., k0:k0 + F32_EXACT_TERMS],
                            wf[..., k0:k0 + F32_EXACT_TERMS, :])
        out += part.to(torch.int32)
    return out


def _lib():
    lib = _build.library("vta_gemm")
    fn = lib.vta_gemm_launch
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, i, i, i, i, ctypes.c_longlong, vp]
        fn.restype = ctypes.c_int
    return fn


def vta_gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The kernel's wrapper: CUDA tensors launch ``csrc/vta_gemm.cu``; CPU
    tensors take ``gemm_plain``. Raises on anything the kernel does not take."""
    _check(x, w)
    if not x.is_cuda:
        return gemm_plain(x, w)
    if not w.is_cuda or w.device != x.device:
        raise ValueError("gemm operands must be on the same CUDA device")
    if w.shape[-1] != 16:
        raise ValueError(f"the CUDA gemm takes 16 output columns, "
                         f"got {w.shape[-1]}")
    x = x.contiguous()
    w = w.contiguous()
    n, w_d, m, k = x.shape
    out = torch.empty((n, w_d, m, 16), dtype=torch.int32, device=x.device)
    w_nstride = 0 if w.shape[0] == 1 else w_d * k * 16
    fn = _lib()
    status = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), n, w_d, m, k,
                w_nstride, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(status, "vta_gemm")
    LAUNCHES["gemm"] += 1
    return out


register_kernel("gemm", "cuda", vta_gemm)
register_kernel("gemm", "torch", gemm_plain)
