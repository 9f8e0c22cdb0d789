"""Fused element-wise ALU op on float tensors: CUDA kernel + plain version.

Replaces ``repro/kernels/alu.py::alu``, the VTA ALU analogue on the TPU plane:

    out = clip(op(x, y or imm) * 2^-shift, -clip, clip)     op: add|mul|max|min

computed in f32 and rounded to x's dtype. ``mul`` with a second operand is the
paper's new element-wise multiply. ``alu`` launches ``csrc/alu.cu`` for CUDA
tensors (f32 or bf16, y of x's shape and dtype) and counts the launch in
``LAUNCHES["alu"]``; for CPU tensors it takes ``alu_plain``, which repeats the
reference step by step and runs on either device.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

LAUNCHES = {"alu": 0}
OPS = ("add", "mul", "max", "min")


def _check(x: torch.Tensor, y: Optional[torch.Tensor], op: str) -> None:
    if op not in OPS:
        raise ValueError(f"alu op must be one of {OPS}, got {op!r}")
    if y is not None and y.shape != x.shape:
        raise ValueError(f"alu operands differ in shape: {tuple(x.shape)} vs "
                         f"{tuple(y.shape)}")


def alu_plain(x: torch.Tensor, y: Optional[torch.Tensor] = None, *,
              op: str = "add", imm: float = 0.0, shift: int = 0,
              clip: Optional[float] = None) -> torch.Tensor:
    """Plain version: the reference's f32 steps, one tensor op each."""
    _check(x, y, op)
    a = x.to(torch.float32)
    b = (y.to(torch.float32) if y is not None
         else torch.tensor(imm, dtype=torch.float32, device=x.device))
    if op == "add":
        r = a + b
    elif op == "mul":
        r = a * b
    elif op == "max":
        r = torch.maximum(a, b)
    else:
        r = torch.minimum(a, b)
    if shift:
        r = r * (2.0 ** -shift)
    if clip is not None:
        r = torch.clamp(r, -clip, clip)
    return r.to(x.dtype)


def _lib():
    fn = _build.library("alu").alu_launch
    if fn.argtypes is None:
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [vp, vp, vp, ctypes.c_longlong, i, i, f, f, i, f, f, vp]
        fn.restype = ctypes.c_int
    return fn


def alu(x: torch.Tensor, y: Optional[torch.Tensor] = None, *,
        op: str = "add", imm: float = 0.0, shift: int = 0,
        clip: Optional[float] = None) -> torch.Tensor:
    """The kernel's wrapper: CUDA tensors launch ``csrc/alu.cu``; CPU tensors
    take ``alu_plain``. Raises on anything the kernel does not take."""
    _check(x, y, op)
    if not _build.on_card("alu", x, y):
        return alu_plain(x, y, op=op, imm=imm, shift=shift, clip=clip)
    code = _build.float_code("alu", x, y)
    x = x.contiguous()
    y = None if y is None else y.contiguous()
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    lo, hi = (0.0, 0.0) if clip is None else (-clip, clip)
    status = _lib()(x.data_ptr(), None if y is None else y.data_ptr(),
                    out.data_ptr(), x.numel(), code, OPS.index(op), imm,
                    2.0 ** -shift, clip is not None, lo, hi,
                    torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(status, "alu")
    LAUNCHES["alu"] += 1
    return out
