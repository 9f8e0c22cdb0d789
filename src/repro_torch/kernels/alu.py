"""Fused element-wise ALU op on float tensors: CUDA kernel + plain version.

Replaces ``repro/kernels/alu.py::alu``, the VTA ALU analogue on the TPU plane:

    out = clip(op(x, y or imm) * 2^-shift, -clip, clip)     op: add|mul|max|min

computed in f32 and rounded to x's dtype; max, min and the clip propagate NaN
and order -0 < +0, as ``jnp.maximum`` and ``jnp.minimum`` do. ``mul`` with a second operand is the
paper's new element-wise multiply. ``alu`` launches ``csrc/alu.cu`` for CUDA
tensors (f32 or bf16, y of x's shape and dtype) and counts the launch in
``LAUNCHES["alu"]``; for CPU tensors it takes ``alu_plain``, which repeats the
reference step by step and runs on either device.

The kernel moves 16-byte vectors; ``alu_plan`` cuts the element count into a
scalar head (up to x's first 16-byte boundary), whole vectors and a scalar
tail, and sizes the grid. A view whose data pointer is not 16-byte aligned
is taken as it is (no copy): y and the output are given x's misalignment.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build, count_launch

LAUNCHES = {"alu": 0}
OPS = ("add", "mul", "max", "min")
THREADS = 256              # threads a block of csrc/alu.cu
UNROLL = 4                 # 16-byte vectors a thread a step
WAVE = 132 * (2048 // THREADS)   # resident blocks on the H100's 132 SMs


def nvcc_defines() -> tuple:
    """``csrc/alu.cu``'s macros: its block size and unroll are this
    module's ``THREADS`` and ``UNROLL``, with which ``alu_plan`` sizes the
    grid."""
    return (f"-DALU_THREADS={THREADS}", f"-DALU_UNROLL={UNROLL}")


def alu_plan(n: int, itemsize: int, misalign_bytes: int) -> tuple:
    """(head, vec, unroll, blocks, tail) of ``csrc/alu.cu`` for ``n``
    elements of ``itemsize`` bytes whose first lies ``misalign_bytes`` past
    a 16-byte boundary: ``head`` elements one by one up to the boundary,
    then whole vectors of ``vec`` elements (16 bytes), ``unroll`` of them a
    thread a step, then ``tail`` (< vec) elements one by one; ``blocks`` is
    one wave of resident blocks at most, fewer where the vectors take fewer.
    head + vectors * vec + tail = n."""
    if misalign_bytes % itemsize or not 0 <= misalign_bytes < 16:
        raise ValueError(f"alu: misalignment {misalign_bytes} is not a "
                         f"multiple of the item size {itemsize} below 16")
    vec = 16 // itemsize
    head = min(n, (16 - misalign_bytes) % 16 // itemsize)
    tail = (n - head) % vec
    nvec = (n - head) // vec
    blocks = max(1, min(WAVE, -(-nvec // (THREADS * UNROLL))))
    return head, vec, UNROLL, blocks, tail


def _check(x: torch.Tensor, y: Optional[torch.Tensor], op: str) -> None:
    if op not in OPS:
        raise ValueError(f"alu op must be one of {OPS}, got {op!r}")
    if y is not None and y.shape != x.shape:
        raise ValueError(f"alu operands differ in shape: {tuple(x.shape)} vs "
                         f"{tuple(y.shape)}")


def max_ordered(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.maximum`` on f32 tensors: NaN propagates as in
    ``torch.maximum``, and -0 < +0 (``torch.maximum`` keeps its first
    operand on a tie). Equal operands have equal bits but for the sign of
    zero, so a tie takes the AND of their bits: -0 only if both are -0."""
    tie = (a.view(torch.int32) & b.view(torch.int32)).view(torch.float32)
    return torch.where(a == b, tie, torch.maximum(a, b))


def min_ordered(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.minimum`` on f32 tensors: as ``max_ordered``, a tie takes the
    OR of the bits, -0 if either is -0."""
    tie = (a.view(torch.int32) | b.view(torch.int32)).view(torch.float32)
    return torch.where(a == b, tie, torch.minimum(a, b))


def alu_plain(x: torch.Tensor, y: Optional[torch.Tensor] = None, *,
              op: str = "add", imm: float = 0.0, shift: int = 0,
              clip: Optional[float] = None) -> torch.Tensor:
    """Plain version: the reference's f32 steps, one tensor op each; max,
    min and the clip order -0 < +0 as ``jnp.maximum``/``jnp.minimum`` do."""
    _check(x, y, op)
    a = x.to(torch.float32)
    b = (y.to(torch.float32) if y is not None
         else torch.tensor(imm, dtype=torch.float32, device=x.device))
    if op == "add":
        r = a + b
    elif op == "mul":
        r = a * b
    elif op == "max":
        r = max_ordered(a, b)
    else:
        r = min_ordered(a, b)
    if shift:
        r = r * (2.0 ** -shift)
    if clip is not None:
        lo, hi = (torch.tensor(v, dtype=torch.float32, device=x.device)
                  for v in (-clip, clip))
        r = min_ordered(max_ordered(r, lo), hi)
    return r.to(x.dtype)


def _lib():
    fn = _build.library("alu").alu_launch
    if fn.argtypes is None:
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [vp, vp, vp, ctypes.c_longlong, i, i, f, f, i, f, f,
                       i, i, i, vp]
        fn.restype = ctypes.c_int
    return fn


def _empty_at(x: torch.Tensor, misalign: int) -> torch.Tensor:
    """An empty tensor of x's shape, dtype and device whose data pointer
    lies ``misalign`` bytes past a 16-byte boundary, as x's does."""
    if not misalign:
        return torch.empty(x.shape, dtype=x.dtype, device=x.device)
    n, size = x.numel(), x.element_size()
    buf = torch.empty(n + 16 // size, dtype=x.dtype, device=x.device)
    off = (misalign - buf.data_ptr()) % 16 // size
    return buf[off:off + n].view(x.shape)


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
    mis = x.data_ptr() % 16
    if y is not None:
        y = y.contiguous()
        if y.data_ptr() % 16 != mis:
            y = _empty_at(x, mis).copy_(y)
    out = _empty_at(x, mis)
    lo, hi = (0.0, 0.0) if clip is None else (-clip, clip)
    head, _, _, blocks, tail = alu_plan(x.numel(), x.element_size(), mis)
    status = _lib()(x.data_ptr(), None if y is None else y.data_ptr(),
                    out.data_ptr(), x.numel(), code, OPS.index(op), imm,
                    2.0 ** -shift, clip is not None, lo, hi, head, blocks,
                    tail, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(status, "alu")
    count_launch(LAUNCHES, "alu")
    return out
