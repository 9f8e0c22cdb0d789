"""NHWC depthwise convolution: CUDA kernel + plain version.

Replaces ``repro/kernels/depthwise.py::depthwise_conv``: x (B, H, W, C), w
(KH, KW, C), zero padding ``pad`` on both spatial sides, stride ``stride``;
f32 accumulation of the KH*KW taps in dy-major order contracted as XLA
contracts the reference on the CPU (``depthwise_plain``), no bias, the
result in x's dtype. ``depthwise_conv`` launches ``csrc/depthwise.cu``
for CUDA tensors (f32 or bf16, w of x's dtype) and counts the launch in
``LAUNCHES["depthwise"]``; for CPU tensors it takes ``depthwise_plain``, which
repeats the reference's compiled order step by step (fused multiply-adds
by ``torch.addcmul``) and runs on either device. The two agree bit for bit,
and with the JAX package's compiled reference on the CPU.

The kernel gives each block an output tile of one image, TH rows x TW
columns x CB channels, whose input halo it stages once in shared memory;
``depthwise_plan`` picks the tile from the layer's shape alone, so the CPU
tests can hold its coverage and its shared-memory budget.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, count_launch

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
    """Plain version: pad in f32, then the taps in dy-major order as XLA's
    CPU build of the reference contracts them (its zero seed folded away):
    ``addcmul(x1 * w1, x0, w0)`` for taps 0 and 1, a fused multiply-add
    ``fma(x0, w0, round(x1 * w1))``, then ``out = addcmul(out, x_k, w_k)``
    for each later tap; a 1x1 window is the bare product. ``torch.addcmul``
    rounds once, as XLA's ``vfmadd`` does, on the CPU and on the card
    alike (the same bits on 2^20 random f32 triples on the H100)."""
    oh, ow = _out_hw(x, w, stride, pad)
    b, h, wd, c = x.shape
    kh, kw, _ = w.shape
    xp = torch.zeros((b, h + 2 * pad, wd + 2 * pad, c), dtype=torch.float32,
                     device=x.device)
    xp[:, pad:pad + h, pad:pad + wd] = x.to(torch.float32)
    wf = w.to(torch.float32)
    taps = [(xp[:, dy:dy + stride * oh:stride, dx:dx + stride * ow:stride],
             wf[dy, dx]) for dy in range(kh) for dx in range(kw)]
    if len(taps) == 1:
        return (taps[0][0] * taps[0][1]).to(x.dtype)
    (x0, w0), (x1, w1) = taps[:2]
    out = torch.addcmul(x1 * w1, x0, w0)
    for sub, wt in taps[2:]:
        out = torch.addcmul(out, sub, wt)
    return out.to(x.dtype)


SMEM_BUDGET = 48 * 1024  # halo and weights of one block, csrc/depthwise.cu
RUN = 4                  # outputs along W a thread computes
MAX_THREADS = 256


def halo_hw(th: int, tw: int, kh: int, kw: int, stride: int) -> tuple:
    """Rows and columns of the input halo of a th x tw output tile."""
    return (th - 1) * stride + kh, (tw - 1) * stride + kw


def plan_smem(th: int, tw: int, cb: int, kh: int, kw: int, stride: int,
              esize: int) -> int:
    """Shared-memory bytes of a block, as csrc/depthwise.cu lays them out:
    up to 128 bytes to align the halo for TMA, the halo in x's type rounded
    up to 16 bytes, then the weights in f32."""
    hh, hw = halo_hw(th, tw, kh, kw, stride)
    return 128 + -(-hh * hw * cb * esize // 16) * 16 + kh * kw * cb * 4


# (stride 1, vec) -> the output tile (th, tw) of csrc/depthwise.cu
_TILES = {(True, 4): (8, 16), (True, 8): (16, 16), (True, 1): (2, 16),
          (False, 4): (4, 8), (False, 8): (16, 8), (False, 1): (4, 8)}


def depthwise_plan(h: int, w: int, c: int, kh: int, kw: int, stride: int,
                   pad: int, dtype: torch.dtype) -> tuple:
    """(th, tw, cb, vec): the output tile of csrc/depthwise.cu for one layer.
    vec channels a thread: 16 bytes (4 in f32, 8 in bf16) where C is a
    multiple of it, else 1 (the scalar path); cb = 32 channels a block (all
    of C below 32); th x tw outputs from ``_TILES`` by stride and vec, cut
    to the output's size, and fewer rows while the halo and weights
    overflow ``SMEM_BUDGET``. The f32 tiles, 8 x 16 at stride 1 and 4 x 8
    at stride 2 (whose halo is 4x its output), did best across the
    MobileNet-1.0 layers of their stride in a sweep of tiles on the H100;
    bf16 (whose threads take twice the channels) and the scalar path keep
    about as many threads a block."""
    oh = (h + 2 * pad - kh) // stride + 1
    ow = (w + 2 * pad - kw) // stride + 1
    esize = 2 if dtype == torch.bfloat16 else 4
    vec = 16 // esize if c % (16 // esize) == 0 else 1
    cb = min(c, 32)
    th, tw = _TILES[stride == 1, vec]
    th, tw = min(th, oh), min(tw, -(-ow // RUN) * RUN)
    while th > 1 and plan_smem(th, tw, cb, kh, kw, stride,
                               esize) > SMEM_BUDGET:
        th -= 1
    if plan_smem(th, tw, cb, kh, kw, stride, esize) > SMEM_BUDGET:
        raise ValueError(f"depthwise_conv: a {kh}x{kw} kernel at stride "
                         f"{stride} overflows {SMEM_BUDGET} bytes of shared "
                         f"memory")
    return th, tw, cb, vec


def _lib():
    fn = _build.library("depthwise").depthwise_launch
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp] + [i] * 15 + [vp]
        fn.restype = ctypes.c_int
    return fn


def depthwise_conv(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
                   pad: int = 0) -> torch.Tensor:
    """The kernel's wrapper: CUDA tensors launch ``csrc/depthwise.cu`` with
    the tile of ``depthwise_plan``; CPU tensors take ``depthwise_plain``.
    Raises on anything the kernel does not take."""
    oh, ow = _out_hw(x, w, stride, pad)
    if not _build.on_card("depthwise_conv", x, w):
        return depthwise_plain(x, w, stride=stride, pad=pad)
    code = _build.float_code("depthwise_conv", x, w)
    x = _build.aligned(x)
    w = w.contiguous()
    b, h, wd, c = x.shape
    kh, kw, _ = w.shape
    plan = depthwise_plan(h, wd, c, kh, kw, stride, pad, x.dtype)
    out = torch.empty((b, oh, ow, c), dtype=x.dtype, device=x.device)
    status = _lib()(x.data_ptr(), w.data_ptr(), out.data_ptr(), b, h, wd, c,
                    kh, kw, stride, pad, oh, ow, code, *plan,
                    torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(status, "depthwise_conv")
    count_launch(LAUNCHES, "depthwise")
    return out
