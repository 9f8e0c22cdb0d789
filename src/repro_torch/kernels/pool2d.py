"""NHWC pooling with a selectable pad value: CUDA kernel + plain version.

Replaces ``repro/kernels/pool2d.py::pool2d``: x (B, H, W, C), a k x k window
at stride ``stride`` over the input padded by ``pad`` on both spatial sides.
``max`` pads with -inf and orders -0 < +0 as ``jnp.maximum`` does; ``avg``
pads with 0, sums the k*k taps in f32 in tap order from -0.0 (IEEE
addition's identity, so the sum is the reference's, which starts from the
first tap) and divides by k*k everywhere (padding counts), as XLA compiles
the reference's division: a multiply by the f32 reciprocal. The result is in
x's dtype. ``pool2d`` launches ``csrc/pool2d.cu`` for CUDA tensors (f32 or
bf16) and counts the launch in ``LAUNCHES["pool2d"]``; for CPU tensors it
takes ``pool2d_plain``, which runs on either device and agrees with the
kernel bit for bit.

The kernel gives each block an output tile of one image, TH rows x TW
columns x G channel groups, whose input halo it stages once in shared
memory. ``pool_plan`` picks the tile from the shape alone, so the CPU tests
can hold its coverage, its shared-memory budget and its grid; the tiles of
the windows the models use are compiled in (``POOL_TILES``, passed to the
kernel as macros by ``nvcc_defines``).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import _build, count_launch
from repro_torch.kernels.alu import max_ordered

LAUNCHES = {"pool2d": 0}
MODES = ("max", "avg")

THREADS = 256                # most threads a block of csrc/pool2d.cu
SMEM_BUDGET = 48 * 1024      # halo bytes a block the plan aims under
MAX_SMEM = 232448            # a block's shared memory on the H100
WAVE = 132                   # blocks that give every SM of the H100 one
# the compiled windows: kind -> (k, stride, th, tw), the output tile of a
# block in rows and columns. "k7g" is the 7x7 global pool (one output
# pixel, so its stride is never read); a window of no kind takes the
# kernel's run-time instance, "any", with a tile the plan cuts to fit. At
# k3 s2 (ResNet-18's pool1), 4 x 8 did as well as any tile tried on the
# H100 (2 x 8 and 4 x 4 as well; 2 x 16 and 8 x 8 slower).
POOL_TILES = {"k2s2": (2, 2, 4, 8), "k3s2": (3, 2, 4, 8),
              "k3s1": (3, 1, 8, 8), "k7g": (7, 1, 1, 1)}
KINDS = (*POOL_TILES, "any")


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


def avg_scale(k: int) -> float:
    """The f32 reciprocal of k*k, by which avg multiplies its sum: XLA
    rewrites the reference's ``acc / (k * k)`` into a multiply by it (the
    compiled HLO holds a ``multiply``), which differs from a true division
    in the last bit for k*k not a power of two."""
    return float(np.float32(1.0) / np.float32(k * k))


def pool2d_plain(x: torch.Tensor, *, k: int, stride: int, pad: int = 0,
                 mode: str = "max") -> torch.Tensor:
    """Plain version: pad in f32 with the mode's fill, then fold the taps in
    dy-major order, max by ``max_ordered`` from -inf, avg by ``+`` from
    -0.0 and a multiply by ``avg_scale(k)``."""
    oh, ow = _out_hw(x, k, stride, pad, mode)
    b, h, w, c = x.shape
    fill = float("-inf") if mode == "max" else 0.0
    xp = torch.full((b, h + 2 * pad, w + 2 * pad, c), fill,
                    dtype=torch.float32, device=x.device)
    xp[:, pad:pad + h, pad:pad + w] = x.to(torch.float32)
    acc = torch.full((b, oh, ow, c), float("-inf") if mode == "max" else -0.0,
                     dtype=torch.float32, device=x.device)
    for dy in range(k):
        for dx in range(k):
            sub = xp[:, dy:dy + stride * oh:stride, dx:dx + stride * ow:stride]
            acc = max_ordered(acc, sub) if mode == "max" else acc + sub
    if mode == "avg":
        acc = acc * torch.tensor(avg_scale(k), device=x.device)
    return acc.to(x.dtype)


class PoolPlan(NamedTuple):
    """The launch of ``csrc/pool2d.cu`` for one shape: instance ``kind``
    (an index into ``KINDS``); an output tile of ``th`` x ``tw`` pixels x
    ``groups`` channel groups of ``vec`` channels a block (``vec`` 16 bytes
    of channels, or 1: the scalar path); ``threads`` a block; ``smem``
    bytes of halo; the grid ``tiles_h`` x ``tiles_w`` x ``chunks`` a
    batch image."""
    kind: int
    th: int
    tw: int
    vec: int
    groups: int
    threads: int
    smem: int
    tiles_h: int
    tiles_w: int
    chunks: int


def halo_hw(th: int, tw: int, k: int, stride: int) -> tuple:
    """Rows and columns of the input halo of a th x tw output tile."""
    return (th - 1) * stride + k, (tw - 1) * stride + k


def plan_smem(th: int, tw: int, k: int, stride: int, groups: int,
              group_bytes: int) -> int:
    """Shared-memory bytes of a block as csrc/pool2d.cu lays them out: the
    halo, [row][column][group], ``group_bytes`` a group."""
    hh, hw = halo_hw(th, tw, k, stride)
    return hh * hw * groups * group_bytes


def kind_groups(kind: str) -> int:
    """The most 16-byte channel groups a block of a compiled kind takes:
    the largest power of two whose outputs fit ``THREADS`` threads and
    whose halo fits ``SMEM_BUDGET``."""
    k, s, th, tw = POOL_TILES[kind]
    g = 1
    while (2 * g * th * tw <= THREADS
           and plan_smem(th, tw, k, s, 2 * g, 16) <= SMEM_BUDGET):
        g *= 2
    return g


def nvcc_defines() -> tuple:
    """``csrc/pool2d.cu``'s macros, one a number (nvcc splits a macro's
    value at commas): ``POOL_THREADS`` and, for each compiled kind,
    ``POOL_<KIND>_<K|S|TH|TW|GMAX|SMEM>``: its ``POOL_TILES`` entry, the
    most groups a block (``kind_groups``) and their halo bytes."""
    flags = [f"-DPOOL_THREADS={THREADS}"]
    for kind, (k, s, th, tw) in POOL_TILES.items():
        g = kind_groups(kind)
        flags += [f"-DPOOL_{kind.upper()}_{key}={value}" for key, value in (
            ("K", k), ("S", s), ("TH", th), ("TW", tw), ("GMAX", g),
            ("SMEM", plan_smem(th, tw, k, s, g, 16)))]
    return tuple(flags)


def pool_kind(k: int, stride: int, oh: int, ow: int) -> str:
    """The kernel instance of a window: the global 7x7 pool, a compiled
    (k, stride), or "any" (k and stride at run time)."""
    if oh == ow == 1 and k == 7:
        return "k7g"
    return next((kind for kind, (kk, s, _, _) in POOL_TILES.items()
                 if kind != "k7g" and (kk, s) == (k, stride)), "any")


def pool_plan(batch: int, h: int, w: int, c: int, k: int, stride: int,
              pad: int, oh: int, ow: int, itemsize: int,
              misalign_bytes: int) -> PoolPlan:
    """The tile of ``csrc/pool2d.cu`` for one shape, from the shape alone.

    - vec: 16 bytes of channels a group (4 f32 or 8 bf16) where C is a
      multiple of it and x lies on a 16-byte boundary, else 1 channel (the
      scalar path);
    - th x tw: the kind's tile (``POOL_TILES``); "any" starts from 4 x 8
      cut to the output and halves its larger side while a one-group halo
      overflows ``SMEM_BUDGET``;
    - groups: a power of two, at most ``THREADS / (th * tw)``, no more than
      C needs, and fewer while the halo overflows ``SMEM_BUDGET``; for a
      global pool (oh = ow = 1) also fewer until the grid gives every SM a
      block (``WAVE``) or one group is left;
    - threads: one per output of the tile, rounded up to whole warps; a
      global pool's block takes at least a warp per four halo vectors of
      each group, up to ``THREADS``, so its copies are issued together.
    Raises where even a one-pixel, one-group halo overflows the card's
    shared memory (a window of more than about 120 x 120)."""
    if itemsize not in (2, 4) or misalign_bytes % itemsize:
        raise ValueError(f"pool2d: item size {itemsize}, misalignment "
                         f"{misalign_bytes}")
    vec = 16 // itemsize
    if c % vec or misalign_bytes % 16:
        vec = 1
    gbytes = vec * itemsize
    kind = pool_kind(k, stride, oh, ow)
    if kind == "any":
        th, tw = min(4, oh), min(8, ow)
        while plan_smem(th, tw, k, stride, 1, gbytes) > SMEM_BUDGET and \
                th * tw > 1:
            if tw >= th:
                tw = -(-tw // 2)
            else:
                th = -(-th // 2)
    else:
        th, tw = POOL_TILES[kind][2:]
    cg = -(-c // vec)                        # channel groups of a pixel
    g = 1
    while 2 * g * th * tw <= THREADS and g < cg:
        g *= 2
    while g > 1 and plan_smem(th, tw, k, stride, g, gbytes) > SMEM_BUDGET:
        g //= 2
    if kind == "k7g":
        while g > 1 and batch * -(-cg // g) < WAVE:
            g //= 2
    smem = plan_smem(th, tw, k, stride, g, gbytes)
    if smem > MAX_SMEM:
        raise ValueError(f"pool2d: a {k}x{k} window overflows the "
                         f"{MAX_SMEM} bytes of shared memory of a block")
    threads = -(-th * tw * g // 32) * 32
    if kind == "k7g":
        hh, hw = halo_hw(th, tw, k, stride)
        threads = max(threads, min(THREADS, -(-hh * hw * g // 4 // 32) * 32))
    return PoolPlan(KINDS.index(kind), th, tw, vec, g, threads, smem,
                    -(-oh // th), -(-ow // tw), -(-cg // g))


def _lib():
    fn = _build.library("pool2d").pool2d_launch
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp] + [i] * 11 + [i] * 10 + [vp]
        fn.restype = ctypes.c_int
    return fn


def pool2d(x: torch.Tensor, *, k: int, stride: int, pad: int = 0,
           mode: str = "max") -> torch.Tensor:
    """The kernel's wrapper: CUDA tensors launch ``csrc/pool2d.cu`` with the
    tile of ``pool_plan``; CPU tensors take ``pool2d_plain``. A view off a
    16-byte boundary is taken as it is, on the scalar path. Raises on
    anything the kernel does not take."""
    oh, ow = _out_hw(x, k, stride, pad, mode)
    if not _build.on_card("pool2d", x):
        return pool2d_plain(x, k=k, stride=stride, pad=pad, mode=mode)
    code = _build.float_code("pool2d", x)
    x = x.contiguous()
    b, h, w, c = x.shape
    plan = pool_plan(b, h, w, c, k, stride, pad, oh, ow, x.element_size(),
                     x.data_ptr() % 16)
    out = torch.empty((b, oh, ow, c), dtype=x.dtype, device=x.device)
    status = _lib()(x.data_ptr(), out.data_ptr(), b, h, w, c, k, stride, pad,
                    oh, ow, code, MODES.index(mode), *plan,
                    torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(status, "pool2d")
    count_launch(LAUNCHES, "pool2d")
    return out
