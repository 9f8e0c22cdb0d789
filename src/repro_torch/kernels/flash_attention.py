"""Online-softmax attention (GQA, causal/sliding-window mask, logit softcap):
CUDA kernels + plain versions.

Replaces ``repro/kernels/flash_attention.py::flash_attention``: q (B, H, Sq,
D), k and v (B, KV, Sk, D) with H a multiple of KV; q-head ``h`` reads
kv-head ``h // (H // KV)``. The rules, as the reference has them:

- scores ``s = (q * scale) @ k^T`` in f32, with q widened and scaled first
  (default scale ``D ** -0.5``); with a softcap, ``s = softcap *
  tanh(s / softcap)``, before the mask;
- the mask is aligned bottom-right: ``qpos = i + (Sk - Sq)``; ``causal``
  keeps ``kpos <= qpos``, ``window`` keeps ``kpos > qpos - window`` (also
  without ``causal``); masked scores are ``NEG_INF = -2e38``;
- per key block: ``m_new = max(m, rowmax(s))``, ``p = exp(s - m_new)`` then
  ``p = where(mask, p, 0)``, ``corr = exp(min(m - m_new, 0))``, ``l = l *
  corr + rowsum(p)``, ``acc = acc * corr + p @ v``;
- ``out = acc / max(l, 1e-30)`` in q's dtype. A row that sees no key gives
  0 (``kernels/ref.py::attention_ref`` gives the mean of v there instead).

``flash_attention`` takes one of three routes for CUDA tensors (f32 or bf16,
D a multiple of 8 up to 256), by a fixed rule on the query length and dtype
(``attention_route``):

- ``"decode"``, Sq <= ``DECODE_ROWS``, f32 and bf16: ``csrc/flash_decode.cu``
  splits the keys into chunks (``decode_split``), one block per (batch, kv
  head, chunk) for all the GQA group's rows, writes a partial (m, l, acc)
  per row and chunk, and a second kernel combines them;
  ``flash_decode_plain`` is the same decomposition in PyTorch;
- ``"mma"``, Sq > ``DECODE_ROWS`` in bf16: ``csrc/flash_attention_mma.cu``
  on the tensor cores (``mma.sync`` m16n8k16, P split as bf16 hi + lo);
- ``"tf32x3"``, Sq > ``DECODE_ROWS`` in f32: ``csrc/flash_attention.cu`` on
  the tensor cores (``mma.sync`` m16n8k8 TF32), every operand split as TF32
  hi + lo and each product taken as lo.hi + hi.lo + hi.hi (one TF32 term
  would round q and k to 10 mantissa bits, far over the f32 limit); its tile
  is ``attention_tf32_plan``'s, and ``tf32_split_plain`` is the split in
  PyTorch, for the CPU tests.

Each call counts one in ``LAUNCHES["flash_attention"]``, once its route's
first kernel has launched. Each kernel counts its own launches, where it
launches: ``LAUNCHES["flash_attention.<route>"]`` for the route's kernel, and
``LAUNCHES["flash_attention_combine"]`` for the decode route's combine. For CPU tensors the
wrapper takes ``flash_attention_plain``, which runs on either device.

Gradient. ``flash_attention`` is the registered op
``repro_torch::flash_attention`` (``attention_op``), with an autograd
formula: its forward is the wrapper above (``attention_forward``: the
kernels on CUDA tensors, the plain version on CPU tensors), and its
backward, the op ``repro_torch::flash_attention_backward``, is
``flash_attention_backward``, plain PyTorch on either device, so that the
CPU tests run the backward the card runs. The reference has no
backward kernel either: XLA differentiates its chunked softmax. Without a
graph to build (``torch.inference_mode``, ``torch.no_grad``, or inputs
that need no gradient) the forward is all that runs, with nothing saved.

Registration. Both ops have a fake implementation (the output's shape
only: the kernels hold no S x S scores, so a dry-run counts none), a flop
formula (``attention_flops``) and a DTensor sharding rule
(``attention_strategies``, through ``register_sharding``; all in
``_register``):
batch and heads shard, seq and head_dim stay whole. A DTensor runs each
rank's shard through the same op, on the kernels on the card.

Blocks. ``block_q``/``block_k`` have the reference's meaning for the plain
version, halved until they divide Sq and Sk; without them it takes the
kernel's tile (``attention_tile``). The CUDA kernels pick their tiles
themselves and ignore them: they mask their own tails instead of halving, so
on the card the blocks change only the order of summation, as ``tile=``
does for ``ops.gemm``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build, count_launch

ROUTES = ("decode", "mma", "tf32x3")
LAUNCHES = {"flash_attention": 0, "flash_attention_combine": 0,
            **{f"flash_attention.{r}": 0 for r in ROUTES}}
NEG_INF = -2.0e38
MAX_HEAD_DIM = 256
DECODE_ROWS = 8            # query rows up to which the decode route runs
DECODE_BLOCKS = 8 * 132    # decode grid size aimed at: ~8 blocks per H100 SM
DECODE_MIN_CHUNK = 256     # keys per decode chunk, at least


def attention_route(dtype: torch.dtype, sq: int) -> str:
    """The route a CUDA call takes: ``"decode"`` for Sq <= ``DECODE_ROWS``,
    else ``"mma"`` in bf16 and ``"tf32x3"`` in f32."""
    if sq <= DECODE_ROWS:
        return "decode"
    return "mma" if dtype == torch.bfloat16 else "tf32x3"


def tf32_head_class(head_dim: int) -> int:
    """The f32 prefill kernel's head-dim class: head_dim rounded up to 16,
    32, 64, 128 or 256. Each class is one template instance, whose loops
    over the head dimension have fixed trip counts."""
    return next(x for x in (16, 32, 64, 128, 256) if head_dim <= x)


# The f32 prefill kernel's tile per head-dim class: (warps, rows_per_warp,
# bk, q_tiles), q_tiles 2 where Q is staged as TF32 hi and lo tiles, 1
# where it is staged scaled f32 and split at fragment load. The build hands
# this table to csrc/flash_attention.cu as its template instances
# (``nvcc_defines``), so it is written here only.
TF32_TILES = {16: (4, 32, 64, 2), 32: (4, 32, 64, 2), 64: (8, 16, 64, 2),
              128: (8, 16, 64, 1), 256: (8, 16, 16, 1)}
TF32_STAGES = 2


def attention_tf32_plan(head_dim: int) -> tuple:
    """(warps, rows_per_warp, bk, stages, smem_bytes): the tile of the f32
    prefill kernel ``csrc/flash_attention.cu`` at ``head_dim``, its
    ``TF32_TILES`` entry for ``tf32_head_class(head_dim)``. A warp owns
    ``rows_per_warp`` query rows (16-row MMA tiles), a block ``warps`` of
    them; K and V stream in tiles of ``bk`` keys through a ring of
    ``stages``. Rows are zero-padded to the class and then by 4 floats in
    shared memory; Q is staged there as TF32 hi and lo tiles up to class 64,
    scaled f32 above it. From class 64 a warp takes one 16-row tile (its O
    accumulator and scores fill the registers); at class 256 Q takes 133 KB
    of shared memory, so BK is 16."""
    dp = tf32_head_class(head_dim)
    warps, rows, bk, q_tiles = TF32_TILES[dp]
    smem = (q_tiles * warps * rows + 2 * TF32_STAGES * bk) * (dp + 4) * 4
    return warps, rows, bk, TF32_STAGES, smem


def nvcc_defines() -> tuple:
    """``csrc/flash_attention.cu``'s macros, one a number (nvcc splits a
    macro's value at commas): ``TF32_STAGES`` and, for each class ``dp``,
    ``TF32_<WARPS|ROWS|BK|QTILES|SMEM>_<dp>``, the ``TF32_TILES`` entry and
    ``attention_tf32_plan``'s shared bytes; each class is an instance of
    the kernel."""
    flags = [f"-DTF32_STAGES={TF32_STAGES}"]
    for dp, (warps, rows, bk, q_tiles) in TF32_TILES.items():
        smem = attention_tf32_plan(dp)[4]
        flags += [f"-DTF32_{key}_{dp}={value}" for key, value in (
            ("WARPS", warps), ("ROWS", rows), ("BK", bk),
            ("QTILES", q_tiles), ("SMEM", smem))]
    return tuple(flags)


def tf32_split_plain(x: torch.Tensor) -> tuple:
    """(hi, lo) of f32 ``x`` as the f32 prefill kernel splits it: hi = x
    rounded to TF32 (10 mantissa bits; to nearest, ties away from zero, as
    ``cvt.rna.tf32.f32``), lo = x - hi (exact in f32) rounded the same way.
    x - hi - lo is at most 2^-22 |x|. Bit operations on the low 13 bits."""
    def rna(t):
        bits = t.contiguous().view(torch.int32)
        finite = (bits & 0x7F800000) != 0x7F800000
        up = (bits + 0x1000) & -8192       # add half of the dropped ulp
        return torch.where(finite, up, bits).view(torch.float32)
    hi = rna(x.to(torch.float32))
    return hi, rna(x.to(torch.float32) - hi)


def decode_split(b: int, kv: int, g: int, sq: int, sk: int,
                 window: Optional[int]) -> tuple:
    """(rt, kbeg, chunk, chunks): how the decode route cuts its work. A block
    takes ``rt`` (1, 2, 4 or 8) of the ``g * sq`` rows of a GQA group and the
    keys ``[kbeg + c * chunk, ...)`` of chunk ``c``, up to Sk: the keys that
    any row sees (a causal mask only cuts keys past the last row, which is
    the last key, so the split does not depend on it). The chunk, a multiple
    of 64 keys and at least ``DECODE_MIN_CHUNK``, is picked so that the grid
    holds about ``DECODE_BLOCKS`` blocks."""
    rows = g * sq
    rt = next((r for r in (1, 2, 4) if rows <= r), 8)
    slices = -(-rows // rt)
    kbeg = 0 if window is None else max(0, sk - sq - int(window) + 1)
    span = max(sk - kbeg, 0)
    want = max(1, -(-DECODE_BLOCKS // (b * kv * slices)))
    chunk = max(DECODE_MIN_CHUNK, -(-span // want))
    chunk = -(-chunk // 64) * 64
    return rt, kbeg, chunk, max(1, -(-span // chunk))


def attention_tile(head_dim: int, dtype: torch.dtype, sq: int) -> tuple:
    """(bq, bk): the plain version's default block. For f32 at Sq > 8 it is
    the tile of the kernel ``csrc/flash_attention.cu`` (``attention_tf32_plan``:
    its query rows a block and its key tile); else 64 query rows, or 8 when
    ``sq <= 8``, and 64 keys, or 32 for rows of more than 512 bytes. Only
    the plain version's order of summation depends on it."""
    if dtype == torch.float32 and sq > DECODE_ROWS:
        warps, rows, bk, _, _ = attention_tf32_plan(head_dim)
        return warps * rows, bk
    bq = 8 if sq <= 8 else 64
    itemsize = torch.empty((), dtype=dtype).element_size()
    bk = 64 if head_dim * itemsize <= 512 else 32
    return bq, bk


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> tuple:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash_attention takes q (B, H, Sq, D) and k, v "
                         f"(B, KV, Sk, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must be ({b}, KV, Sk, {d})")
    if min(b, h, sq, d, kv, sk) < 1 or h % kv:
        raise ValueError(f"flash_attention: H {h} must be a multiple of KV "
                         f"{kv}, and no dimension may be empty")
    if d % 8 or d > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head_dim {d} must be a multiple "
                         f"of 8 up to {MAX_HEAD_DIM}")
    return b, h, sq, d, kv, sk


def _blocks(sq: int, sk: int, block_q: Optional[int],
            block_k: Optional[int], tile: tuple) -> tuple:
    """The reference's rule: the requested (or default) block, capped at the
    length and halved until it divides it."""
    bq = min(block_q or tile[0], sq)
    bk = min(block_k or tile[1], sk)
    while sq % bq:
        bq //= 2
    while sk % bk:
        bk //= 2
    return max(bq, 1), max(bk, 1)


def _key_mask(qpos: torch.Tensor, kpos: torch.Tensor, causal: bool,
              window: Optional[int]) -> torch.Tensor:
    mask = torch.ones((qpos.shape[0], kpos.shape[1]), dtype=torch.bool,
                      device=qpos.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: Optional[int] = None,
                          softcap: Optional[float] = None,
                          scale: Optional[float] = None,
                          block_q: Optional[int] = None,
                          block_k: Optional[int] = None) -> torch.Tensor:
    """Plain version: the reference's key-block loop, step by step, over all
    (B, H) at once. q is viewed as (B, KV, G, Sq, D) against k and v as
    (B, KV, 1, Sk, D), so K and V are never repeated per q-head. Query rows
    are independent in the reference's loop, so its q blocks only group
    rows: all Sq rows run at once, and ``block_q`` changes no result."""
    b, h, sq, d, kv, sk = _check(q, k, v)
    _, bk = _blocks(sq, sk, block_q, block_k,
                    attention_tile(d, q.dtype, sq))
    scale = d ** -0.5 if scale is None else scale
    dev = q.device
    qs = q.to(torch.float32).reshape(b, kv, h // kv, sq, d) * scale
    qpos = torch.arange(sq, device=dev).view(sq, 1) + (sk - sq)
    m = torch.full((b, kv, h // kv, sq, 1), NEG_INF, dtype=torch.float32,
                   device=dev)
    l_ = torch.zeros_like(m)
    acc = torch.zeros((b, kv, h // kv, sq, d), dtype=torch.float32,
                      device=dev)
    for j in range(0, sk, bk):
        kb = k[:, :, j:j + bk].to(torch.float32).unsqueeze(2)
        vb = v[:, :, j:j + bk].to(torch.float32).unsqueeze(2)
        s = torch.matmul(qs, kb.transpose(-1, -2))
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        mask = _key_mask(qpos, torch.arange(j, j + bk, device=dev).view(1, bk),
                         causal, window)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.where(mask, torch.exp(s - m_new), 0.0)
        corr = torch.exp(torch.clamp(m - m_new, max=0.0))
        l_ = l_ * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.matmul(p, vb)
        m = m_new
    out = acc / torch.clamp(l_, min=1e-30)
    return out.reshape(b, h, sq, d).to(q.dtype)


def decode_partials_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          split: tuple, *, causal: bool = True,
                          window: Optional[int] = None,
                          softcap: Optional[float] = None,
                          scale: Optional[float] = None) -> tuple:
    """Plain version of the decode route's first kernel: for each query row
    and key chunk of ``split`` (``decode_split``'s tuple), the chunk's
    (m, l, acc) in f32, shaped (B, H, Sq, chunks) and (B, H, Sq, chunks, D).
    A chunk is one key block of the reference's loop: m = max of its visible
    scores (``NEG_INF`` if none), p = exp(s - m) zeroed where masked, l =
    rowsum p, acc = p @ v."""
    b, h, sq, d, kv, sk = _check(q, k, v)
    _, kbeg, chunk, chunks = split
    scale = d ** -0.5 if scale is None else scale
    dev = q.device
    qs = q.to(torch.float32).reshape(b, kv, h // kv, sq, d) * scale
    qpos = torch.arange(sq, device=dev).view(sq, 1) + (sk - sq)
    ms, ls, accs = [], [], []
    for c in range(chunks):
        j = kbeg + c * chunk
        e = max(j, min(j + chunk, sk))
        kb = k[:, :, j:e].to(torch.float32).unsqueeze(2)
        vb = v[:, :, j:e].to(torch.float32).unsqueeze(2)
        s = torch.matmul(qs, kb.transpose(-1, -2))
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        mask = _key_mask(qpos, torch.arange(j, e, device=dev).view(1, -1),
                         causal, window)
        s = torch.where(mask, s, NEG_INF)
        m = torch.full(s.shape[:-1] + (1,), NEG_INF, dtype=torch.float32,
                       device=dev)
        if e > j:
            m = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.where(mask, torch.exp(s - m), 0.0)
        ms.append(m)
        ls.append(p.sum(dim=-1, keepdim=True))
        accs.append(torch.matmul(p, vb))
    m = torch.cat(ms, dim=-1).reshape(b, h, sq, chunks)
    l_ = torch.cat(ls, dim=-1).reshape(b, h, sq, chunks)
    acc = torch.stack(accs, dim=-2).reshape(b, h, sq, chunks, d)
    return m, l_, acc


def decode_combine_plain(m: torch.Tensor, l_: torch.Tensor,
                         acc: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Plain version of the decode route's combine kernel: ``out = sum_i
    e^{m_i - M} acc_i / max(sum_i e^{m_i - M} l_i, 1e-30)``, M = max_i m_i,
    in ``dtype``. A chunk that saw no key (m_i = NEG_INF, l_i = 0, acc_i =
    0) adds exactly 0; a row that saw none is exactly 0."""
    w = torch.exp(m - m.amax(dim=-1, keepdim=True))
    den = torch.clamp((w * l_).sum(dim=-1, keepdim=True), min=1e-30)
    return ((w.unsqueeze(-1) * acc).sum(dim=-2) / den).to(dtype)


def flash_decode_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       causal: bool = True, window: Optional[int] = None,
                       softcap: Optional[float] = None,
                       scale: Optional[float] = None,
                       split: Optional[tuple] = None) -> torch.Tensor:
    """The decode route's decomposition in PyTorch: partials per key chunk,
    then the combine. ``split`` defaults to the kernel's own
    (``decode_split``)."""
    b, h, sq, d, kv, sk = _check(q, k, v)
    if split is None:
        split = decode_split(b, kv, h // kv, sq, sk, window)
    m, l_, acc = decode_partials_plain(q, k, v, split, causal=causal,
                                       window=window, softcap=softcap,
                                       scale=scale)
    return decode_combine_plain(m, l_, acc, q.dtype)


def _fn(source: str, name: str, argtypes: list):
    fn = getattr(_build.library(source), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


_VP, _I, _F, _LL = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                    ctypes.c_longlong)
# q, k, v, o, B, H, KV, Sq, Sk, D, causal, has_window, window, has_softcap,
# softcap, scale
_PREFILL_ARGS = [_VP] * 4 + [_I] * 8 + [_LL, _I, _F, _F]


def decode_combine(part_m: torch.Tensor, part_l: torch.Tensor,
                   part_acc: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The decode route's combine: partials m, l (rows, chunks) and acc
    (rows, chunks, D) in f32 to the (rows, D) output in ``dtype``. CUDA
    tensors launch ``csrc/flash_decode.cu``'s combine kernel once, counted
    in ``LAUNCHES["flash_attention_combine"]``; CPU tensors take
    ``decode_combine_plain``."""
    rows, chunks, d = part_acc.shape
    if not _build.on_card("flash_attention", part_m, part_l, part_acc):
        return decode_combine_plain(part_m, part_l, part_acc, dtype)
    code = _build.FLOAT_CODES[dtype]
    out = torch.empty((rows, d), dtype=dtype, device=part_acc.device)
    status = _fn("flash_decode", "flash_decode_combine_launch",
                 [_VP] * 4 + [_I] * 4 + [_VP])(
        part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(),
        out.data_ptr(), rows, chunks, d, code,
        torch.cuda.current_stream(out.device).cuda_stream)
    _build.check(status, "flash_attention (combine)")
    count_launch(LAUNCHES, "flash_attention_combine")
    return out


def decode_partials(q, k, v, causal, window, softcap, scale) -> tuple:
    """The decode route's first kernel on CUDA tensors: (m, l, acc) per
    query row and key chunk of ``decode_split``, in f32 scratch of shapes
    (B * H * Sq, chunks) and (B * H * Sq, chunks, D). Counts its launch in
    ``LAUNCHES["flash_attention.decode"]``."""
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    rt, kbeg, chunk, chunks = decode_split(b, kv, h // kv, sq, sk, window)
    if kv * (-(-(h // kv) * sq // rt)) > 65535:
        raise ValueError("flash_attention: KV x row slices must be at most "
                         "65535 (grid limit)")
    rows = b * h * sq
    part_m = torch.empty((rows, chunks), dtype=torch.float32, device=q.device)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((rows, chunks, d), dtype=torch.float32,
                           device=q.device)
    status = _fn("flash_decode", "flash_decode_launch",
                 [_VP] * 6 + [_I] * 8 + [_LL, _I, _F, _F] + [_I] * 5 + [_VP])(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), part_m.data_ptr(),
        part_l.data_ptr(), part_acc.data_ptr(), b, h, kv, sq, sk, d,
        int(bool(causal)), int(window is not None),
        0 if window is None else int(window), int(softcap is not None),
        0.0 if softcap is None else float(softcap), scale, rt, kbeg, chunk,
        chunks, _build.FLOAT_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(status, "flash_attention (decode)")
    count_launch(LAUNCHES, "flash_attention.decode")
    return part_m, part_l, part_acc


def attention_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: Optional[int] = None,
                      softcap: Optional[float] = None,
                      scale: Optional[float] = None,
                      block_q: Optional[int] = None,
                      block_k: Optional[int] = None) -> torch.Tensor:
    """The kernels' wrapper: CUDA tensors take the route
    ``attention_route`` names; CPU tensors take ``flash_attention_plain``.
    Raises on anything the kernels do not take, on either device. Its
    result on the card has no ``grad_fn``: ``flash_attention`` gives it
    one."""
    b, h, sq, d, kv, sk = _check(q, k, v)
    _build.float_code("flash_attention", q, k, v)
    if not _build.on_card("flash_attention", q, k, v):
        return flash_attention_plain(
            q, k, v, causal=causal, window=window, softcap=softcap,
            scale=scale, block_q=block_q, block_k=block_k)
    if h > 65535 or b > 65535:
        raise ValueError(f"flash_attention: B {b} and H {h} must be at most "
                         f"65535 (grid limits)")
    q, k, v = _build.aligned(q), _build.aligned(k), _build.aligned(v)
    scale = d ** -0.5 if scale is None else float(scale)
    route = attention_route(q.dtype, sq)
    if route == "decode":
        parts = decode_partials(q, k, v, causal, window, softcap, scale)
        count_launch(LAUNCHES, "flash_attention")
        return decode_combine(*parts, q.dtype).view(b, h, sq, d)
    out = torch.empty_like(q)
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, h, kv, sq, sk, d, int(bool(causal)),
            int(window is not None), 0 if window is None else int(window),
            int(softcap is not None),
            0.0 if softcap is None else float(softcap), scale]
    if route == "mma":
        if scale < 0:   # the kernel folds a scale >= 0 into its exponent
            q = torch.neg(q)
            args[0], args[-1] = q.data_ptr(), -scale
        fn = _fn("flash_attention_mma", "flash_attention_mma_launch",
                 _PREFILL_ARGS + [_VP])
    else:
        fn = _fn("flash_attention", "flash_attention_launch",
                 _PREFILL_ARGS + [_VP])
    _build.check(fn(*args, torch.cuda.current_stream(q.device).cuda_stream),
                 f"flash_attention ({route})")
    count_launch(LAUNCHES, "flash_attention")
    count_launch(LAUNCHES, f"flash_attention.{route}")
    return out


BACKWARD_ROWS = 256        # query rows a chunk of the backward
# the profiler range the backward runs in: what a profile of a train step
# reads the backward's device time from
BACKWARD_RANGE = "flash_attention_backward"


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, dout: torch.Tensor, *,
                             causal: bool = True,
                             window: Optional[int] = None,
                             softcap: Optional[float] = None,
                             scale: Optional[float] = None,
                             rows: int = BACKWARD_ROWS) -> tuple:
    """(dq, dk, dv) of ``flash_attention`` for the gradient ``dout`` of
    its output, in q's, k's and v's dtypes: plain PyTorch on either
    device, in f32, ``rows`` query rows at a time so that memory stays
    O(Sq x rows), as the reference's q-chunk loop keeps it.

    Per chunk it recomputes the f32 scores s = (q * scale) @ k^T over the
    keys the chunk's rows can see, the softcap c * tanh(s / c) and the
    mask, and forms P = softmax(s), dV += P^T dO and dP = dO V^T; then dS
    = P * (dP - rowsum(dO * O)), with rowsum(dO * O) taken as rowsum(P *
    dP), its value in exact arithmetic (O rounded to q's dtype would add
    its rounding); dS times the softcap's derivative 1 - tanh^2(s / c);
    dQ = scale * dS @ K and dK += dS^T @ (q * scale). dK and dV sum over
    each GQA group's query heads, to the KV heads. A row that sees no key
    gets an output of 0 from the kernels and a gradient of 0 here; such
    rows do not occur in training, where Sq = Sk and each row sees its own
    key."""
    b, h, sq, d, kv, sk = _check(q, k, v)
    g, f32, dev = h // kv, torch.float32, q.device
    scale = d ** -0.5 if scale is None else float(scale)
    qs = q.to(f32).reshape(b, kv, g, sq, d) * scale
    do = dout.to(f32).reshape(b, kv, g, sq, d)
    kf, vf = k.to(f32).unsqueeze(2), v.to(f32).unsqueeze(2)
    dq = torch.zeros_like(qs)
    dk = torch.zeros((b, kv, sk, d), dtype=f32, device=dev)
    dv = torch.zeros_like(dk)
    off = sk - sq
    for i0 in range(0, sq, rows):
        i1 = min(i0 + rows, sq)
        k0 = 0 if window is None else max(0, i0 + off - int(window) + 1)
        k1 = max(0, min(sk, i1 + off)) if causal else sk
        if k1 <= k0:
            continue
        kb, vb = kf[:, :, :, k0:k1], vf[:, :, :, k0:k1]
        qc, doc = qs[:, :, :, i0:i1], do[:, :, :, i0:i1]
        s = torch.matmul(qc, kb.transpose(-1, -2))      # (b, kv, g, c, L)
        if softcap is not None:
            t = torch.tanh(s / softcap)
            s = softcap * t
        mask = _key_mask(torch.arange(i0, i1, device=dev).view(-1, 1) + off,
                         torch.arange(k0, k1, device=dev).view(1, -1),
                         causal, window)
        s = torch.where(mask, s, NEG_INF)
        p = torch.where(mask, torch.exp(s - s.amax(dim=-1, keepdim=True)),
                        0.0)
        p = p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
        dp = torch.matmul(doc, vb.transpose(-1, -2))
        ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
        if softcap is not None:
            ds = ds * (1.0 - t * t)
        dq[:, :, :, i0:i1] = torch.matmul(ds, kb) * scale
        # one product sums over the group's heads and the chunk's rows
        dk[:, :, k0:k1] += torch.einsum("bkgcl,bkgcd->bkld", ds, qc)
        dv[:, :, k0:k1] += torch.einsum("bkgcl,bkgcd->bkld", p, doc)
    return (dq.reshape(b, h, sq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def visible_pairs(sq: int, sk: int, causal: bool,
                  window: Optional[int]) -> int:
    """The (query, key) pairs the mask keeps for one (batch, head): row i
    at position ``i + sk - sq`` sees keys ``kpos <= qpos`` (causal) and
    ``kpos > qpos - window``."""
    qpos = np.arange(sq, dtype=np.int64) + (sk - sq)
    hi = np.clip(qpos + 1, 0, sk) if causal else np.full(sq, sk, np.int64)
    lo = np.zeros(sq, np.int64) if window is None else \
        np.clip(qpos - int(window) + 1, 0, sk)
    return int(np.maximum(hi - lo, 0).sum())


def attention_flops(q_shape, k_shape, causal: bool,
                    window: Optional[int]) -> int:
    """The forward's useful FLOPs: 2 * D for q.k and 2 * D for p.v per
    visible pair and query head, ``4 * B * H * D * pairs``: for a causal
    global layer 4 * (S + 1) / 2 * H * D per token, the attention term of
    ``analysis/roofline.py::model_flops`` (S / 2 there)."""
    b, h, sq, d = q_shape
    return 4 * b * h * d * visible_pairs(sq, k_shape[2], causal, window)


def _attention_impl(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool, window: Optional[int],
                    softcap: Optional[float], scale: Optional[float],
                    block_q: Optional[int],
                    block_k: Optional[int]) -> torch.Tensor:
    """``attention_forward`` as the op ``repro_torch::flash_attention``, so
    that DTensor, meta and fake tensors see it."""
    return attention_forward(q, k, v, causal=causal, window=window,
                             softcap=softcap, scale=scale, block_q=block_q,
                             block_k=block_k)


def _attention_fake(q, k, v, causal, window, softcap, scale, block_q,
                    block_k):
    _check_fake(q, k, v)
    return q.new_empty(q.shape)


def _attention_backward_impl(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, dout: torch.Tensor,
                             causal: bool, window: Optional[int],
                             softcap: Optional[float], scale: Optional[float]
                             ) -> tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """``flash_attention_backward`` as the op
    ``repro_torch::flash_attention_backward``, inside the profiler range
    ``BACKWARD_RANGE``."""
    with torch.profiler.record_function(BACKWARD_RANGE):
        return flash_attention_backward(q, k, v, dout, causal=causal,
                                        window=window, softcap=softcap,
                                        scale=scale)


def _attention_backward_fake(q, k, v, dout, causal, window, softcap, scale):
    _check_fake(q, k, v)
    return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)


def _check_fake(q, k, v) -> None:
    """The shape checks of the kernels' wrapper, and its refusal of
    operands on more than one device."""
    _check(q, k, v)
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError(f"flash_attention: operands must lie on one CUDA "
                         f"device or on the CPU, got "
                         f"{sorted(str(t.device) for t in (q, k, v))}")


def _setup_context(ctx, inputs, output):
    q, k, v, causal, window, softcap, scale = inputs[:7]
    ctx.save_for_backward(q, k, v)
    ctx.kw = (causal, window, softcap, scale)


def _backward(ctx, dout):
    q, k, v = ctx.saved_tensors
    return torch.ops.repro_torch.flash_attention_backward(
        q, k, v, dout, *ctx.kw) + (None,) * 6


def _attention_flop(q_shape, k_shape, v_shape, causal, window, *args,
                    **kwargs) -> int:
    return attention_flops(q_shape, k_shape, causal, window)


def _attention_backward_flop(q_shape, k_shape, v_shape, dout_shape, causal,
                             window, *args, **kwargs) -> int:
    """The backward's 5 products per visible pair (the scores again, dP,
    dQ, dK, dV): 2.5 forwards. ``model_flops`` counts 2, the gradient
    alone; the half more is the scores' recompute."""
    return attention_flops(q_shape, k_shape, causal, window) * 5 // 2


def attention_strategies(q, k, n_tensors: int, n_outputs: int,
                         n_other: int) -> list:
    """The op's placements on one mesh dim, as ``register_sharding`` takes
    them: everything replicated; batch (dim 0) sharded on every tensor; or
    heads (dim 1) sharded on every tensor where every mesh dim's size
    divides KV (and so H), so that each rank's q heads read its own KV
    heads. Seq and head_dim stay whole."""
    from torch.distributed.tensor import Replicate, Shard

    def every(p):
        return [p] * n_outputs, [p] * n_tensors + [None] * n_other
    out = [every(Replicate()), every(Shard(0))]
    if all(k.shape[1] % n == 0 for n in k.mesh.shape):
        out.append(every(Shard(1)))
    return out


def _register() -> None:
    """Register the two ops, their fake implementations, autograd formula,
    flop formulas and (with ``torch.distributed``) DTensor sharding rules.
    DTensor redistributes the inputs to the cheapest strategy itself; a
    ``local_map`` would leave that to every caller."""
    lib = torch.library
    fwd = lib.custom_op("repro_torch::flash_attention",
                        mutates_args=())(_attention_impl)
    bwd = lib.custom_op("repro_torch::flash_attention_backward",
                        mutates_args=())(_attention_backward_impl)
    fwd.register_fake(_attention_fake)
    bwd.register_fake(_attention_backward_fake)
    fwd.register_autograd(_backward, setup_context=_setup_context)
    register_flop_formula(torch.ops.repro_torch.flash_attention)(
        _attention_flop)
    register_flop_formula(torch.ops.repro_torch.flash_attention_backward)(
        _attention_backward_flop)
    if torch.distributed.is_available():
        from torch.distributed.tensor.experimental import register_sharding
        register_sharding(torch.ops.repro_torch.flash_attention.default)(
            lambda q, k, v, *o: attention_strategies(q, k, 3, 1, len(o)))
        register_sharding(
            torch.ops.repro_torch.flash_attention_backward.default)(
            lambda q, k, v, dout, *o: attention_strategies(q, k, 4, 3,
                                                           len(o)))


# once per process: a copy of this module executed from its source (the
# tests plant faults so) keeps the first registration, whose functions
# call through the module's names
if not hasattr(torch.ops.repro_torch, "flash_attention"):
    _register()
attention_op = torch.ops.repro_torch.flash_attention.default


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None) -> torch.Tensor:
    """Online-softmax attention with a gradient (the op
    ``repro_torch::flash_attention``): CUDA tensors launch the kernels of
    the route ``attention_route`` names, CPU tensors take
    ``flash_attention_plain``; either way the backward is
    ``flash_attention_backward``. DTensors run the same on each rank's
    shard, by the ops' sharding rules."""
    return attention_op(q, k, v, causal, window, softcap, scale, block_q,
                        block_k)
