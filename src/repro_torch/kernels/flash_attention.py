"""Online-softmax attention (GQA, causal/sliding-window mask, logit softcap):
CUDA kernel + plain version.

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

``flash_attention`` launches ``csrc/flash_attention.cu`` for CUDA tensors
(f32 or bf16, D a multiple of 8 up to 256), one launch per call, counted in
``LAUNCHES["flash_attention"]``; for CPU tensors it takes
``flash_attention_plain``, which runs on either device.

Blocks. ``block_q``/``block_k`` have the reference's meaning for the plain
version, halved until they divide Sq and Sk; without them it takes the
kernel's tile (``attention_tile``). The CUDA kernel picks its compiled tile
itself and ignores them: it masks its own tails instead of halving, so on
the card the blocks change only the order of summation, as ``tile=`` does
for ``ops.gemm``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

LAUNCHES = {"flash_attention": 0}
NEG_INF = -2.0e38
MAX_HEAD_DIM = 256


def attention_tile(head_dim: int, dtype: torch.dtype, sq: int) -> tuple:
    """(bq, bk): the plain version's default block, the tile that
    ``csrc/flash_attention.cu`` picks for itself from the same three values
    (``by_rows``, ``with_keys``): 64 query rows, or 8 when ``sq <= 8`` (the
    decode shape); 64 keys, or 32 for f32 rows of more than 128 values. Only
    the plain version's order of summation depends on it."""
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


def _lib():
    fn = _build.library("flash_attention").flash_attention_launch
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([vp] * 4 + [i] * 8
                       + [ctypes.c_longlong, i, ctypes.c_float,
                          ctypes.c_float, i, vp])
        fn.restype = ctypes.c_int
    return fn


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, and 16-byte aligned for the kernel's vector loads."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None) -> torch.Tensor:
    """The kernel's wrapper: CUDA tensors launch ``csrc/flash_attention.cu``
    once; CPU tensors take ``flash_attention_plain``. Raises on anything the
    kernel does not take, on either device."""
    b, h, sq, d, kv, sk = _check(q, k, v)
    code = _build.float_code("flash_attention", q, k, v)
    if not _build.on_card("flash_attention", q, k, v):
        return flash_attention_plain(
            q, k, v, causal=causal, window=window, softcap=softcap,
            scale=scale, block_q=block_q, block_k=block_k)
    if h > 65535 or b > 65535:
        raise ValueError(f"flash_attention: B {b} and H {h} must be at most "
                         f"65535 (grid limits)")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty_like(q)
    status = _lib()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, h, kv, sq, sk, d, int(bool(causal)), int(window is not None),
        0 if window is None else int(window), int(softcap is not None),
        0.0 if softcap is None else float(softcap),
        d ** -0.5 if scale is None else float(scale), code,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(status, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out
