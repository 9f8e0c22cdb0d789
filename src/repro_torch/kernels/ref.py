"""Plain PyTorch oracles for the float layer ops, after ``repro/kernels/ref.py``.

The port's plain versions already repeat the reference's arithmetic step by
step and run on either device, so they are the oracles, under the
reference's names. ``attention_ref`` is its own full-softmax copy, as in the
reference. ``wkv6_ref`` waits for the RWKV-6 model slice: it has no kernel.
"""
from typing import Optional

import torch

from repro_torch.kernels.alu import alu_plain as alu_ref
from repro_torch.kernels.depthwise import depthwise_plain as depthwise_ref
from repro_torch.kernels.gemm import gemm_plain
from repro_torch.kernels.pool2d import pool2d_plain as pool2d_ref

__all__ = ["alu_ref", "attention_ref", "depthwise_ref", "matmul_ref",
           "pool2d_ref"]


def matmul_ref(x, w, *, bias=None, act=None, clip=None):
    """x (M, K) @ w (K, N) in f32 accumulation, fused epilogue
    (bias/act/clip); ``bias`` is keyword-only, as in the reference."""
    return gemm_plain(x, w, bias, act=act, clip=clip)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  softcap: Optional[float] = None,
                  scale: Optional[float] = None) -> torch.Tensor:
    """q (B, Sq, H, D); k, v (B, Sk, H, D), kv heads already expanded. One
    f32 softmax over all keys, masked scores at -2e38 and the mask aligned
    bottom-right, as ``flash_attention``; a row that sees no key is thus a
    softmax of equal scores and gives the mean of v (the kernel gives 0)."""
    _, sq, _, d = q.shape
    sk = k.shape[1]
    scale = d ** -0.5 if scale is None else scale
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32) * scale,
                          k.to(torch.float32))
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    qpos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    logits = torch.where(mask[None, None], logits, -2.0e38)
    wts = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", wts, v.to(torch.float32))
    return out.to(q.dtype)
