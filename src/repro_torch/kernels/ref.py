"""Plain PyTorch oracles for the float layer ops, after ``repro/kernels/ref.py``.

The port's plain versions already repeat the reference's arithmetic step by
step and run on either device, so they are the oracles, under the
reference's names. ``attention_ref`` and ``wkv6_ref`` come with the kernels
that use them.
"""
from repro_torch.kernels.alu import alu_plain as alu_ref
from repro_torch.kernels.depthwise import depthwise_plain as depthwise_ref
from repro_torch.kernels.gemm import gemm_plain
from repro_torch.kernels.pool2d import pool2d_plain as pool2d_ref

__all__ = ["alu_ref", "depthwise_ref", "matmul_ref", "pool2d_ref"]


def matmul_ref(x, w, *, bias=None, act=None, clip=None):
    """x (M, K) @ w (K, N) in f32 accumulation, fused epilogue
    (bias/act/clip); ``bias`` is keyword-only, as in the reference."""
    return gemm_plain(x, w, bias, act=act, clip=clip)
