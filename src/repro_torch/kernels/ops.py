"""Public entry points for the float layer ops, after ``repro/kernels/ops.py``.

The conv-as-GEMM with its fused epilogue, the element-wise ALU op, depthwise
convolution, pooling and online-softmax attention, with the reference's
signatures less ``interpret``. Each runs where its tensors are: CUDA tensors
launch the op's hand-written kernel (``csrc/gemm_f32.cu``, ``alu.cu``,
``depthwise.cu``, ``pool2d.cu``, ``flash_attention.cu``) or raise; CPU
tensors take the op's plain PyTorch version.

``gemm`` takes no ``tile=``: the reference sizes its tiles with
``core/tile_search.py`` for the TPU's 64 MiB of VMEM, while the CUDA kernel
has one fixed 64x64 shared-memory tiling. For the same reason
``flash_attention``'s ``block_q``/``block_k`` steer only its plain version;
the CUDA kernel picks its own tile (``flash_attention.attention_tile`` gives
the same one to the plain version as its default block).
"""
from repro_torch.kernels.alu import alu
from repro_torch.kernels.depthwise import depthwise_conv
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.gemm import gemm
from repro_torch.kernels.pool2d import pool2d

__all__ = ["alu", "depthwise_conv", "flash_attention", "gemm", "pool2d"]
