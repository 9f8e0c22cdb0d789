"""Public entry points for the float layer ops, after ``repro/kernels/ops.py``.

The conv-as-GEMM with its fused epilogue, the element-wise ALU op, depthwise
convolution, pooling and online-softmax attention, with the reference's
signatures less ``interpret``. Each runs where its tensors are: CUDA tensors
launch the op's hand-written kernels or raise; CPU tensors take the op's
plain PyTorch version. ``alu``, ``depthwise_conv`` and ``pool2d`` have one
kernel each (``csrc/alu.cu``, ``depthwise.cu``, ``pool2d.cu``). The other
two take a route by a fixed rule:

- ``gemm`` (``gemm.gemm_route``): bf16 with K and N multiples of 8 on
  ``csrc/gemm_bf16_sm90.cu`` (``wgmma``, TMA); every other case on
  ``csrc/gemm_f32.cu`` (CUDA cores), whose tile and split of K come from
  ``gemm.gemm_float_plan``, split cases summed in order by its second
  kernel ``gemm_float_reduce``.
- ``flash_attention`` (``flash_attention.attention_route``): Sq <= 8 on the
  split-K decode kernel and its combine (``csrc/flash_decode.cu``), bf16
  prefill on ``mma.sync`` (``csrc/flash_attention_mma.cu``), f32 prefill on
  ``mma.sync`` in 3xTF32 (``csrc/flash_attention.cu``, tile from
  ``flash_attention.attention_tf32_plan``).

``gemm`` takes no ``tile=``: the reference sizes its tiles with
``core/tile_search.py`` for the TPU's 64 MiB of VMEM, while the CUDA routes
plan their own tiles for the card. For the same reason
``flash_attention``'s ``block_q``/``block_k`` steer only its plain version;
the CUDA kernels pick their own tiles (``flash_attention.attention_tile``
gives the same one to the plain version as its default block).
"""
from repro_torch.kernels.alu import alu
from repro_torch.kernels.depthwise import depthwise_conv
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.gemm import gemm
from repro_torch.kernels.pool2d import pool2d

__all__ = ["alu", "depthwise_conv", "flash_attention", "gemm", "pool2d"]
