"""One VTA GEMM instruction, gathered and added into acc: CUDA kernel +
plain version.

Replaces ``repro/kernels/vta_gemm.py::blocked_gemm`` (the Pallas kernel the
JAX backend reaches through ``fsim_jax._gemm_product``) together with what
the JAX backend computes around it for a GEMM entry: the ``inp``/``wgt`` row
gathers and ``state["acc"].at[acc_idx].add(...)``. Contract, with group
``q = j * gb + m`` and ``gb = g / w_d``::

    acc[n, uidx[q], bv, c] += sum_r sum_bi inp[n, inp_idx[q*R + r], bv, bi]
                                         * wgt[nw, wrows[j*R + r], c, bi]

acc (N, acc_depth, BV, BO) int32, updated in place and returned; inp
(N, inp_depth, BV, BI) int8; wgt (Nw, wgt_depth, BO, BI) int8 with Nw = 1
when the weight scratchpad is shared by the batch, else N; the index vectors
``uidx`` (g,), ``inp_idx`` (g*R,) and ``wrows`` (w_d*R,) as the executor
builds them (``vta/fsim_torch.py::_device_ops``), int32 on the card.
``unique`` says the ``uidx`` are distinct. The add wraps in int32, as
numpy's does. Index values are not checked here: they come from a lowered
trace, which addresses only rows inside the scratchpads.

``vta_gemm`` launches ``csrc/vta_gemm.cu`` for CUDA tensors (BV in {1, 2},
BI and BO in {16, 32, 64}) and counts the launch in ``LAUNCHES["gemm"]``; it
raises on anything the kernel does not take. For CPU tensors it takes
``gemm_acc_plain``: the row gathers, ``gemm_plain`` on the permuted
operands, then ``index_add_``. ``gemm_plain`` contracts in f32 blocks of at
most ``F32_EXACT_TERMS`` terms accumulated in int32, as ``_gemm_product``
does, and runs on either device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, count_launch
from repro_torch.kernels.registry import register_kernel
from repro_torch.vta.lowering import F32_EXACT_TERMS

LAUNCHES = {"gemm": 0}
BLOCKS = (16, 32, 64)          # block_in / block_out the kernel takes


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"gemm takes int8 operands, got {x.dtype}, {w.dtype}")
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"gemm takes x (N, w_d, M, K) and w (Nw, w_d, K, BO),"
                         f" got {tuple(x.shape)}, {tuple(w.shape)}")
    n, w_d, _, k = x.shape
    if w.shape[1:3] != (w_d, k) or w.shape[0] not in (1, n):
        raise ValueError(f"gemm shape mismatch: x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}")


def gemm_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The product alone: x (N, w_d, M, K) int8 @ w (Nw, w_d, K, BO) int8 ->
    (N, w_d, M, BO) int32, as exact f32 matmul blocks of <= F32_EXACT_TERMS
    terms (every partial sum of int8 products stays below 2^24), summed in
    int32."""
    _check(x, w)
    K = x.shape[-1]
    xf = x.to(torch.float32)
    wf = w.to(torch.float32)
    out = torch.zeros(x.shape[:3] + (w.shape[-1],), dtype=torch.int32,
                      device=x.device)
    for k0 in range(0, K, F32_EXACT_TERMS):
        part = torch.matmul(xf[..., k0:k0 + F32_EXACT_TERMS],
                            wf[..., k0:k0 + F32_EXACT_TERMS, :])
        out += part.to(torch.int32)
    return out


def _check_acc(acc, inp, wgt, uidx, inp_idx, wrows, R: int, w_d: int):
    """(N, g, BV, BI, BO) of one entry; raises on what the contract does
    not take."""
    if acc.dtype != torch.int32 or inp.dtype != torch.int8 or \
            wgt.dtype != torch.int8:
        raise TypeError(f"gemm takes int32 acc and int8 scratchpads, got "
                        f"{acc.dtype}, {inp.dtype}, {wgt.dtype}")
    if acc.dim() != 4 or inp.dim() != 4 or wgt.dim() != 4:
        raise ValueError("gemm takes acc (N, depth, BV, BO), inp (N, depth, "
                         "BV, BI) and wgt (Nw, depth, BO, BI)")
    n, _, bv, bo = acc.shape
    bi = inp.shape[3]
    if inp.shape[0] != n or inp.shape[2] != bv or wgt.shape[2:] != (bo, bi) \
            or wgt.shape[0] not in (1, n):
        raise ValueError(f"gemm scratchpads disagree: acc {tuple(acc.shape)}, "
                         f"inp {tuple(inp.shape)}, wgt {tuple(wgt.shape)}")
    g = uidx.numel()
    if R <= 0 or w_d <= 0 or g % w_d or inp_idx.numel() != g * R or \
            wrows.numel() != w_d * R:
        raise ValueError(f"gemm index vectors disagree: g {g}, R {R}, w_d "
                         f"{w_d}, inp_idx {inp_idx.numel()}, wrows "
                         f"{wrows.numel()}")
    return n, g, bv, bi, bo


def gemm_acc_plain(acc, inp, wgt, uidx, inp_idx, wrows, R: int, w_d: int,
                   unique: bool = True):
    """Plain version, on either device: gather the rows, permute them into
    w_d (gb*BV, R*BI) @ (R*BI, BO) products, ``gemm_plain``, then an exact
    int32 ``index_add_`` into acc (which sums duplicate ``uidx``, so
    ``unique`` changes nothing here). Returns acc, updated in place."""
    n, g, bv, bi, bo = _check_acc(acc, inp, wgt, uidx, inp_idx, wrows, R,
                                  w_d)
    gb = g // w_d
    x = inp[:, inp_idx]                                  # (N, g*R, BV, BI)
    w = wgt[:, wrows]                                    # (Nw, w_d*R, BO, BI)
    x = x.reshape(n, w_d, gb, R, bv, bi).permute(0, 1, 2, 4, 3, 5) \
        .reshape(n, w_d, gb * bv, R * bi)
    w = w.reshape(w.shape[0], w_d, R, bo, bi).permute(0, 1, 2, 4, 3) \
        .reshape(w.shape[0], w_d, R * bi, bo)
    prod = gemm_plain(x.contiguous(), w.contiguous())   # (N, w_d, gb*BV, BO)
    acc.index_add_(1, uidx, prod.reshape(n, g, bv, bo))
    return acc


def _lib():
    lib = _build.library("vta_gemm")
    fn = lib.vta_gemm_launch
    if fn.argtypes is None:
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [vp, vp, vp, vp, vp, vp, i, ll, ll, ll, i, i, i, i, i,
                       i, i, vp]
        fn.restype = ctypes.c_int
    return fn


def vta_gemm(acc, inp, wgt, uidx, inp_idx, wrows, R: int, w_d: int,
             unique: bool = True):
    """The kernel's wrapper: CUDA tensors launch ``csrc/vta_gemm.cu`` (one
    launch for the whole entry, every image and weight block); CPU tensors
    take ``gemm_acc_plain``. Returns acc, updated in place; raises on
    anything the kernel does not take."""
    tensors = (acc, inp, wgt, uidx, inp_idx, wrows)
    if not _build.on_card("gemm", *tensors):
        return gemm_acc_plain(acc, inp, wgt, uidx, inp_idx, wrows, R, w_d,
                              unique)
    n, g, bv, bi, bo = _check_acc(*tensors, R, w_d)
    if bi not in BLOCKS or bo not in BLOCKS or bv not in (1, 2):
        raise ValueError(f"the CUDA gemm takes block_in and block_out in "
                         f"{BLOCKS} and batch 1 or 2, got BI {bi}, BO {bo}, "
                         f"BV {bv}")
    if any(t.dtype != torch.int32 for t in (uidx, inp_idx, wrows)):
        raise TypeError("the CUDA gemm takes int32 index vectors")
    for t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("the CUDA gemm takes contiguous, 16-byte "
                             "aligned scratchpads and index vectors")
    wgt_ns = 0 if wgt.shape[0] == 1 else wgt[0].numel()
    status = _lib()(
        acc.data_ptr(), inp.data_ptr(), wgt.data_ptr(), uidx.data_ptr(),
        inp_idx.data_ptr(), wrows.data_ptr(), n, acc[0].numel(),
        inp[0].numel(), wgt_ns, g, R, w_d, bv, bi, bo, int(bool(unique)),
        torch.cuda.current_stream(acc.device).cuda_stream)
    _build.check(status, "vta_gemm")
    count_launch(LAUNCHES, "gemm")
    return acc


register_kernel("gemm", "cuda", vta_gemm)
register_kernel("gemm", "torch", gemm_acc_plain)
