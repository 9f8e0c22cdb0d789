"""Parity of the port's float layer ops (``repro_torch.kernels.ops``) with the
JAX package's ``repro.kernels.ops`` (Pallas, interpret mode on the CPU) and
``repro.kernels.ref``, on the CPU.

Each test makes its inputs with numpy from a seed and hands the same arrays
to both packages. Tolerances are those of tests/test_kernels.py: GEMM 1e-5
in f32, 2e-2 in bf16 and 1e-4 with an epilogue (sums taken in another order);
ALU 1e-6; depthwise and pooling 1e-5, and f32 depthwise against the JAX
kernel the same bits (both contract their taps alike). On int-valued
inputs every partial sum is exact in f32, so those cases are bit-exact
against the VTA numpy oracles (``repro.vta.fsim``). On CPU tensors the wrappers take the plain versions and
count no launch.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import launch_counts, ops, ref

RNG = np.random.default_rng(7)
BF16 = {"float32": (jnp.float32, torch.float32),
        "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _normal(shape, scale=1.0):
    return (RNG.standard_normal(shape) * scale).astype(np.float32)


def _pair(a, dtype="float32"):
    """The same array as a JAX array and a CPU tensor of ``dtype``."""
    jd, td = BF16[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


def _np(t):
    return t.to(torch.float32).numpy()


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# GEMM (mirrors test_kernels.py::test_gemm_shapes_dtypes, _epilogue)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mnk", [(32, 128, 64), (96, 192, 256),
                                 (128, 384, 128), (64, 256, 192),
                                 (49, 37, 33), (37, 48, 64), (8, 1000, 1024),
                                 (20, 24, 36)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gemm_shapes_dtypes(mnk, dtype):
    """bf16: within 2e-2 of the JAX package's kernel and reference. f32:
    the port's product and the JAX package's each within the standard
    bound of a float32 dot product of length K, K 2^-24 (|x| @ |w|)
    element by element, of the float64 product of the same operands: the
    two sum in different orders, so at K = 1024 they can differ by more
    than 1e-5 near 0 while both are as close to the exact product as
    float32 sums get."""
    m, n, k = mnk
    xj, xt = _pair(_normal((m, k), 0.5), dtype)
    wj, wt = _pair(_normal((k, n), 0.5), dtype)
    got = ops.gemm(xt, wt)
    assert got.dtype == xt.dtype and got.shape == (m, n)
    if dtype == "bfloat16":
        _close(got, jops.gemm(xj, wj), 2e-2)
        _close(got, jref.matmul_ref(xj, wj), 2e-2)
        return
    x64, w64 = xt.numpy().astype(np.float64), wt.numpy().astype(np.float64)
    exact = x64 @ w64
    bound = k * 2.0 ** -24 * (np.abs(x64) @ np.abs(w64))
    for out in (got.numpy(), np.asarray(jops.gemm(xj, wj)),
                np.asarray(jref.matmul_ref(xj, wj))):
        assert out.dtype == np.float32
        err = np.abs(out.astype(np.float64) - exact)
        assert (err <= bound).all(), float((err - bound).max())


@pytest.mark.parametrize("act,clip", [("relu", None), ("silu", None),
                                      ("gelu", 4.0), (None, 2.0),
                                      ("relu", 6.0)])
def test_gemm_epilogue(act, clip):
    xj, xt = _pair(_normal((64, 96)))
    wj, wt = _pair(_normal((96, 128)))
    bj, bt = _pair(_normal((128,)))
    got = ops.gemm(xt, wt, bt, act=act, clip=clip)
    _close(got, jops.gemm(xj, wj, bj, act=act, clip=clip), 1e-4)
    _close(ref.matmul_ref(xt, wt, bias=bt, act=act, clip=clip),
           jref.matmul_ref(xj, wj, bias=bj, act=act, clip=clip), 1e-4)


@pytest.mark.parametrize("dtype,k,n,route", [
    (torch.bfloat16, 1024, 4096, "gemm_bf16"),   # qkv of bench_kernels.py
    (torch.bfloat16, 1024, 1000, "gemm_bf16"),   # mbn.fc, M 8
    (torch.bfloat16, 8, 8, "gemm_bf16"),
    (torch.bfloat16, 1020, 1008, "gemm_float"),  # K % 8 != 0
    (torch.bfloat16, 1024, 1004, "gemm_float"),  # N % 8 != 0
    (torch.bfloat16, 0, 8, "gemm_float"),
    (torch.float32, 1024, 4096, "gemm_float"),   # f32: never TF32
    (torch.float32, 33, 37, "gemm_float"),
])
def test_gemm_route(dtype, k, n, route):
    """The fixed rule that sends a product on the card to the wgmma kernel
    (bf16, K and N multiples of 8: TMA's 16-byte row strides) or to the SIMT
    kernel (everything else); M plays no part."""
    from repro_torch.kernels.gemm import gemm_route
    assert gemm_route(dtype, k, n) == route


# ---------------------------------------------------------------------------
# ALU (mirrors test_alu_ops, test_alu_immediate)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("op", ["add", "mul", "max", "min"])
@pytest.mark.parametrize("shape", [(4, 16, 256), (33, 130)])
def test_alu_ops(op, shape):
    xj, xt = _pair(_normal(shape))
    yj, yt = _pair(_normal(shape))
    got = ops.alu(xt, yt, op=op, shift=1, clip=0.75)
    _close(got, jops.alu(xj, yj, op=op, shift=1, clip=0.75), 1e-6)
    _close(ref.alu_ref(xt, yt, op=op, shift=1, clip=0.75),
           jref.alu_ref(xj, yj, op=op, shift=1, clip=0.75), 1e-6)


def test_alu_immediate():
    x = _normal((8, 256))
    got = ops.alu(torch.from_numpy(x), op="max", imm=0.0)  # relu, MAX-imm
    np.testing.assert_allclose(got.numpy(), np.maximum(x, 0))


@pytest.mark.parametrize("op,imm,shift,clip", [("max", 0.0, 8, 127.0),
                                               ("mul", 1.5, 0, None),
                                               ("min", 0.25, 2, 0.1)])
def test_alu_bf16_immediate(op, imm, shift, clip):
    """bf16 in and out, immediate operand: both sides compute in f32 and
    round once to bf16, so they agree exactly."""
    xj, xt = _pair(_normal((7, 9, 33), 300.0), "bfloat16")
    got = ops.alu(xt, op=op, imm=imm, shift=shift, clip=clip)
    assert got.dtype == torch.bfloat16
    want = jops.alu(xj, op=op, imm=imm, shift=shift, clip=clip)
    np.testing.assert_array_equal(_np(got), np.asarray(want, np.float32))


# ---------------------------------------------------------------------------
# depthwise conv and pooling (mirror test_depthwise, test_pool)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("stride,pad,c,h", [(1, 1, 32, 10), (2, 1, 64, 10),
                                            (1, 0, 128, 10), (2, 1, 16, 9)])
def test_depthwise(stride, pad, c, h):
    xj, xt = _pair(_normal((2, h, h, c)))
    wj, wt = _pair(_normal((3, 3, c)))
    got = ops.depthwise_conv(xt, wt, stride=stride, pad=pad)
    want = jops.depthwise_conv(xj, wj, stride=stride, pad=pad)
    assert got.shape == want.shape
    _same_bits(got, want)
    _close(got, jref.depthwise_ref(xj, wj, stride=stride, pad=pad), 1e-5)


def _same_bits(got, want):
    np.testing.assert_array_equal(_np(got).view(np.int32),
                                  np.asarray(want, np.float32).view(np.int32))


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("pad", [0, 1])
@pytest.mark.parametrize("stride", [1, 2])
def test_depthwise_bits_match_jax(stride, pad, k):
    """On normal f32 values the taps contract as XLA's CPU build of the
    reference does (fma(x0, w0, x1*w1), then fma(x_k, w_k, acc)): the
    same bits, not only within 1e-5."""
    xj, xt = _pair(_normal((2, 14, 14, 32)))
    wj, wt = _pair(_normal((k, k, 32)))
    got = ops.depthwise_conv(xt, wt, stride=stride, pad=pad)
    _same_bits(got, jops.depthwise_conv(xj, wj, stride=stride, pad=pad))


@pytest.mark.parametrize("mode", ["max", "avg"])
@pytest.mark.parametrize("k,stride,pad", [(3, 2, 1), (2, 2, 0), (3, 1, 1)])
def test_pool(mode, k, stride, pad):
    xj, xt = _pair(_normal((2, 9, 9, 32)))
    got = ops.pool2d(xt, k=k, stride=stride, pad=pad, mode=mode)
    want = jops.pool2d(xj, k=k, stride=stride, pad=pad, mode=mode)
    assert got.shape == want.shape
    _close(got, want, 1e-5)
    _close(got, jref.pool2d_ref(xj, k=k, stride=stride, pad=pad, mode=mode),
           1e-5)


@pytest.mark.parametrize("op", ["depthwise", "max", "avg"])
def test_bf16_layer_ops(op):
    """bf16 activations: f32 arithmetic inside, one rounding to bf16 at the
    end on both sides (tolerance: the JAX tests' bf16 2e-2)."""
    xj, xt = _pair(_normal((2, 11, 11, 24)), "bfloat16")
    if op == "depthwise":
        wj, wt = _pair(_normal((3, 3, 24)), "bfloat16")
        got = ops.depthwise_conv(xt, wt, stride=2, pad=1)
        want = jops.depthwise_conv(xj, wj, stride=2, pad=1)
    else:
        got = ops.pool2d(xt, k=3, stride=2, pad=1, mode=op)
        want = jops.pool2d(xj, k=3, stride=2, pad=1, mode=op)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    _close(got, want, 2e-2)


# ---------------------------------------------------------------------------
# int-valued inputs: bit-exact against the VTA numpy oracles
# (mirrors test_kernels.py's cross-oracle agreement section)
# ---------------------------------------------------------------------------
def test_gemm_matches_vta_conv_1x1():
    from repro.vta.fsim import conv2d_ref
    m, k, n = 24, 48, 16
    x = RNG.integers(-128, 128, (m, k), dtype=np.int8)
    w = RNG.integers(-8, 8, (n, k), dtype=np.int8)
    got = ops.gemm(torch.from_numpy(x.astype(np.float32)),
                   torch.from_numpy(w.T.astype(np.float32)))
    vta = conv2d_ref(x.reshape(m, k, 1, 1), w.reshape(n, k, 1, 1),
                     (1, 1), (0, 0))[:, :, 0, 0]
    np.testing.assert_array_equal(got.numpy(), vta.astype(np.float32))


def test_depthwise_matches_vta_layout():
    from repro.vta.fsim import depthwise_ref as vta_dw
    b, c, h = 2, 16, 9
    x = RNG.integers(-128, 128, (b, c, h, h), dtype=np.int8)
    w = RNG.integers(-8, 8, (c, 3, 3), dtype=np.int8)
    got = ops.depthwise_conv(
        torch.from_numpy(x.transpose(0, 2, 3, 1).astype(np.float32)),
        torch.from_numpy(w.transpose(1, 2, 0).astype(np.float32)),
        stride=2, pad=1)
    vta = vta_dw(x, w, (2, 2), (1, 1)).transpose(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), vta.astype(np.float32))


def test_pool_matches_vta_max():
    from repro.vta.fsim import pool_ref
    x = RNG.integers(-128, 128, (1, 8, 14, 14), dtype=np.int8)
    got = ops.pool2d(
        torch.from_numpy(x.transpose(0, 2, 3, 1).astype(np.float32)),
        k=3, stride=2, pad=1, mode="max")
    vta = pool_ref(x, (3, 3), (2, 2), (1, 1), mode="max")
    np.testing.assert_array_equal(got.numpy(),
                                  vta.transpose(0, 2, 3, 1).astype(np.float32))


@pytest.mark.parametrize("op", ["add", "max", "min", "mul"])
def test_alu_matches_vta_int_semantics(op):
    x = RNG.integers(-128, 128, (64,), dtype=np.int8).astype(np.int32)
    y = RNG.integers(-128, 128, (64,), dtype=np.int8).astype(np.int32)
    got = ops.alu(torch.from_numpy(x.astype(np.float32)),
                  torch.from_numpy(y.astype(np.float32)), op=op, clip=127.0)
    fn = {"add": np.add, "max": np.maximum, "min": np.minimum,
          "mul": np.multiply}[op]
    vta = np.clip(fn(x, y), -127, 127)          # VTA CLIP: symmetric bound
    np.testing.assert_array_equal(got.numpy(), vta.astype(np.float32))


# ---------------------------------------------------------------------------
# where the wrappers run
# ---------------------------------------------------------------------------
def test_cpu_tensors_count_no_launch():
    before = dict(launch_counts())
    x = torch.from_numpy(_normal((2, 8, 8, 16)))
    ops.gemm(x.reshape(-1, 16), x.reshape(-1, 16)[:16], act="relu", clip=1.0)
    ops.alu(x, x, op="mul", shift=1)
    ops.depthwise_conv(x, x[0, :3, :3], stride=2, pad=1)
    ops.pool2d(x, k=2, stride=2, mode="avg")
    after = launch_counts()
    for k in ("gemm_float", "gemm_bf16", "alu", "depthwise", "pool2d"):
        assert k in after
    assert after == before


def test_wrappers_reject_what_the_kernels_do_not_take():
    """No quiet fallback: a tensor on neither the CPU nor a CUDA device, mixed
    devices, and malformed arguments all raise."""
    x = torch.zeros((1, 4, 4, 8))
    meta = torch.empty((1, 4, 4, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        ops.pool2d(meta, k=2, stride=2)
    with pytest.raises(ValueError, match="CUDA device"):
        ops.alu(x, meta)
    with pytest.raises(ValueError):
        ops.alu(x, x[0], op="add")
    with pytest.raises(ValueError):
        ops.alu(x, op="sub")
    with pytest.raises(ValueError):
        ops.pool2d(x, k=2, stride=2, mode="sum")
    with pytest.raises(ValueError):
        ops.depthwise_conv(x, torch.zeros((3, 3, 4)))
    with pytest.raises(ValueError):
        ops.gemm(x[0, 0], torch.zeros((8, 3)), act="tanh")
    with pytest.raises(ValueError):
        ops.gemm(x[0, 0], torch.zeros((8, 3)), torch.zeros(4))
