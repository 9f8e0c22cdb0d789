"""The port's exact float ops agree with the JAX package in the sign of zero.

``repro_torch.kernels.ops.{pool2d, alu, depthwise_conv}`` (on the CPU: their
plain versions, which the CUDA kernels equal bit for bit) against
``repro.kernels.ops`` (Pallas in interpret mode, as tests/test_kernels.py
runs it), compared by bits and not by a tolerance. The inputs, made with
numpy from a seed, are mostly zeros of both signs, with NaN for max and min
and padded windows: ``jnp.maximum`` orders -0 < +0 where ``torch.maximum``
keeps its first operand, and the reference's sums start from their first
term where a +0.0 seed would turn a sum of -0s into +0. NaN is compared by
position (a NaN's payload is not part of the function). Depthwise inputs are
small integers and zeros, so every product and partial sum is exact and
XLA's contraction of multiply and add into one FMA cannot move a bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
WINDOWS = [(2, 2, 0), (3, 2, 1), (3, 1, 1)]


def _zeros(rng, shape, *, neg=0.85, nan=0.0, values=0.0):
    """Zeros of both signs (``neg`` of them -0), ``values`` of the elements
    standard normal and ``nan`` of them NaN."""
    u = rng.random(shape)
    a = np.where(u < neg, np.float32(-0.0), np.float32(0.0))
    a = np.where(u > 1 - values, rng.standard_normal(shape), a)
    a = np.where(rng.random(shape) < nan, np.nan, a)
    return a.astype(np.float32)


def _bits(a):
    """f32 bit patterns, NaN (any payload) as one pattern."""
    a = np.asarray(a, np.float32)
    b = a.view(np.uint32).copy()
    b[np.isnan(a)] = 0x7FC00000
    return b


def _same_bits(got, want):
    got = got.to(torch.float32).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("k,stride,pad", WINDOWS)
@pytest.mark.parametrize("mode", ["max", "avg"])
def test_pool2d_signed_zeros(mode, k, stride, pad, dtype):
    rng = np.random.default_rng(11 + 7 * k + stride + pad)
    x = _zeros(rng, (2, 9, 9, 16), nan=0.03 if mode == "max" else 0.0,
               values=0.1)
    jd, td = DTYPES[dtype]
    got = ops.pool2d(torch.from_numpy(x).to(td), k=k, stride=stride,
                     pad=pad, mode=mode)
    want = jops.pool2d(jnp.asarray(x).astype(jd), k=k, stride=stride,
                       pad=pad, mode=mode)
    assert got.dtype == td and tuple(got.shape) == want.shape
    _same_bits(got, want)


@pytest.mark.parametrize("k", [3, 7])
def test_avg_pool_normal_values_by_bits(k):
    """On normal values too: avg multiplies its sum by the f32 reciprocal
    of k*k, as XLA compiles the reference's division (a true division
    differs in the last bit)."""
    rng = np.random.default_rng(5 + k)
    x = rng.standard_normal((2, 11, 11, 8)).astype(np.float32)
    got = ops.pool2d(torch.from_numpy(x), k=k, stride=1, pad=1, mode="avg")
    want = jops.pool2d(jnp.asarray(x), k=k, stride=1, pad=1, mode="avg")
    _same_bits(got, want)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("clip", [None, 0.5])
@pytest.mark.parametrize("operand", ["y", "imm"])
@pytest.mark.parametrize("op", ["max", "min"])
def test_alu_signed_zeros(op, operand, clip, dtype):
    """max and min against a tensor and against an immediate zero whose
    sign loses the tie (-0 for max, +0 for min: a broadcast scalar wins
    every tie in torch.maximum and torch.minimum), with and without the
    clip."""
    rng = np.random.default_rng(3 + len(op) + (clip is None))
    x = _zeros(rng, (6, 40), neg=0.5, nan=0.05, values=0.2)
    y = _zeros(rng, (6, 40), neg=0.5, values=0.2)
    jd, td = DTYPES[dtype]
    if operand == "y":
        args, jargs, kw = ((torch.from_numpy(x).to(td),
                            torch.from_numpy(y).to(td)),
                           (jnp.asarray(x).astype(jd),
                            jnp.asarray(y).astype(jd)), {})
    else:
        args, jargs = ((torch.from_numpy(x).to(td),),
                       (jnp.asarray(x).astype(jd),))
        kw = {"imm": -0.0 if op == "max" else 0.0}
    got = ops.alu(*args, op=op, shift=1, clip=clip, **kw)
    want = jops.alu(*jargs, op=op, shift=1, clip=clip, **kw)
    _same_bits(got, want)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("stride,pad", [(1, 1), (2, 1), (1, 0)])
def test_depthwise_signed_zeros(stride, pad, dtype):
    rng = np.random.default_rng(17 + stride + pad)
    x = _zeros(rng, (2, 9, 9, 16))
    x = np.where(rng.random(x.shape) < 0.05,
                 rng.integers(-4, 5, x.shape), x).astype(np.float32)
    w = rng.integers(1, 4, (3, 3, 16)).astype(np.float32)
    w[..., :4] *= -1                   # products of both signs of zero
    jd, td = DTYPES[dtype]
    got = ops.depthwise_conv(torch.from_numpy(x).to(td),
                             torch.from_numpy(w).to(td), stride=stride,
                             pad=pad)
    want = jops.depthwise_conv(jnp.asarray(x).astype(jd),
                               jnp.asarray(w).astype(jd), stride=stride,
                               pad=pad)
    _same_bits(got, want)
    assert (np.asarray(want, np.float32).view(np.uint32)
            == 0x80000000).any()      # the case holds sums of -0s
