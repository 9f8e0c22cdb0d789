"""Carry a language model's weights between the JAX package and the port.

Both packages keep a model's parameters as the same nested dict (keys,
shapes and layout from ``model_specs``), so a tree of numpy arrays is the
common form. ``numpy_params`` makes one from a seed with numpy alone, at
the Spec scales, so that both packages can load the same weights, at full
width too, on a machine without JAX.
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import Spec, std_of, tree_map
from repro_torch.models.transformer import model_specs


def params_from_numpy(tree, device, dtype=None):
    """The port's parameters from a tree of numpy arrays (the JAX package's
    parameters through ``np.asarray``, or ``numpy_params``): each leaf a
    tensor on ``device``, in ``dtype`` if given, else in its own."""
    return tree_map(lambda a: torch.as_tensor(np.asarray(a)).to(
        device=device, dtype=dtype), tree)


def _numpy_leaf(spec: Spec, rng: np.random.Generator) -> np.ndarray:
    shp, f32 = spec.shape, np.float32
    if spec.init == "zeros":
        return np.zeros(shp, f32)
    if spec.init == "ones":
        return np.ones(shp, f32)
    if spec.init == "normal":
        return rng.standard_normal(shp, dtype=f32) * f32(std_of(spec))
    if spec.init == "decay":
        return np.broadcast_to(np.linspace(-6.0, -0.5, shp[-1], dtype=f32),
                               shp).copy()
    if spec.init == "lambda":
        sp = np.linspace(1.25e-4, 1.32e-2, shp[-1], dtype=f32)
        return np.broadcast_to(np.log(np.expm1(sp)), shp).copy()
    if spec.init == "uniform_small":
        return rng.uniform(-0.01, 0.01, shp).astype(f32)
    raise ValueError(f"unknown init {spec.init}")


def numpy_params(cfg: ModelConfig, seed: int) -> dict:
    """A full f32 parameter tree of ``cfg`` as numpy arrays: every Spec of
    ``model_specs(cfg)`` drawn, in sorted key order, from
    ``numpy.random.default_rng(seed)`` by its initializer and scale."""
    rng = np.random.default_rng(seed)

    def draw(specs):
        if isinstance(specs, dict):
            return {k: draw(specs[k]) for k in sorted(specs)}
        return _numpy_leaf(specs, rng)
    return draw(model_specs(cfg))


def tree_sha256(tree) -> str:
    """sha256 over the bytes of every leaf of a tree of numpy arrays, in
    sorted key order: whether two machines made the same weights."""
    h = hashlib.sha256()

    def walk(t):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        else:
            h.update(np.ascontiguousarray(t))     # its buffer, no copy
    walk(tree)
    return h.hexdigest()
