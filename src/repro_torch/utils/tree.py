"""Tree helpers shared across the port, after ``repro/utils/tree.py``.

A tree is a nested dict whose leaves are tensors or other values;
``tree_leaves`` also walks lists and tuples (a (params, opt_state) pair).
Leaves are visited in sorted key order, as ``jax.tree_util`` flattens
dicts, so that a sum over the leaves rounds as the reference's does.
"""
from __future__ import annotations

from typing import Callable

import torch


def tree_leaves(tree) -> list:
    """The leaves of ``tree``: dict values in sorted key order, list and
    tuple items in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of nested dicts (``rest``: trees of the same
    structure, whose leaves are passed alongside). Anything that is not a
    dict is a leaf: a cache tree's ``TensorSpec`` (a named tuple) too."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_map_with_path(fn: Callable, tree, path: tuple = ()):
    """``fn(path, leaf)`` over the leaves of nested dicts, ``path`` the
    tuple of keys down to the leaf."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    return fn(path, tree)


def tree_param_count(tree) -> int:
    """Total number of scalar parameters in a tree of tensors."""
    return sum(x.numel() for x in tree_leaves(tree)
               if isinstance(x, torch.Tensor))


def tree_size_bytes(tree) -> int:
    """Total bytes of a tree of tensors."""
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree)
               if isinstance(x, torch.Tensor))


def tree_cast(tree, dtype: torch.dtype):
    """Cast every floating leaf to ``dtype`` (integer and bool leaves
    untouched)."""
    def cast(x):
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            return x.to(dtype)
        return x
    return tree_map(cast, tree)


def tree_zeros_like(tree):
    return tree_map(torch.zeros_like, tree)


def flatten_dict(d: dict, prefix: str = "", sep: str = "/") -> dict:
    """Flatten a nested dict into {path: leaf}."""
    out = {}
    for k, v in d.items():
        path = f"{prefix}{sep}{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten_dict(v, path, sep))
        else:
            out[path] = v
    return out
