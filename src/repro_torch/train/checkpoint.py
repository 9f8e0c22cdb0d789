"""Checkpoint manager: atomic, keep-k, async; the port of
``repro/train/checkpoint.py``, on the same layout on disk.

Layout:  <dir>/step_<N>/{meta.json, arrays/<flat-path>.npy}
  * writes go to step_<N>.tmp then os.rename (atomic publish);
  * keep_last_k prunes old steps after a successful publish;
  * async=True saves on a background thread; the host copy of every leaf
    (a tensor copied to the CPU, bf16 widened to f32 exactly) is taken
    before the thread starts, so the caller may change its tensors, in
    place too, as soon as ``save`` returns;
  * restore() puts every array on an explicit ``device``, in the
    template's dtypes; with a ``sharding_tree`` (the template's structure,
    leaves ``sharding.logical.NamedSharding``), each leaf becomes a DTensor
    of its sharding's placements on its mesh, each rank keeping its own
    shard of the file's array (no collective): the elastic-remesh path.

A checkpoint written by either package restores in the other, equal by
bits: both write the same files.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Optional

import numpy as np
import torch

_SEP = "__"


def _flatten(tree) -> dict:
    flat = {}

    def walk(path, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(path + [str(k)], v)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(path + [str(i)], v)
        else:
            flat[_SEP.join(path)] = node

    walk([], tree)
    return flat


def _host(v) -> np.ndarray:
    """A host copy of leaf ``v``, taken now: a tensor copied to the CPU
    (bf16, which numpy lacks, widened to f32, exactly), anything else
    through ``np.array``."""
    if isinstance(v, torch.Tensor):
        v = v.detach()
        if v.dtype == torch.bfloat16:
            v = v.float()
        return v.to("cpu", copy=True).numpy()
    return np.array(v)


def _unflatten_into(template, flat: dict):
    def walk(path, node):
        if isinstance(node, dict):
            return {k: walk(path + [str(k)], v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            t = [walk(path + [str(i)], v) for i, v in enumerate(node)]
            return type(node)(t)
        return flat[_SEP.join(path)]
    return walk([], template)


def _distribute(t: torch.Tensor, sharding):
    """``t`` (the whole array, on every rank) as a DTensor of ``sharding``:
    each rank keeps its own shard, without communication."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, sharding.mesh, sharding.placements(),
                             src_data_rank=None)


class CheckpointManager:
    def __init__(self, directory: str, *, keep_last_k: int = 3,
                 async_save: bool = False):
        self.dir = directory
        self.keep = keep_last_k
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------
    def save(self, step: int, tree) -> str:
        """Save pytree at `step`. Returns the published path."""
        self.wait()
        host = {k: _host(v) for k, v in _flatten(tree).items()}
        if self.async_save:
            self._thread = threading.Thread(
                target=self._write, args=(step, host), daemon=True)
            self._thread.start()
            return self._step_dir(step)
        return self._write(step, host)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:010d}")

    def _write(self, step: int, host: dict) -> str:
        try:
            final = self._step_dir(step)
            tmp = final + ".tmp"
            arrays = os.path.join(tmp, "arrays")
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(arrays)
            for k, v in host.items():
                np.save(os.path.join(arrays, k + ".npy"), v)
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump({"step": step, "keys": sorted(host)}, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)                 # atomic publish
            self._prune()
            return final
        except BaseException as e:                 # surfaced on next wait()
            self._error = e
            raise

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _prune(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # ------------------------------------------------------------------
    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                meta = os.path.join(self.dir, name, "meta.json")
                if os.path.exists(meta):           # ignore torn writes
                    out.append(int(name[5:]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template, step: Optional[int] = None, *,
                device="cpu", sharding_tree=None):
        """Restore into the structure of ``template``: each leaf a tensor
        on ``device``, in the dtype of the template's leaf where it has
        one (a tensor or an array), else in the file's. With a
        ``sharding_tree`` of the same structure, each leaf that has a
        sharding is a DTensor on that sharding's mesh, its placements, on
        ``device``."""
        step = self.latest_step() if step is None else step
        assert step is not None, "no checkpoint found"
        arrays = os.path.join(self._step_dir(step), "arrays")
        flat_s = _flatten(sharding_tree) if sharding_tree is not None else {}
        out = {}
        for k, ref in _flatten(template).items():
            v = np.load(os.path.join(arrays, k + ".npy"))
            if isinstance(ref, torch.Tensor):
                t = torch.from_numpy(v).to(device=device, dtype=ref.dtype)
            else:
                if hasattr(ref, "dtype"):
                    v = v.astype(ref.dtype)
                t = torch.from_numpy(v).to(device)
            if flat_s.get(k) is not None:
                t = _distribute(t, flat_s[k])
            out[k] = t
        return _unflatten_into(template, out), step
