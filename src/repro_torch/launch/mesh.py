"""Production mesh construction (multi-pod dry-run contract), on
``torch.distributed``; the port of ``repro/launch/mesh.py``.

Functions, not module-level constants: importing this module starts no
process group. A mesh is a ``DeviceMesh`` over the default process group,
which ``init_process_group`` below starts: the ``fake`` backend for a
dry-run of N ranks in one process, ``nccl`` with one rank on the card,
``gloo`` with one rank on the CPU.
"""
from __future__ import annotations

import math
import os
import socket

import torch
import torch.distributed as dist

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """16x16 = 256 ranks; 2 pods = 512 ranks when multi_pod: the reference's
    TPU shapes, kept so that the specs compare with the JAX package's. On
    H100s that is 32 (or 64) nodes of 8 GPUs, ``model`` spanning two nodes.
    The default process group must have the mesh's world size. The dry-run
    asks for ``device_type="cpu"``: its fake group holds only meta tensors."""
    shape, axes = PRODUCTION_SHAPES[multi_pod]
    return make_mesh(shape, axes, device_type=device_type)


def make_mesh(shape, axes, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` over ``axes`` on the default process
    group (tests / SPS search / elastic re-mesh), on the card unless the
    caller asks for ``device_type="cpu"``. Raises if there is no group, if
    its world size is not the product of ``shape``, or if the mesh is on
    the card and there is none."""
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; start one with "
                           "repro_torch.launch.mesh.init_process_group")
    n = math.prod(shape)
    if dist.get_world_size() != n:
        raise ValueError(f"make_mesh: mesh {tuple(shape)} needs {n} ranks, "
                         f"the process group has {dist.get_world_size()}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device; pass device_type='cpu' "
                           "for a mesh on the CPU")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_process_group(kind: str, world_size: int = 1) -> None:
    """Start the default process group: ``"fake"`` (any world size, rank
    0, no communication: collectives return at once, for the dry-run),
    ``"nccl"`` (one rank on the card) or ``"gloo"`` (one rank on the CPU).
    The fake backend lives in ``torch.testing._internal.distributed.
    fake_pg``, an internal module (a test pins its use)."""
    if kind == "fake":
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", rank=0, world_size=world_size,
                                store=FakeStore())
        return
    if kind not in ("nccl", "gloo") or world_size != 1:
        raise ValueError(f"init_process_group: {kind!r} with {world_size} "
                         f"ranks; 'fake' of any size, or 'nccl'/'gloo' of 1")
    if kind == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("init_process_group: nccl needs a CUDA device")
        os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "1")
    dist.init_process_group(kind, init_method=f"tcp://localhost:{_free_port()}",
                            rank=0, world_size=1)


def destroy_process_group() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()
