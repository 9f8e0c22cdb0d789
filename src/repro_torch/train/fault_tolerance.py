"""Fault tolerance: heartbeats, straggler detection, elastic re-mesh; the
port of ``repro/train/fault_tolerance.py``.

  * HeartbeatMonitor — every worker touches <dir>/<host>.hb each step; a
    coordinator calls dead_hosts(timeout) to trigger checkpoint-restart.
  * StragglerDetector — sliding-window step times; a step slower than
    `threshold` x the window median flags the host so the launcher can evict
    or re-mesh.
  * surviving_mesh / elastic_remesh — rebuild a mesh from the ranks that
    remain (the default process group's world size, in place of
    ``jax.devices()``) and restore a checkpointed tree onto it as DTensors
    with re-derived logical shardings: the resharding path used after a
    failure.
"""
from __future__ import annotations

import os
import statistics
import time
from dataclasses import dataclass, field

from repro_torch.launch.mesh import make_mesh
from repro_torch.sharding.logical import LogicalRules


class HeartbeatMonitor:
    def __init__(self, directory: str, host: str):
        self.dir = directory
        self.host = host
        os.makedirs(directory, exist_ok=True)

    def beat(self, step: int):
        path = os.path.join(self.dir, f"{self.host}.hb")
        with open(path, "w") as f:
            f.write(str(step))
        os.utime(path)

    def dead_hosts(self, timeout_s: float) -> list[str]:
        now = time.time()
        dead = []
        for name in os.listdir(self.dir):
            if name.endswith(".hb"):
                if now - os.path.getmtime(os.path.join(self.dir, name)) > timeout_s:
                    dead.append(name[:-3])
        return sorted(dead)


@dataclass
class StragglerDetector:
    window: int = 32
    threshold: float = 2.0
    times: list = field(default_factory=list)
    flagged_steps: list = field(default_factory=list)

    def record(self, step: int, duration_s: float) -> bool:
        """Returns True if this step is a straggler."""
        self.times.append(duration_s)
        if len(self.times) > self.window:
            self.times.pop(0)
        if len(self.times) < 8:
            return False
        med = statistics.median(self.times)
        if duration_s > self.threshold * med:
            self.flagged_steps.append(step)
            return True
        return False



def surviving_mesh(n_failed_hosts: int = 0, *, devices_per_host: int = 1,
                   prefer_axes=("data", "model"), device_type: str = "cuda"):
    """Build the largest 2D mesh from the ranks that remain: the default
    process group's world size less the failed hosts' devices. The group
    must already have that many ranks (a restarted job's). The mesh is on
    the card (``make_mesh`` raises without one) unless the caller asks for
    ``device_type="cpu"``."""
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError("surviving_mesh: no process group")
    n = dist.get_world_size() - n_failed_hosts * devices_per_host
    assert n >= 1, "no devices survive"
    # largest power-of-two-ish factorization
    best = (1, n)
    d = 1
    while d * d <= n:
        if n % d == 0:
            best = (d, n // d)
        d += 1
    return make_mesh(best, prefer_axes, device_type=device_type)


def elastic_remesh(ckpt_manager, abstract_template, mesh, names_tree, *,
                   device=None):
    """Restore the latest checkpoint onto `mesh` with re-derived shardings.

    abstract_template: tensor tree (structure + dtypes; meta tensors from
    ``train.step.abstract_params``); names_tree: logical dim names per leaf
    (from model.logical_names()). The leaves land on ``device`` (the mesh's
    device type by default)."""
    from repro_torch.utils.tree import tree_map
    rules = LogicalRules(mesh)
    shardings = tree_map(lambda t, names: rules.sharding(names, t.shape),
                         abstract_template, names_tree)
    return ckpt_manager.restore(
        abstract_template, sharding_tree=shardings,
        device=mesh.device_type if device is None else device)
