"""Fault tolerance: heartbeats and straggler detection, copied from
``repro/train/fault_tolerance.py`` (the code unchanged).

  * HeartbeatMonitor — every worker touches <dir>/<host>.hb each step; a
    coordinator calls dead_hosts(timeout) to trigger checkpoint-restart.
  * StragglerDetector — sliding-window step times; a step slower than
    `threshold` x the window median flags the host so the launcher can evict
    or re-mesh.

``surviving_mesh`` and ``elastic_remesh`` build meshes and logical
shardings; they wait for the port of ``launch/`` and ``sharding/``.
"""
from __future__ import annotations

import os
import statistics
import time
from dataclasses import dataclass, field


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

