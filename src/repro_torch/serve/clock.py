"""Injectable clocks for the serving stack.

Every scheduling decision in serve/scheduler.py and serve/engine.py is a
pure function of (queue state, ``clock.now()``): nothing reads
``time.monotonic`` directly. Production wires ``SystemClock``; the test
suite wires ``FakeClock`` and advances it by hand, which makes starvation,
deadline and batching-delay behavior unit-testable with exact, replayable
timestamps (tests/test_serve.py).
"""
from __future__ import annotations

import time


class SystemClock:
    """Monotonic wall clock (the production default)."""

    def now(self) -> float:
        return time.monotonic()

    def sleep(self, seconds: float) -> None:
        if seconds > 0:
            time.sleep(seconds)


class FakeClock:
    """Manually advanced clock: ``sleep`` jumps time instead of blocking,
    so driving loops run identically (and instantly) under test."""

    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def now(self) -> float:
        return self._t

    def advance(self, seconds: float) -> None:
        assert seconds >= 0, "time only moves forward"
        self._t += seconds

    def sleep(self, seconds: float) -> None:
        self.advance(max(0.0, seconds))
