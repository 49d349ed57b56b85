"""Virtual / wall clocks for the serving engine."""

from __future__ import annotations

import time


class VirtualClock:
    """Deterministic simulated time driven by backend-reported latencies."""

    def __init__(self):
        self.t = 0.0

    def now(self) -> float:
        return self.t

    def advance(self, dt: float):
        self.t += dt

    def advance_to(self, t: float):
        self.t = max(self.t, t)

    def took(self, t0: float, dt: float) -> float:
        """How long work begun at ``t0`` took: the ``dt`` the clock was just
        advanced by (returned as given, not ``now - t0``, which rounds)."""
        return dt


class WallClock:
    """Real time; ``advance`` is a no-op (work itself takes the time)."""

    def __init__(self):
        self._t0 = time.perf_counter()

    def now(self) -> float:
        return time.perf_counter() - self._t0

    def advance(self, dt: float):
        pass

    def advance_to(self, t: float):
        while self.now() < t:
            time.sleep(min(0.001, t - self.now()))

    def took(self, t0: float, dt: float) -> float:
        """How long work begun at ``t0`` took: the time since, whatever the
        work reported (``dt``)."""
        return self.now() - t0
