"""Per-replica health tracking and crash-recovery policy.

The fault injector tells the cluster *what* broke; this module turns that
into a routing signal with memory.  Each replica carries a health state —

``healthy`` → ``degraded`` (stalled / OOM storm) → ``down`` (crashed)
→ ``rewarming`` (just recovered) → ``healthy``

— and the :class:`HealthAwareRouter` wrapper (see
:mod:`repro_torch.cluster.router`) filters/deprioritizes sick replicas.  The
rewarming phase is the hysteresis the tentpole asks for: a replica that
just came back is cold (empty KV pool, no prefix cache, cold TU
estimator), so handing it the whole backlog at once trades one incident
for another.  During ``rewarm_s`` after recovery its admissible queue
depth ramps linearly from 1 to unbounded, so load returns gradually.

Degraded states auto-decay: fault injection stamps ``until`` times and
``state()`` resolves the current label against the asking clock, so the
monitor needs no polling.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class RecoveryPolicy:
    """What the cluster does with a dying/dead replica's requests.

    ``migrate``       — drain state-preserving spills to healthy peers on
                        the crash warning (False = naive baseline: all work
                        on the dead replica re-submits from scratch).
    ``migration_bw``  — host-to-host transfer bandwidth (bytes/s) charged
                        for moving a spilled request's KV payload between
                        replicas on the virtual clock.
    ``max_retries``   — per-request failover budget: a request whose
                        placement/migration fails this many times is
                        rejected (reason ``pool_pressure``) instead of
                        ping-ponging forever.
    ``backoff_s``     — base of the exponential backoff between successive
                        placement retries of the same request (0 disables).
    """

    migrate: bool = True
    migration_bw: float = 16e9
    max_retries: int = 8
    backoff_s: float = 0.0
    backoff_mult: float = 2.0

    def backoff(self, n_retries: int) -> float:
        if self.backoff_s <= 0 or n_retries <= 0:
            return 0.0
        return self.backoff_s * self.backoff_mult ** (n_retries - 1)


_PENALTY = {"healthy": 0, "rewarming": 1, "degraded": 2, "failing": 3,
            "down": 4}


@dataclass
class HealthMonitor:
    """Tracks each replica's health label on the shared virtual clock."""

    n_replicas: int
    rewarm_s: float = 1.0           # hysteresis window after recovery
    rewarm_depth: int = 8           # queue depth admitted at full rewarm
    _state: list = field(init=False)
    _until: list = field(init=False)    # when a transient label expires

    def __post_init__(self):
        self._state = ["healthy"] * self.n_replicas
        self._until = [0.0] * self.n_replicas

    # -- transitions (driven by the fault injector / cluster loop) --------
    def mark(self, idx: int, state: str, now: float,
             until: float = float("inf")):
        assert state in _PENALTY, state
        self._state[idx] = state
        self._until[idx] = until

    def crash(self, idx: int, now: float, until: float):
        self.mark(idx, "down", now, until)

    def recover(self, idx: int, now: float):
        """Crash over: the replica re-enters rotation via rewarming."""
        self.mark(idx, "rewarming", now, now + self.rewarm_s)

    # -- queries -----------------------------------------------------------
    def state(self, idx: int, now: float) -> str:
        s = self._state[idx]
        if s in ("degraded", "failing", "rewarming") \
                and now >= self._until[idx]:
            self._state[idx] = "healthy"
            return "healthy"
        return s

    def routable(self, idx: int, now: float) -> bool:
        return self.state(idx, now) not in ("down", "failing")

    def penalty(self, idx: int, now: float) -> int:
        """Routing sort penalty — healthy replicas first, then rewarming,
        then degraded; down/failing are filtered out before ranking."""
        return _PENALTY[self.state(idx, now)]

    def allows(self, idx: int, core, now: float) -> bool:
        """Admission-depth gate: a rewarming replica's queue ramps
        linearly from 1 to ``rewarm_depth`` over the rewarm window (then
        unbounded) so returning capacity is re-loaded gradually."""
        s = self.state(idx, now)
        if s in ("down", "failing"):
            return False
        if s != "rewarming":
            return True
        frac = 1.0 - (self._until[idx] - now) / max(self.rewarm_s, 1e-9)
        depth = 1 + int(frac * max(self.rewarm_depth - 1, 0))
        return core.queue_depth < depth
