"""Deterministic failure schedules shared by training and serving (a
copy of the JAX package's ``common/faults.py``; numpy only).

The training stack has always had a :class:`FailureInjector` for restart
drills (raise at step k, or with probability p per step).  The serving
cluster needs the same rigor on its *virtual* clock: a :class:`FaultPlan`
is a fully materialized timeline of replica faults — scheduled or
seeded-random — that the cluster DES replays deterministically.  All
randomness is consumed at construction time (``FaultPlan.random``), so a
plan is a plain value: two runs with the same plan see byte-identical
fault timing, which is what makes crash-recovery tests reproducible and
the migration bit-identity claim checkable.

Fault kinds
-----------
``crash``
    The replica dies at ``t`` and is down for ``duration`` seconds of
    virtual time.  ``warn_s`` > 0 models the usual few hundred ms between
    a health probe failing and the process dying (ECC error storms,
    watchdog kills) — the window a drain/migrate controller acts in.
``stall``
    Transient slowdown: every step on the replica takes ``slow_factor``×
    longer for ``duration`` seconds (e.g. a background compaction or a
    thermally throttled chip).
``oom``
    An ``OutOfPages`` storm: ``seize_frac`` of the replica's free KV pages
    vanish for ``duration`` seconds, forcing the engine through its
    preemption/spill machinery under pressure.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


class SimulatedFailure(RuntimeError):
    pass


@dataclass
class FailureInjector:
    """Deterministic failure schedule for restart drills (training)."""
    fail_at_steps: tuple = ()
    fail_prob: float = 0.0
    seed: int = 0
    _rng: np.random.Generator = field(init=False, repr=False)
    _fired: set = field(default_factory=set, init=False, repr=False)

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)

    def check(self, step: int):
        if step in self.fail_at_steps and step not in self._fired:
            self._fired.add(step)
            raise SimulatedFailure(f"injected failure at step {step}")
        if self.fail_prob > 0 and self._rng.random() < self.fail_prob:
            raise SimulatedFailure(f"random failure at step {step}")


FAULT_KINDS = ("crash", "stall", "oom")


@dataclass(frozen=True)
class FaultEvent:
    """One fault on one replica at one virtual time."""
    kind: str                 # "crash" | "stall" | "oom"
    t: float                  # virtual time the fault lands
    replica: int
    duration: float = 1.0     # down / degraded window (seconds)
    warn_s: float = 0.0       # crash only: advance warning before death
    slow_factor: float = 4.0  # stall only: step-latency multiplier
    seize_frac: float = 0.5   # oom only: fraction of free pages seized

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.duration < 0 or self.warn_s < 0:
            raise ValueError("fault durations must be non-negative")


@dataclass(frozen=True)
class FaultPlan:
    """An immutable, fully materialized fault timeline.

    Construct directly from events, parse a compact CLI spec
    (:meth:`parse`), or draw a seeded-random plan (:meth:`random`).
    :meth:`schedule` expands the events into primitive timeline ops the
    cluster loop interleaves with arrivals and replica ticks.
    """

    events: tuple[FaultEvent, ...] = ()

    # -- construction ------------------------------------------------------
    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        """Parse ``kind@t:rN[:key=val]*`` clauses joined by ``;``.

        Examples::

            crash@2.5:r1:down=1.0:warn=0.25
            stall@1:r0:dur=0.5:slow=4;oom@3:r2:dur=0.5:frac=0.5
        """
        keys = {"down": "duration", "dur": "duration", "warn": "warn_s",
                "slow": "slow_factor", "frac": "seize_frac"}
        events = []
        for clause in filter(None, (c.strip() for c in spec.split(";"))):
            head, *opts = clause.split(":")
            kind, _, t = head.partition("@")
            if not t or not opts or not opts[0].startswith("r"):
                raise ValueError(
                    f"bad fault clause {clause!r} (want kind@t:rN[:k=v]*)")
            kw = {"kind": kind.strip(), "t": float(t),
                  "replica": int(opts[0][1:])}
            for opt in opts[1:]:
                k, _, v = opt.partition("=")
                if k not in keys:
                    raise ValueError(f"unknown fault option {k!r} in "
                                     f"{clause!r} (known: {sorted(keys)})")
                kw[keys[k]] = float(v)
            events.append(FaultEvent(**kw))
        return cls(tuple(sorted(events, key=lambda e: (e.t, e.replica))))

    @classmethod
    def random(cls, n_replicas: int, horizon_s: float, seed: int = 0, *,
               crash_rate: float = 0.0, stall_rate: float = 0.0,
               oom_rate: float = 0.0, duration_s: float = 1.0,
               warn_s: float = 0.1) -> "FaultPlan":
        """Seeded Poisson fault arrivals per replica over ``horizon_s``.

        Rates are events/second per replica.  Every draw happens here, at
        construction — the returned plan carries no RNG state.
        """
        rng = np.random.default_rng(seed)
        events = []
        for kind, rate in (("crash", crash_rate), ("stall", stall_rate),
                           ("oom", oom_rate)):
            if rate <= 0:
                continue
            for rep in range(n_replicas):
                t = float(rng.exponential(1.0 / rate))
                while t < horizon_s:
                    dur = float(duration_s * (0.5 + rng.random()))
                    events.append(FaultEvent(
                        kind=kind, t=t, replica=rep, duration=dur,
                        warn_s=warn_s if kind == "crash" else 0.0))
                    t += float(rng.exponential(1.0 / rate))
        return cls(tuple(sorted(events, key=lambda e: (e.t, e.replica))))

    # -- expansion ---------------------------------------------------------
    def schedule(self) -> list[tuple[float, str, FaultEvent]]:
        """Primitive timeline ops, time-ordered:

        * crash  → ``warn`` (if warn_s > 0), ``crash``, ``recover``
        * stall  → ``stall``, ``stall_end``
        * oom    → ``oom``, ``oom_end``
        """
        ops: list[tuple[float, str, FaultEvent]] = []
        for ev in self.events:
            if ev.kind == "crash":
                if ev.warn_s > 0:
                    ops.append((max(0.0, ev.t - ev.warn_s), "warn", ev))
                ops.append((ev.t, "crash", ev))
                ops.append((ev.t + ev.duration, "recover", ev))
            elif ev.kind == "stall":
                ops.append((ev.t, "stall", ev))
                ops.append((ev.t + ev.duration, "stall_end", ev))
            else:  # oom
                ops.append((ev.t, "oom", ev))
                ops.append((ev.t + ev.duration, "oom_end", ev))
        ops.sort(key=lambda op: (op[0], op[2].replica))
        return ops

    @property
    def horizon(self) -> float:
        return max((e.t + e.duration for e in self.events), default=0.0)

    def __bool__(self) -> bool:
        return bool(self.events)
