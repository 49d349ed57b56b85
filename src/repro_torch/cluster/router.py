"""Cluster request routers.

A router ranks replica cores for a new request; the admission policy then
walks the ranking and places the request on the first replica with KV
headroom (falling back to cluster-level spill if none qualifies).

* :class:`RoundRobinRouter` — classic stateless baseline.
* :class:`JoinShortestQueueRouter` — route to the replica with the fewest
  in-flight requests (pending + active), the strongest simple baseline for
  homogeneous replicas.
* :class:`SaturationAwareRouter` — reads each replica's live
  :class:`~repro_torch.core.scheduler.ElasticScheduler` state (piecewise-affine
  latency model §5.2 + online N_commit estimator §5.3) and routes toward
  the replica with the largest *marginal* committed-tokens/sec from one
  more request, discounted by KV-pool pressure.  Past the saturation
  effective-workload a replica's marginal goodput collapses (paper Fig. 3),
  so this keeps every replica on the productive side of its roofline knee
  where JSQ only equalizes queue lengths.
"""

from __future__ import annotations

import numpy as np


def _queue_key(core, idx):
    return (core.queue_depth, idx)


class RoundRobinRouter:
    """Stateless cycling.  ``rank()`` is pure — the pointer only advances
    via ``placed()`` when a placement actually succeeds, so spill-queue
    retries and preemption probes don't scramble the rotation."""

    name = "round_robin"

    def __init__(self):
        self._next = 0

    def rank(self, replicas, req):
        n = len(replicas)
        return [(self._next + i) % n for i in range(n)]

    def placed(self, idx, n_replicas):
        self._next = (idx + 1) % n_replicas


class JoinShortestQueueRouter:
    name = "jsq"

    def rank(self, replicas, req):
        return sorted(range(len(replicas)),
                      key=lambda i: _queue_key(replicas[i], i))


class SaturationAwareRouter:
    """Expected-delay routing from the replicas' own saturation models.

    Each replica's elastic scheduler carries the two online signals the
    paper maintains anyway — the piecewise-affine latency model (§5.2) and
    the N_commit token-utilization estimator (§5.3).  Together they give a
    replica's committed-token service rate at batch ``b``

        G_r(b) = max_c  N̄(c) · b / T_r(c, b)

    where N̄ is the fleet-averaged commit curve (averaging strips the
    per-replica estimator noise that would otherwise herd traffic toward
    whichever replica's TU estimate happens to read high) and T_r is the
    replica's own latency model, evaluated at the fleet-mean batch — so a
    fast replica, or one still below its roofline knee, shows a genuinely
    higher rate, while past saturation G flattens (paper Fig. 3) and extra
    load only buys queueing.  A new request is routed to the replica where
    it would start soonest:

        delay_r = backlog_tokens_r / (G_r · free_kv_fraction_r)

    — the replica offering the most marginal tokens/sec to the newcomer
    after its queued work and KV pressure are priced in.  Replicas without
    an elastic scheduler (fixed-chunk baselines) fall back to JSQ ordering.
    """

    name = "saturation"

    def __init__(self, kv_pressure_weight: float = 1.0):
        self.kv_pressure_weight = kv_pressure_weight

    @staticmethod
    def _backlog_tokens(core) -> float:
        """Output tokens queued on the replica: remaining generation for
        active requests plus full budgets for still-pending ones."""
        tokens = 0.0
        for r in core.active_requests():
            try:
                done = core.backend.state(r.rid).n_committed
            except KeyError:
                done = 0
            tokens += max(r.max_new_tokens - done, 0)
        for r in core.pending_requests():
            tokens += r.max_new_tokens
        return tokens

    def _delays(self, replicas):
        scheds = [r.scheduler for r in replicas]
        if any(getattr(s, "latency_model", None) is None or
               getattr(s, "tu_estimator", None) is None for s in scheds):
            return None
        cands = scheds[0].candidates
        ncurve = {c: float(np.mean([s.tu_estimator.estimate(c)
                                    for s in scheds])) for c in cands}
        b = max(1, round(float(np.mean([r.queue_depth
                                        for r in replicas]))) + 1)
        delays = []
        for core in replicas:
            g = max(ncurve[c] * b / core.scheduler.latency_model.predict(b, c)
                    for c in cands)
            kv = getattr(core.backend, "kv", None)
            if kv is not None and self.kv_pressure_weight > 0:
                free_frac = kv.free_pages / max(kv.n_pages, 1)
                g *= max(free_frac, 1e-6) ** self.kv_pressure_weight
            delays.append(self._backlog_tokens(core) / g)
        return delays

    def rank(self, replicas, req):
        delays = self._delays(replicas)
        if delays is None:                           # non-elastic fallback
            return sorted(range(len(replicas)),
                          key=lambda i: _queue_key(replicas[i], i))
        # soonest-start first; JSQ then index as tie-breakers
        # (np.round keeps deterministic ordering despite float noise)
        return sorted(range(len(replicas)),
                      key=lambda i: (np.round(delays[i], 12),
                                     replicas[i].queue_depth, i))


class HealthAwareRouter:
    """Wrapper adding a health filter + penalty sort to any inner router.

    Replicas the monitor marks down/failing are dropped from the ranking
    entirely; the rest keep the inner router's relative order within each
    health class (healthy first, then rewarming, then degraded) — so a
    saturation-aware inner ranking still decides among healthy peers, and
    a rewarming replica only sees traffic when every healthy replica is a
    worse pick or the hysteresis depth gate admits it.  The monitor is
    wired in by the cluster engine (it owns the fault timeline); without
    one the wrapper is transparent.
    """

    def __init__(self, inner, monitor=None):
        self.inner = inner
        self.monitor = monitor
        self.name = f"health:{inner.name}"
        self._now = 0.0              # stamped by the cluster each event

    def observe(self, now: float):
        self._now = max(self._now, now)

    def rank(self, replicas, req):
        order = self.inner.rank(replicas, req)
        if self.monitor is None:
            return order
        now = self._now
        pos = {idx: p for p, idx in enumerate(order)}
        return sorted(
            (i for i in order if self.monitor.routable(i, now)),
            key=lambda i: (self.monitor.penalty(i, now), pos[i]))

    def placed(self, idx, n_replicas):
        fn = getattr(self.inner, "placed", None)
        if fn is not None:
            fn(idx, n_replicas)


ROUTERS = {
    "round_robin": RoundRobinRouter,
    "rr": RoundRobinRouter,
    "jsq": JoinShortestQueueRouter,
    "saturation": SaturationAwareRouter,
}


def make_router(name: str):
    """``make_router("jsq")`` or, wrapped with the health filter,
    ``make_router("health:jsq")`` (the cluster engine wires the monitor)."""
    if name.startswith("health:"):
        return HealthAwareRouter(make_router(name[len("health:"):]))
    try:
        return ROUTERS[name]()
    except KeyError:
        raise ValueError(f"unknown router {name!r}; "
                         f"choose from {sorted(set(ROUTERS))} "
                         f"(optionally prefixed with 'health:')")
