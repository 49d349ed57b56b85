"""Multi-replica cluster serving on a shared virtual timeline.

:class:`ClusterEngine` drives N :class:`~repro_torch.serving.engine.EngineCore`
replicas as a discrete-event simulation: each replica owns a local
:class:`~repro_torch.serving.clock.VirtualClock` (replicas run concurrently in
real deployments, so their timelines advance independently), and the
cluster loop always services the earliest next event — a workload arrival
(routed + admission-checked, possibly spilling back to the cluster queue or
preempting a low-priority request), the lagging replica's next engine
iteration, a scheduled fault, or a completing cross-replica migration.
Replica cores may additionally preempt *internally* on OutOfPages pressure
(memory-elastic incremental page growth); both tiers share
:meth:`EngineCore.preempt` and are summed in ``ClusterReport.preemptions``.
Determinism: ties break on replica index, and all randomness lives inside
the per-replica backends and the pre-materialized
:class:`~repro_torch.common.faults.FaultPlan`.

Fault tolerance (PR 9)
----------------------
A ``fault_plan`` injects replica crashes, transient stalls, and
OutOfPages storms on the shared clock.  Recovery is tiered:

* **warned crash + migration** — on the crash warning the dying replica is
  drained: active requests are force-spilled to its host KV tier
  (decode state + RNG survive), then *migrated* to a healthy replica —
  the KV payload transfers host-to-host at ``recovery.migration_bw`` and
  the adopter's normal spill-resume admission swaps it in, resuming the
  exact trajectory (committed tokens bit-identical to a no-failure run).
* **unwarned loss / no host tier** — requests re-submit from scratch
  (prefix-cache-assisted re-prefill on the new replica); committed tokens
  are counted in ``lost_tokens`` honestly.
* **health-aware routing** — a :class:`~repro_torch.cluster.health.HealthMonitor`
  tracks down/degraded/rewarming labels; the
  :class:`~repro_torch.cluster.router.HealthAwareRouter` wrapper avoids sick
  replicas and the rewarming depth gate re-warms recovered ones gradually.
* **graceful degradation** — requests with deadlines are shed at dispatch
  (and while queued) when even the optimistic
  :func:`~repro_torch.cluster.admission.service_floor` cannot meet them, with a
  structured reason + ``retry_after`` hint; replicas absorbing failover
  load run their elastic scheduler in conservative (small-chunk) mode.

Spill-queue retries are bounded (``max_spill_retries``) with exponential
backoff on the virtual clock (``recovery.backoff``), folding starvation
into the structured reject accounting instead of ping-ponging forever.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.cluster.admission import (KVAdmissionPolicy, fits_ever,
                                     service_floor)
from repro_torch.cluster.health import HealthMonitor, RecoveryPolicy
from repro_torch.serving.engine import EngineCore
from repro_torch.serving.metrics import ClusterReport
from repro_torch.serving.request import Request
from repro_torch.serving.telemetry import NULL_TRACER


@dataclass
class ClusterEngine:
    replicas: list                      # [EngineCore]
    router: object
    admission: KVAdmissionPolicy = field(default_factory=KVAdmissionPolicy)
    enable_preemption: bool = False
    max_events: int = 50_000_000
    tracer: object = None               # shared with the replica cores
    # -- fault tolerance ------------------------------------------------
    fault_plan: object = None           # FaultPlan | None
    recovery: object = None             # RecoveryPolicy (defaulted below)
    health: object = None               # HealthMonitor (auto with faults)
    # Spill-retry budget: None = unbounded (the historical behavior for
    # fault-free runs); with a fault plan it defaults to 64 so failover
    # backlogs cannot ping-pong forever between saturated replicas.
    max_spill_retries: int | None = None

    def __post_init__(self):
        n = len(self.replicas)
        if n == 0:
            raise ValueError("cluster needs at least one replica")
        if self.tracer is None:
            self.tracer = NULL_TRACER
        if self.recovery is None:
            self.recovery = RecoveryPolicy()
        self.route_counts = [0] * n
        self.spill_events = 0
        self._spill: list[Request] = []
        self.rejected: list[Request] = []
        # structured reject/shed records: {"rid", "reason", "t", ...}
        self.rejections: list[dict] = []
        self.migrations = 0
        self.migrations_failed = 0
        self.resubmissions = 0
        self.lost_tokens = 0
        self.lost_computed_tokens = 0
        self.wiped_rids: set[int] = set()
        self.fault_log: list[dict] = []
        self._fault_ops = list(self.fault_plan.schedule()) \
            if self.fault_plan else []
        if self._fault_ops and self.max_spill_retries is None:
            self.max_spill_retries = 64
        self._down: set[int] = set()
        # in-flight migrations: (ready_t, Request, ticket, src_replica)
        self._migrating: list = []
        self._retry: dict[int, tuple[int, float]] = {}  # rid → (count, next_t)
        if self.health is False:        # explicit opt-out (naive baseline)
            self.health = None
        elif self.health is None and (
                self._fault_ops or
                getattr(self.router, "monitor", False) is None):
            self.health = HealthMonitor(n)
        if self.health is not None \
                and getattr(self.router, "monitor", "absent") is None:
            self.router.monitor = self.health

    # ------------------------------------------------------------------
    def run(self, requests) -> ClusterReport:
        arrivals = list(reversed(
            sorted(requests, key=lambda r: r.arrival_time)))
        events = 0
        while arrivals or self._spill or self._migrating or \
                any(not r.idle for r in self.replicas):
            events += 1
            if events > self.max_events:
                raise RuntimeError("cluster exceeded max_events")

            t_arr = arrivals[-1].arrival_time if arrivals else float("inf")
            t_fault = self._fault_ops[0][0] if self._fault_ops \
                else float("inf")
            t_mig = min((m[0] for m in self._migrating),
                        default=float("inf"))
            times = [r.next_event_time() for r in self.replicas]
            t_rep = min(times)

            if t_fault <= min(t_arr, t_rep, t_mig):
                self._apply_fault(*self._fault_ops.pop(0))
                continue

            if t_mig <= min(t_arr, t_rep):
                self._finish_migrations(t_mig)
                continue

            if arrivals and t_arr <= t_rep:
                self._observe(t_arr)
                self._dispatch(arrivals.pop())
                continue

            if t_rep == float("inf"):
                # Only spilled/migrating work remains and every replica is
                # idle: force-place on the emptiest routable pool so work
                # always resumes.  With every replica down, advance the
                # fault timeline (a recovery is what unblocks the queue) —
                # or fail the stranded work honestly if there is none.
                if not self._spill:
                    continue        # a migration completion is next
                if len(self._down) == len(self.replicas):
                    if self._fault_ops:
                        self._apply_fault(*self._fault_ops.pop(0))
                    else:
                        for req in self._spill:
                            self._reject(req, "pool_pressure",
                                         self._last_t(), cluster_down=True)
                        self._spill = []
                    continue
                self._force_dispatch(self._spill.pop(0))
                continue

            idx = times.index(t_rep)             # earliest; ties → low index
            core = self.replicas[idx]
            # spilled requests can only become placeable when a tick grows
            # the replica's admissible slack (free pages minus pages still
            # reserved for its queue) — skip the O(spill) re-rank
            # otherwise, it is the hot loop of the saturated regime
            slack_before = self._slack(core) if self._spill else None
            core.tick()
            if self._spill and (slack_before is None or
                                self._slack(core) > slack_before):
                self._retry_spill(core.clock.now())

        return ClusterReport(
            [r.report() for r in self.replicas],
            spills=self.spill_events,
            preemptions=sum(r.preemptions for r in self.replicas),
            route_counts=list(self.route_counts),
            rejected=[r.rid for r in self.rejected],
            rejections=list(self.rejections),
            migrations=self.migrations,
            migrations_failed=self.migrations_failed,
            resubmissions=self.resubmissions,
            lost_tokens=self.lost_tokens,
            lost_computed_tokens=self.lost_computed_tokens,
            wiped=sorted(self.wiped_rids),
            faults=list(self.fault_log))

    # ------------------------------------------------------------------
    def _last_t(self) -> float:
        return max((r.clock.now() for r in self.replicas), default=0.0)

    def _observe(self, now: float):
        fn = getattr(self.router, "observe", None)
        if fn is not None:
            fn(now)

    def _slack(self, core) -> float:
        kv = getattr(core.backend, "kv", None)
        if kv is None:
            return -core.queue_depth       # slot backends: retirements help
        return kv.free_pages - self.admission.reserved_pages(core)

    def _routable(self, idx: int, req: Request, now: float) -> bool:
        if idx in self._down:
            return False
        if self.health is not None and \
                not self.health.allows(idx, self.replicas[idx], now):
            return False
        return True

    def _place(self, req: Request, now: float | None = None) -> int:
        """Walk the router's ranking; place on the first live replica the
        admission policy accepts.  Returns the replica index or -1."""
        if now is None:
            now = req.arrival_time
        for idx in self.router.rank(self.replicas, req):
            if not self._routable(idx, req, now):
                continue
            core = self.replicas[idx]
            if self.admission.admissible(core, req):
                core.submit(req)
                self._mark_placed(idx, req)
                return idx
        return -1

    def _mark_placed(self, idx: int, req: Request, forced: bool = False):
        self.route_counts[idx] += 1
        core = self.replicas[idx]
        self.tracer.req("route", req.rid,
                        max(req.arrival_time, core.clock.now()),
                        idx, forced=forced)
        placed = getattr(self.router, "placed", None)
        if placed is not None:
            placed(idx, len(self.replicas))

    def _reject(self, req: Request, reason: str, t: float, **extra):
        self.rejected.append(req)
        self.rejections.append({"rid": req.rid, "reason": reason, "t": t,
                                **extra})
        self.tracer.req("reject", req.rid, t, 0, reason=reason, **extra)

    def _shed_check(self, req: Request, now: float) -> bool:
        """Deadline admission: shed (with a structured reason and a
        ``retry_after`` hint) when even the optimistic service floor on
        the best live replica cannot meet the request's deadline."""
        if req.deadline is None:
            return False
        floors = [service_floor(self.replicas[i], req)
                  for i in range(len(self.replicas))
                  if self._routable(i, req, now)]
        floor = min(floors) if floors else 0.0
        if now + floor <= req.deadline:
            return False
        self.rejected.append(req)
        self.rejections.append({"rid": req.rid, "reason": "deadline",
                                "t": now, "retry_after": floor,
                                "slo_class": req.slo_class})
        self.tracer.req("shed", req.rid, now, 0, reason="deadline",
                        retry_after=floor, slo_class=req.slo_class)
        return True

    def _dispatch(self, req: Request):
        now = req.arrival_time
        if not any(fits_ever(r, req) for r in self.replicas):
            # would queue forever: refuse early
            self._reject(req, "never_fits", now,
                         prompt_len=req.prompt_len,
                         max_new_tokens=req.max_new_tokens)
            return
        if self._shed_check(req, now):
            return
        if self._place(req, now) >= 0:
            return
        if self.enable_preemption and self._try_preempt(req):
            return
        self._queue_spill(req, now)

    def _queue_spill(self, req: Request, now: float):
        self._spill.append(req)
        self.spill_events += 1
        self.tracer.req("spill", req.rid, now, 0,
                        queue_len=len(self._spill))

    def _try_preempt(self, req: Request) -> bool:
        for idx in self.router.rank(self.replicas, req):
            if not self._routable(idx, req, req.arrival_time):
                continue
            core = self.replicas[idx]
            victims = self.admission.preemption_victims(core, req)
            if victims:
                for rid in victims:
                    core.preempt(rid, reason="cluster")
                # the preemptor's higher priority queues it ahead of the
                # victims it just evicted (EngineCore orders admission by
                # (-priority, arrival)), so the freed pages are its
                core.submit(req)
                self._mark_placed(idx, req)
                return True
        return False

    def _retry_spill(self, now: float | None = None):
        if now is None:
            now = self._last_t()
        self._observe(now)
        still = []
        for req in self._spill:
            count, next_t = self._retry.get(req.rid, (0, 0.0))
            if now < next_t:                    # backoff window still open
                still.append(req)
                continue
            if self._shed_check(req, now):      # deadline died in the queue
                self._retry.pop(req.rid, None)
                continue
            if self._place(req, now) >= 0:
                self._retry.pop(req.rid, None)
                continue
            count += 1
            if self.max_spill_retries is not None \
                    and count > self.max_spill_retries:
                self._reject(req, "pool_pressure", now, retries=count)
                self._retry.pop(req.rid, None)
                continue
            self._retry[req.rid] = (count, now + self.recovery.backoff(count))
            still.append(req)
        self._spill = still

    def _force_dispatch(self, req: Request):
        def free_pages(core):
            kv = getattr(core.backend, "kv", None)
            return kv.free_pages if kv is not None else 0

        live = [i for i in range(len(self.replicas)) if i not in self._down]
        idx = max(live, key=lambda i: (free_pages(self.replicas[i]), -i))
        self.replicas[idx].submit(req)
        self._retry.pop(req.rid, None)
        self._mark_placed(idx, req, forced=True)

    # ------------------------------------------------------------------
    # Fault timeline
    # ------------------------------------------------------------------
    def _apply_fault(self, t: float, op: str, ev):
        rep = ev.replica
        if rep >= len(self.replicas):
            return
        core = self.replicas[rep]
        self._observe(t)
        self.fault_log.append({"t": t, "op": op, "kind": ev.kind,
                               "replica": rep})
        if op == "warn":
            if self.recovery.migrate:
                self.tracer.instant("fault", t, rep, fault="warn")
                if self.health is not None:
                    # stop routing new work at the dying replica for the
                    # warn→crash window (crash() then marks it down)
                    self.health.mark(rep, "failing", t)
                self._drain(rep, t)
        elif op == "crash":
            self.tracer.instant("fault", t, rep, fault="crash",
                                duration=ev.duration)
            self._crash(rep, t, until=t + ev.duration)
        elif op == "recover":
            self._down.discard(rep)
            core.recover(t)
            if self.health is not None:
                self.health.recover(rep, t)
            self.tracer.instant("recover", t, rep, fault="crash")
            self._retry_spill(t)
        elif op == "stall":
            core.slow_until = t + ev.duration
            core.slow_factor = ev.slow_factor
            if self.health is not None:
                self.health.mark(rep, "degraded", t, until=t + ev.duration)
            self.tracer.instant("fault", t, rep, fault="stall",
                                slow_factor=ev.slow_factor,
                                duration=ev.duration)
        elif op == "stall_end":
            core.slow_factor = 1.0
            self.tracer.instant("recover", t, rep, fault="stall")
        elif op == "oom":
            kv = getattr(core.backend, "kv", None)
            seized = 0
            if kv is not None:
                seized = kv.seize_pages(int(ev.seize_frac * kv.free_pages))
            if self.health is not None:
                self.health.mark(rep, "degraded", t, until=t + ev.duration)
            self.tracer.instant("fault", t, rep, fault="oom",
                                seized_pages=seized, duration=ev.duration)
        elif op == "oom_end":
            kv = getattr(core.backend, "kv", None)
            released = kv.release_seized() if kv is not None else 0
            self.tracer.instant("recover", t, rep, fault="oom",
                                released_pages=released)
            self._retry_spill(t)

    def _drain(self, rep: int, t: float):
        """Crash warning with migration enabled: force-spill the dying
        replica's active requests to its host tier (keeping their decode
        state), then move everything off — spilled requests migrate,
        the rest re-route as fresh submissions."""
        core = self.replicas[rep]
        core.clock.advance_to(t)
        kv = getattr(core.backend, "kv", None)
        for req in core.active_requests():
            st = core.backend.state(req.rid)
            committed, computed = st.n_committed, st.computed_tokens
            core.preempt(req.rid, reason="drain", force_spill=True)
            if kv is None or not kv.is_spilled(req.rid):
                # discard path: progress is recomputed elsewhere — the
                # committed tokens are not lost to the user but the
                # compute is; count it so the bench stays honest
                self.lost_computed_tokens += computed
        self._evacuate(rep, t)

    def _crash(self, rep: int, t: float, until: float):
        core = self.replicas[rep]
        self._down.add(rep)
        if self.health is not None:
            self.health.crash(rep, t, until)
        active, pending = core.crash(t)
        kv = getattr(core.backend, "kv", None)
        # active requests die with the process: committed tokens are lost
        # (unwarned crash — nothing was drained)
        for req in active:
            try:
                self._wipe(req.rid, core.backend.state(req.rid), rep, t)
            except KeyError:
                pass
            self._redispatch(req, t)
        # pending spilled requests (engine preemption victims) still have
        # recoverable host-tier state — migrate when policy allows;
        # otherwise their preserved progress dies with the process too
        for req in pending:
            if self.recovery.migrate and kv is not None \
                    and kv.is_spilled(req.rid):
                ticket = core.backend.migrate_out(req.rid)
                if ticket is not None:
                    self._start_migration(req, ticket, rep, t)
                    continue
            try:
                self._wipe(req.rid, core.backend.state(req.rid), rep, t)
            except KeyError:
                pass
            self._redispatch(req, t)
        fn = getattr(core.backend, "crash_reset", None)
        if fn is not None:
            fn()

    def _evacuate(self, rep: int, t: float):
        """Move every queued request off a draining replica."""
        core = self.replicas[rep]
        kv = getattr(core.backend, "kv", None)
        for req in core.take_pending():
            if kv is not None and kv.is_spilled(req.rid):
                ticket = core.backend.migrate_out(req.rid)
                if ticket is not None:
                    self._start_migration(req, ticket, rep, t)
                    continue
            self._redispatch(req, t)

    def _wipe(self, rid: int, st, rep: int, t: float):
        """A request's preserved decode state died with the process: the
        compute is discarded, and if any tokens were already committed the
        user-visible stream restarts from scratch — record the rid so
        goodput can count the re-serve as an SLO violation."""
        self.lost_tokens += st.n_committed
        self.lost_computed_tokens += st.computed_tokens
        if st.n_committed > 0:
            self.wiped_rids.add(rid)
            self.tracer.req("wipe", rid, t, rep, lost=st.n_committed)

    def _redispatch(self, req: Request, t: float):
        """Re-submit a fault-displaced request (original arrival time —
        its TTFT keeps counting) through the normal routing path."""
        self.resubmissions += 1
        if self._shed_check(req, t):
            return
        idx = self._place(req, t)
        if idx >= 0:
            self.replicas[idx].note_failover(req.rid)
            return
        self._queue_spill(req, t)

    # ------------------------------------------------------------------
    # Cross-replica migration
    # ------------------------------------------------------------------
    def _start_migration(self, req: Request, ticket: dict, src: int,
                         t: float):
        page_bytes = getattr(self.replicas[src].backend, "_page_bytes", 0.0) \
            or 0.0
        delay = ticket["payload"]["n_pages"] * page_bytes \
            / max(self.recovery.migration_bw, 1e-9)
        self._migrating.append((t + delay, req, ticket, src))

    def _finish_migrations(self, t: float):
        ready = sorted((m for m in self._migrating if m[0] <= t),
                       key=lambda m: (m[0], m[1].rid))
        self._migrating = [m for m in self._migrating if m[0] > t]
        self._observe(t)
        for ready_t, req, ticket, src in ready:
            if self._adopt(req, ticket, src, ready_t):
                continue
            # no live replica can hold the payload: the preserved state is
            # lost — fall back to a from-scratch re-submission
            st = ticket.get("state")
            if st is not None:
                self._wipe(req.rid, st, src, ready_t)
            self.migrations_failed += 1
            self._redispatch(req, ready_t)

    def _adopt(self, req: Request, ticket: dict, src: int,
               t: float) -> bool:
        order = self.router.rank(self.replicas, req)
        # two passes: replicas with admission headroom first, then any
        # live replica whose host pool can hold the payload (the request
        # waits in its queue for pages — still better than losing state)
        for strict in (True, False):
            for idx in order:
                if not self._routable(idx, req, t):
                    continue
                core = self.replicas[idx]
                if strict and not self.admission.admissible(core, req):
                    continue
                if core.backend.migrate_in(req, ticket):
                    core.note_failover(req.rid)
                    core.submit(req)
                    self.migrations += 1
                    self._mark_placed(idx, req)
                    self.tracer.req(
                        "migrate", req.rid, t, idx, src=src,
                        pages=ticket["payload"]["n_pages"],
                        n_committed=getattr(ticket.get("state"),
                                            "n_committed", 0))
                    return True
        return False
