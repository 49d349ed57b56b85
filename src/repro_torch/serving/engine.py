"""Iteration-level continuous-batching serving engine with elastic decoding.

Every iteration: (1) admit arrived requests (FCFS, prefill-prioritized,
KV-pool admission control — the baselines' policy, §7.1); (2) ask the
scheduler for this iteration's chunk size given the live batch *and the
allocator's KV utilization* (memory-elastic chunking: smaller chunks commit
fewer speculative tokens per page claimed); (3) ensure the batch's
worst-case page growth fits — preempting victims (lowest priority, then
most remaining work) on :class:`OutOfPages` pressure, Fan et al.'s
evict+recompute; (4) run one batched decode step; (5) feed realized commits
back to the TU estimator; (6) retire finished requests.  This is the
paper's finer-than-block "update the batch at every decoding iteration"
scheduling (cf. LMDeploy), plus Optimus's chunk-size control loop.

The engine is split into a steppable :class:`EngineCore` — ``submit()`` /
``tick()`` / ``drain()`` against an externally owned clock — so a cluster
event loop can interleave N replica cores on a shared virtual timeline
(see :mod:`repro_torch.cluster`), and a thin :class:`ServingEngine` wrapper that
preserves the original single-replica ``run()`` API bit-for-bit.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field

import numpy as np

from repro_torch.serving.clock import VirtualClock
from repro_torch.serving.kv_pool import OutOfPages
from repro_torch.serving.request import Request, RequestMetrics
from repro_torch.serving.telemetry import NULL_TRACER


@dataclass
class EngineReport:
    metrics: list           # [RequestMetrics]
    chunk_history: list     # [(t, batch, chunk)]
    batch_history: list
    total_time: float
    decode_time: float
    total_tokens: int
    computed_tokens: int
    busy_time: float = 0.0  # clock time spent in prefill + decode steps
    preemptions: int = 0

    @property
    def throughput(self) -> float:
        """Output tokens per second over the decode span (paper §7.3)."""
        return self.total_tokens / max(self.decode_time, 1e-9)

    @property
    def token_utilization(self) -> float:
        return self.total_tokens / max(self.computed_tokens, 1)

    def tpot_percentile(self, q: float = 90.0) -> float:
        vals = [m.tpot for m in self.metrics if m.n_tokens > 0]
        return float(np.percentile(vals, q)) if vals else float("nan")

    def ttft_percentile(self, q: float = 90.0) -> float:
        vals = [m.ttft for m in self.metrics]
        return float(np.percentile(vals, q)) if vals else float("nan")


class EngineCore:
    """Steppable engine core: one replica's continuous-batching loop.

    The core never owns the simulation loop — the caller drives it:

        core.submit(requests)
        while core.tick():
            ...                     # interleave other replicas here
        report = core.report()

    ``tick()`` executes exactly one iteration of the classic engine loop
    (admission, then either one batched decode step or an idle clock jump to
    the next arrival) and returns ``False`` once there is no work left, so
    ``run()``-style draining and cluster-level interleaving share one code
    path.
    """

    def __init__(self, backend, scheduler, *, max_batch: int = 256,
                 clock=None, max_steps: int = 2_000_000, tracer=None,
                 preemption_cap: int = 8):
        self.backend = backend
        self.scheduler = scheduler
        self.max_batch = max_batch
        self.clock = clock if clock is not None else VirtualClock()
        self.max_steps = max_steps
        # Telemetry: the null tracer is a no-op *object*, so the hot loop
        # calls tracer.tick()/tracer.req() unconditionally — no scattered
        # `if tracing:` branches (see repro_torch.serving.telemetry).
        self.tracer = tracer if tracer is not None else NULL_TRACER
        # the backend's model step and graph cache open their spans on it
        set_tracer = getattr(backend, "set_tracer", None)
        if set_tracer is not None:
            set_tracer(self.tracer)
        self.replica = 0            # cluster factories stamp the index
        # Starvation guard: victim selection skips requests that already
        # ate ``preemption_cap`` evictions (each eviction discards all
        # decode progress — unbounded re-eviction can livelock a request).
        # Memory safety still wins: when EVERY candidate is at the cap the
        # guard yields rather than let the pool wedge.
        self.preemption_cap = preemption_cap
        # _pending is kept sorted DESCENDING by (-priority, arrival_time) so
        # that pop() yields the highest-priority, earliest arrival (FIFO
        # among equals).  With uniform priorities this is plain
        # arrival-order FCFS, matching the historical run() loop exactly;
        # with priorities it lets a preemptor admit ahead of the victim it
        # just evicted (whose arrival_time is necessarily older).
        self._pending: list[Request] = []
        # maintained min over pending arrival times: lazy-deletion heap
        # (push on submit, decref on admit-pop) so next_event_time() — which
        # the cluster loop calls for EVERY replica at EVERY event — is O(1)
        # amortized instead of an O(pending) scan per tick
        self._arrival_heap: list[float] = []
        self._arrival_live: dict[float, int] = {}
        self._active: list[Request] = []
        self._metrics: dict[int, RequestMetrics] = {}
        self._chunk_hist: list = []
        self._batch_hist: list = []
        self._done: list[RequestMetrics] = []
        self._first_decode_t = None
        self._steps = 0
        self._busy = 0.0
        self._max_itl = 0.0         # running stall gauge for the tracer
        self.preemptions = 0
        # fault injection: transient slowdown window (every step latency is
        # multiplied by slow_factor until slow_until) and the failover
        # backlog — rids re-routed here after a peer crash; the scheduler
        # runs in conservative mode until they are all admitted
        self.slow_until = 0.0
        self.slow_factor = 1.0
        self._failover: set[int] = set()

    # -- queue introspection (used by routers / admission policies) -------
    @property
    def idle(self) -> bool:
        return not (self._pending or self._active)

    @property
    def n_active(self) -> int:
        return len(self._active)

    @property
    def n_pending(self) -> int:
        return len(self._pending)

    @property
    def queue_depth(self) -> int:
        return len(self._pending) + len(self._active)

    def active_requests(self) -> list[Request]:
        return list(self._active)

    def pending_requests(self) -> list[Request]:
        return list(self._pending)

    def _arrival_track(self, t: float):
        heapq.heappush(self._arrival_heap, t)
        self._arrival_live[t] = self._arrival_live.get(t, 0) + 1

    def _arrival_untrack(self, t: float):
        n = self._arrival_live.get(t, 0) - 1
        if n > 0:
            self._arrival_live[t] = n
        else:
            self._arrival_live.pop(t, None)

    def _earliest_arrival(self) -> float:
        # _pending is priority-ordered, so the earliest arrival may sit
        # anywhere in it; the lazy-deletion heap keeps the min maintained
        # (entries whose live-count dropped to zero are popped on read)
        # instead of re-scanning all of _pending on every tick.
        heap = self._arrival_heap
        while heap and self._arrival_live.get(heap[0], 0) == 0:
            heapq.heappop(heap)
        return heap[0]

    def next_event_time(self) -> float:
        """Virtual time of this core's next actionable event (``inf`` when
        idle).  A busy core can act now; a core with only queued arrivals
        acts when the earliest one lands."""
        if self._active:
            return self.clock.now()
        if self._pending:
            return max(self.clock.now(), self._earliest_arrival())
        return float("inf")

    # -- submission -------------------------------------------------------
    @staticmethod
    def _queue_key(req: Request):
        return (-req.priority, req.arrival_time)

    def submit(self, req: Request):
        """Enqueue one request (binary insert, FIFO among equal keys)."""
        if req.rid not in self._metrics:    # first sighting, not a requeue
            self.tracer.req("submit", req.rid, req.arrival_time,
                            self.replica)
        p = self._pending
        key = self._queue_key(req)
        lo, hi = 0, len(p)
        while lo < hi:
            mid = (lo + hi) // 2
            if self._queue_key(p[mid]) > key:
                lo = mid + 1
            else:
                hi = mid
        p.insert(lo, req)
        self._arrival_track(req.arrival_time)

    def submit_all(self, requests):
        """Bulk submit; on an empty queue this reproduces the historical
        ``run()`` ordering exactly (stable sort; pure arrival order when
        priorities are uniform)."""
        if not self._pending:
            self._pending = list(reversed(
                sorted(requests, key=self._queue_key)))
            for r in self._pending:
                self._arrival_track(r.arrival_time)
                if r.rid not in self._metrics:
                    self.tracer.req("submit", r.rid, r.arrival_time,
                                    self.replica)
        else:
            for r in requests:
                self.submit(r)

    # -- the loop body -----------------------------------------------------
    def tick(self) -> bool:
        """Run one engine iteration.  Returns ``False`` when idle."""
        if self.idle:
            return False
        self._steps += 1
        if self._steps > self.max_steps:
            raise RuntimeError("engine exceeded max_steps")
        self.tracer.bind(self.clock, self.replica, self._steps)
        with self.tracer.span("engine.tick"):
            now = self.clock.now()
            self._admit(now)
            if not self._active:
                if self._pending:
                    self.clock.advance_to(self._earliest_arrival())
                return True
            self._decode_once()
        return True

    def drain(self):
        while self.tick():
            pass

    # -- admission (FCFS, prefill prioritized) -----------------------------
    def _next_admittable(self, now: float) -> int:
        """Index of the best queued request that has already arrived —
        scanning from the tail walks priority order; with uniform
        priorities the tail itself is the earliest arrival (plain FCFS)."""
        for i in range(len(self._pending) - 1, -1, -1):
            if self._pending[i].arrival_time <= now:
                return i
        return -1

    def _growth_headroom_ok(self, req: Request) -> bool:
        """Anti-thrash gate for incremental-growth backends: admitting a
        request must leave one free growth page per already-active request,
        else a preempted victim re-admits straight into the pressure that
        evicted it and the pool ping-pongs (evict → re-prefill → evict)."""
        if not getattr(self.backend, "grows_kv", False):
            return True
        kv = self.backend.kv
        free_after = kv.free_pages - self.backend.admit_pages(req)
        return free_after >= len(self._active)

    def _admit(self, now: float):
        while len(self._active) < self.max_batch:
            i = self._next_admittable(now)
            if i < 0 or not self.backend.can_admit(self._pending[i]) \
                    or not self._growth_headroom_ok(self._pending[i]):
                break
            req = self._pending.pop(i)
            with self.tracer.span("engine.admit", rid=req.rid):
                now = self._admit_one(req, now)

    def _admit_one(self, req: Request, now: float) -> float:
        """Admit ``req`` at ``now``; returns the clock after."""
        self._arrival_untrack(req.arrival_time)
        m = self._metrics.get(req.rid)
        if m is None:
            m = RequestMetrics(req.rid, req.arrival_time)
            self._metrics[req.rid] = m
        m.admit_time = now
        self._failover.discard(req.rid)
        self.tracer.req("admit", req.rid, now, self.replica,
                        wait=now - req.arrival_time,
                        n_preempts=m.preemptions)
        t0 = self.clock.now()
        prefill_lat = self.backend.admit(req) * self._slow_mult()
        self.clock.advance(prefill_lat)
        self._busy += self.clock.took(t0, prefill_lat)
        now = self.clock.now()
        st = self.backend.state(req.rid)
        if st.n_committed > 0 and m.first_token_time < 0:
            # recurrent-slot AR: prefill runs synchronously inside this
            # tick and commits the first token at admit.  Deferred
            # (paged) backends commit nothing here — their stamp comes
            # from the StepInfo of the tick the last prefill chunk
            # completes.
            m.first_token_time = now
            m.last_token_time = now
            self.tracer.req("first_token", req.rid, now, self.replica)
        self._active.append(req)
        return now

    # -- memory preemption (OutOfPages pressure relief) --------------------
    def _kv_utilization(self):
        """Allocator utilization for memory-aware chunking — only for
        backends with incremental page growth.  A static worst-case
        reservation cannot run out mid-decode, so feeding its (always-high)
        utilization to the scheduler would handicap chunk size for no
        memory-safety benefit."""
        if not getattr(self.backend, "grows_kv", False):
            return None
        kv = getattr(self.backend, "kv", None)
        return kv.utilization if kv is not None else None

    def preemption_count(self, rid: int) -> int:
        """Evictions this request has already suffered (0 if unknown) —
        read by the starvation guard and the cluster admission policy."""
        m = self._metrics.get(rid)
        return m.preemptions if m is not None else 0

    def _memory_victim(self) -> Request | None:
        """Victim for memory preemption: lowest priority first, then most
        remaining work (losing the least decode progress per page freed),
        then latest arrival.  Never the last active request — a lone
        request always fits (admission checks the full footprint against
        the whole pool).  Requests already at ``preemption_cap`` evictions
        are skipped while any under-cap candidate exists (starvation
        guard); if the whole batch is at the cap, memory safety wins and
        the guard is waived."""
        if len(self._active) <= 1:
            return None

        def remaining(req):
            try:
                done = self.backend.state(req.rid).n_committed
            except KeyError:
                done = 0
            return req.max_new_tokens - done

        pool = [r for r in self._active
                if self.preemption_count(r.rid) < self.preemption_cap] \
            or self._active
        return min(pool,
                   key=lambda r: (r.priority, -remaining(r),
                                  -r.arrival_time, -r.rid))

    def _preempt_for_memory(self) -> bool:
        victim = self._memory_victim()
        return victim is not None and self.preempt(victim.rid,
                                                   reason="memory")

    def _ensure_step_capacity(self, chunk: int):
        """Preempt until the batch's worst-case page growth for the next
        step fits the pool (no-op for backends without paged growth)."""
        deficit = getattr(self.backend, "step_page_deficit", None)
        if deficit is None:
            return
        while len(self._active) > 1:
            rids = [r.rid for r in self._active]
            if deficit(rids, chunk) <= 0:
                return
            if not self._preempt_for_memory():
                return

    # -- one elastic decode iteration --------------------------------------
    def _prefill_tick_tokens(self) -> int:
        """Prompt tokens the backend's chunked-prefill phase will mix into
        the next tick (0 for backends without deferred prefill)."""
        fn = getattr(self.backend, "prefill_tick_tokens", None)
        return fn() if fn is not None else 0

    def _decode_once(self):
        tr = self.tracer
        with tr.span("engine.select"):
            chunk = self._select()
        t0 = self.clock.now()
        with tr.span("engine.step"):
            while True:
                rids = [r.rid for r in self._active]
                try:
                    latency, infos = self.backend.decode_step(rids, chunk)
                    break
                except OutOfPages:
                    # decode_step reserves before mutating, so the step
                    # never partially ran — preempt a victim and retry it
                    if not self._preempt_for_memory():
                        raise
        latency *= self._slow_mult()
        b = len(self._active)
        self.clock.advance(latency)
        # the step's duration on the engine's clock: the backend's latency
        # on a virtual clock, the time it took on a wall clock
        dur = self.clock.took(t0, latency)
        self._busy += dur
        now = self.clock.now()
        if self._first_decode_t is None:
            self._first_decode_t = now - dur
        self._chunk_hist.append((now, b, chunk))
        self._batch_hist.append(b)
        with tr.span("engine.commit"):
            commits = self._commit(infos, now)
        tr.tick(self, now - dur, dur, b, chunk, commits)

    def _select(self) -> int:
        """This tick's chunk, with the pool's room for it made."""
        # b = the batch the decode dispatch will actually run: mid-prefill
        # requests are active but sit chunked-mode dispatches out — their
        # load reaches the scheduler through prefill_tokens, not b (double-
        # counting them would model a far bigger decode than dispatched)
        size_fn = getattr(self.backend, "decode_batch_size", None)
        b = size_fn([r.rid for r in self._active]) \
            if size_fn is not None else len(self._active)
        pf = self._prefill_tick_tokens()
        try:
            chunk = self.scheduler.select(b, kv_util=self._kv_utilization(),
                                          prefill_tokens=pf,
                                          conservative=bool(self._failover))
        except TypeError:           # scheduler predates the failover signal
            try:
                chunk = self.scheduler.select(
                    b, kv_util=self._kv_utilization(), prefill_tokens=pf)
            except TypeError:       # ... or the prefill signal
                try:
                    chunk = self.scheduler.select(
                        b, kv_util=self._kv_utilization())
                except TypeError:   # ... or the memory signal
                    chunk = self.scheduler.select(b)
        self._ensure_step_capacity(chunk)
        return chunk

    def _commit(self, infos, now: float) -> int:
        """Stamp the step's commits at ``now``, retire finished requests
        and feed the scheduler; returns the tokens committed."""
        commit_masks, valids = [], []
        still_active = []
        commits = 0
        for req in self._active:
            info = infos[req.rid]
            m = self._metrics[req.rid]
            if info.n_committed > 0:
                commits += info.n_committed
                # first_token_time lands the tick the commit happened — for
                # chunked prefill that is the tick the LAST prompt chunk
                # completed (the backend surfaces the prefill-derived AR
                # token in that tick's StepInfo), not admission time
                if m.first_token_time < 0:
                    m.first_token_time = now
                    self.tracer.req("first_token", req.rid, now,
                                    self.replica)
                else:
                    itl = now - m.last_token_time
                    m.max_itl = max(m.max_itl, itl)
                    self._max_itl = max(self._max_itl, itl)
                m.last_token_time = now
            if info.valid_len > 0:
                commit_masks.append(info.commit_mask)
                valids.append(info.valid_len)
            if info.done:
                st = self.backend.state(req.rid)
                m.finish_time = now
                m.n_tokens = st.n_committed
                # += so work discarded by earlier preemptions stays counted
                m.computed_tokens += st.computed_tokens
                m.decode_steps += st.steps
                self._done.append(m)
                self.backend.release(req.rid)
                self.tracer.req("finish", req.rid, now, self.replica,
                                n_tokens=m.n_tokens,
                                preemptions=m.preemptions)
            else:
                still_active.append(req)
        self._active = still_active
        self.scheduler.observe(commit_masks, valids)
        return commits

    # -- fault injection / failover support --------------------------------
    def _slow_mult(self) -> float:
        """Latency multiplier while a transient-stall fault is active."""
        if self.slow_factor > 1.0 and self.clock.now() < self.slow_until:
            return self.slow_factor
        return 1.0

    def note_failover(self, rid: int):
        """Flag a request re-routed here after a peer fault; the scheduler
        stays in conservative (small-chunk) mode until every flagged rid
        has been admitted — the pool is absorbing a dead replica's working
        set, so the per-step speculative page reservation is trimmed."""
        self._failover.add(rid)

    def take_pending(self) -> list[Request]:
        """Remove and return every queued (not yet admitted) request, in
        arrival order — the cluster re-routes them after a fault."""
        out = sorted(self._pending, key=lambda r: (r.arrival_time, r.rid))
        for r in out:
            self._arrival_untrack(r.arrival_time)
        self._pending = []
        return out

    def crash(self, now: float):
        """Replica process death at ``now``: every in-flight request is
        handed back to the caller as ``(active, pending)`` for re-routing.
        The backend is deliberately left untouched — the cluster harvests
        migratable host-spilled state (``backend.migrate_out``) first,
        then wipes it with ``backend.crash_reset()``.  In-flight metrics
        stay local: a dead replica's partial timings never reach the
        report (survivor metrics restart on the adopting replica, with
        TTFT still measured from the original arrival)."""
        self.clock.advance_to(now)
        active, self._active = self._active, []
        self._failover.clear()
        return active, self.take_pending()

    def recover(self, now: float):
        """Bring a crashed replica back at ``now`` (empty, cold)."""
        self.clock.advance_to(now)

    # -- preemption (cluster or memory KV-pressure relief) -----------------
    def preempt(self, rid: int, reason: str = "cluster",
                force_spill: bool = False) -> bool:
        """Evict an active request.  When the backend has a host KV tier
        and its cost model says the transfer wins, the pages are *spilled*
        (``backend.spill``): decode state survives, re-admission swaps the
        pages back in, and no work is discarded.  Otherwise fall back to
        evict+recompute (Fan et al.): release the backend state, requeue,
        and re-prefill from scratch.

        Bookkeeping: TTFT stays measured from the request's FIRST admission
        (the user saw that token; eviction doesn't un-serve it).  On the
        discard path the banked ``computed_tokens`` / ``decode_steps`` keep
        the wasted work in token-utilization and re-admission charges the
        re-prefill latency through ``backend.admit``; on the spill path
        nothing is banked (nothing is recomputed) and re-admission charges
        only the swap-in transfer time."""
        for i, req in enumerate(self._active):
            if req.rid == rid:
                self._active.pop(i)
                st = self.backend.state(rid)
                m = self._metrics[rid]
                kv = getattr(self.backend, "kv", None)
                pages = 0
                if kv is not None:
                    try:
                        pages = kv.table_len(rid)
                    except KeyError:
                        pages = 0
                spill_fn = getattr(self.backend, "spill", None)
                if force_spill and spill_fn is not None:
                    spilled = bool(spill_fn(rid, force=True))
                else:
                    spilled = bool(spill_fn and spill_fn(rid))
                if not spilled:
                    # bank the wasted compute so token_utilization reflects
                    # the recompute cost of eviction
                    m.computed_tokens += st.computed_tokens
                    m.decode_steps += st.steps
                m.preemptions += 1
                self.tracer.req("preempt", rid, self.clock.now(),
                                self.replica, reason=reason,
                                pages_freed=pages,
                                n_committed=st.n_committed,
                                spilled=spilled,
                                preemptions=m.preemptions)
                if not spilled:
                    self.backend.release(rid)
                self.preemptions += 1
                self.submit(req)
                return True
        return False

    # -- results -----------------------------------------------------------
    def report(self) -> EngineReport:
        total_tokens = sum(m.n_tokens for m in self._done)
        computed = sum(m.computed_tokens for m in self._done)
        end = self.clock.now()
        decode_span = end - (self._first_decode_t or 0.0)
        return EngineReport(self._done, self._chunk_hist, self._batch_hist,
                            end, max(decode_span, 1e-9), total_tokens,
                            computed, busy_time=self._busy,
                            preemptions=self.preemptions)


class ServingEngine:
    """Single-replica façade: the historical blocking ``run()`` API, now a
    thin wrapper over :class:`EngineCore`."""

    def __init__(self, backend, scheduler, *, max_batch: int = 256,
                 clock=None, max_steps: int = 2_000_000, tracer=None):
        self.backend = backend
        self.scheduler = scheduler
        self.max_batch = max_batch
        self.clock = clock if clock is not None else VirtualClock()
        self.max_steps = max_steps
        self.tracer = tracer

    def run(self, requests) -> EngineReport:
        core = EngineCore(self.backend, self.scheduler,
                          max_batch=self.max_batch, clock=self.clock,
                          max_steps=self.max_steps, tracer=self.tracer)
        core.submit_all(requests)
        core.drain()
        return core.report()
