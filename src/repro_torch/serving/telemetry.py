"""Serving telemetry: per-tick event timeline, request lifecycle spans,
scheduler decision logs, and Chrome/Perfetto trace export.

The serving stack's control loop is *closed*: the elastic scheduler picks a
chunk size every tick from runtime signals (live batch, KV utilization,
queued prefill), admission and preemption react to allocator pressure, and
the router reads saturation estimates.  End-of-run aggregates cannot answer
"why did the scheduler choose ``c`` at tick ``t``" or "which tick did this
preemption cascade from" — this module records exactly those trajectories.

Design: one :class:`Tracer` object is shared by an engine core (or a whole
cluster of cores) and holds a bounded ring buffer of compact event tuples.
The hot decode loop calls ``tracer.tick(core, t0, dur, b, chunk)`` and
``tracer.req(kind, rid, t, ...)`` unconditionally — the **null tracer** is a
no-op *object* (:data:`NULL_TRACER`, the default), so the disabled path is
a couple of empty method calls per tick with no conditionals scattered
through the loop.  All expensive gathering (backend counter deltas,
allocator gauges, scheduler decision dicts) happens *inside*
:meth:`Tracer.tick`, which the null tracer never runs.

Event kinds
-----------
``tick``  — one engine iteration: start time, duration, dispatched batch,
            chosen chunk, the full scheduler decision (inputs *and* the
            internal state that chose the output — enough to replay
            ``ElasticScheduler.select``, see :func:`replay_select`),
            cumulative backend counters (dispatches, host-transfer bytes,
            prefill tokens) and allocator gauge snapshots.
``submit`` / ``admit`` / ``prefill_chunk`` / ``first_token`` / ``finish``
          — request lifecycle; :func:`build_spans` derives per-request
            spans (submit → admit → prefill chunks → first token → decode
            → finish) from them.
``preempt`` — eviction with victim rid, reason (``memory`` | ``cluster``)
            and pages freed.
``route`` / ``spill`` / ``reject`` — cluster-tier placement decisions.

``span``  — a host span, in a ring of its own: name, start, end, the span
            it nests in, the engine tick and replica, and its arguments
            (an admission's ``rid``, a dispatch's ``batch`` and
            ``tokens``).  :class:`EngineCore` opens one per layer boundary
            (``engine.tick`` holding ``engine.admit``, ``engine.select``,
            ``engine.step`` and ``engine.commit``) and hands the tracer to
            the backend, whose model step (``prefill.*``, ``decode.*``,
            ``kv.*``, ``slot.*``) and graph cache (``graph.*``) open theirs
            inside ``engine.step``.  Spans are timed on the engine's clock,
            which :meth:`Tracer.bind` sets each tick; while a
            ``torch.profiler`` session records, each span is also a
            ``record_function`` range of the same name, on the profiler's
            clock beside the device's kernels.

Exporters: :meth:`Tracer.to_jsonl` (one JSON object per line; the analyzer
CLI ``python -m repro_torch.launch.trace_view`` consumes this) and
:meth:`Tracer.to_perfetto` (Chrome ``trace_event`` JSON loadable in
https://ui.perfetto.dev — one process per replica with a tick track,
request async spans, and counter tracks for ``kv_util``, ``bc``,
``prefill_backlog``, ``pages_in_use``, ``host_transfer_bytes``,
``dispatches``, ``max_itl``, the prefix-cache / tiered-KV series
(``prefix_hits``/``prefix_misses``/``prefix_hit_tokens``,
``pages_shared``, ``cow_copies``, ``swap_in_bytes``/``swap_out_bytes``),
the graph cache's ``graph_captures`` / ``graph_capture_s`` /
``graph_replays``, and — for sharded page pools — per-device
``device_dispatches`` / ``collective_bytes`` plus one
``pages_in_use/shard<i>`` track per KV shard; spans are nested ``X``
events on a ``host spans`` thread).  The JSONL holds no spans.
:func:`validate_trace_events` is an in-repo catapult-format checker used
by CI's trace smoke job.
"""

from __future__ import annotations

import json
import sys
from collections import deque

from repro_torch.serving.clock import WallClock


class _NullSpan:
    """The null tracer's one span: enters and leaves, records nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class NullTracer:
    """No-op tracer: the default wired into every engine.  Every method is
    an empty body, and ``span`` hands back one preallocated no-op context
    (no clock read, no span object), so the untraced hot path costs one
    attribute lookup and one no-op call per instrumentation point and one
    ``with`` per span.  Measured on the H100 by untraced benchmark runs of
    this code against the code before the spans, in turns (PERF.md,
    section 6: "Cost")."""

    enabled = False

    def span(self, name, **args):
        return _NULL_SPAN

    def bind(self, clock, replica=0, tick=0):
        pass

    def tick(self, core, t0, dur, b, chunk, commits=0):
        pass

    def req(self, kind, rid, t, replica=0, **payload):
        pass

    def counter(self, name, t, value, replica=0):
        pass

    def instant(self, kind, t, replica=0, **payload):
        pass

    def export(self, path):
        pass


NULL_TRACER = NullTracer()


# Tick-payload counter fields promoted to Perfetto counter tracks — the
# tracer's counter registry.  Cumulative backend counters
# (``host_transfer_bytes``, ``decode_dispatches``, ``prefill_dispatches``)
# and the running ``max_itl`` stall gauge flow through here instead of only
# appearing in end-of-run reports; ad-hoc series can be added at runtime
# with :meth:`Tracer.counter`.
#
# Dispatch counters are *logical* (one per tick phase) regardless of KV
# sharding — a split-KV step across N shards is still one decode dispatch.
# The per-device view gets its own cumulative tracks: ``device_dispatches``
# (logical × kv_shards) and ``collective_bytes`` (cross-shard flash-partial
# merge traffic, 0 when unsharded).  Sharded allocators additionally emit
# one dynamic ``pages_in_use/shard<i>`` track per shard from their gauges.
COUNTER_FIELDS = ("kv_util", "bc", "prefill_backlog", "pages_in_use",
                  "host_transfer_bytes", "decode_dispatches",
                  "prefill_dispatches", "device_dispatches",
                  "collective_bytes", "max_itl",
                  # prefix-cache / tiered-KV tracks (PR 8): cumulative
                  # hit/miss counts, live shared-page gauge, COW copies and
                  # host-tier swap traffic in bytes
                  "prefix_hits", "prefix_misses", "prefix_hit_tokens",
                  "pages_shared", "cow_copies", "swap_in_bytes",
                  "swap_out_bytes",
                  # the graph cache: graphs captured, host seconds spent
                  # capturing them (warm run included), replays
                  "graph_captures", "graph_capture_s", "graph_replays")


def _profiler_range(name: str):
    """An entered ``record_function`` range named ``name`` while a
    ``torch.profiler`` session records, else None.  No session can record
    in a process that has not imported torch."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.autograd._profiler_enabled():
        return None
    rf = torch.profiler.record_function(name)
    rf.__enter__()
    return rf


class _Span:
    """One open span of a :class:`Tracer` (see :meth:`Tracer.span`)."""

    __slots__ = ("tr", "name", "args", "id", "parent", "t0", "rf")

    def __init__(self, tr, name, args):
        self.tr, self.name, self.args = tr, name, args

    def __enter__(self):
        tr = self.tr
        self.parent = tr._open[-1] if tr._open else None
        self.id = tr._next_span
        tr._next_span += 1
        tr._open.append(self.id)
        self.rf = _profiler_range(self.name)
        self.t0 = tr._now()
        return self

    def __exit__(self, *exc):
        tr = self.tr
        t1 = tr._now()
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        tr._open.pop()
        if len(tr.spans) == tr.max_events:
            tr.spans_dropped += 1
        tr.spans.append((self.name, self.t0, t1, self.id, self.parent,
                         tr._tick, tr._replica, self.args))
        return False


class Tracer:
    """Ring-buffered serving event recorder.

    ``max_events`` bounds memory: the buffer is a deque ring, oldest events
    are dropped first and counted in ``dropped`` (a truncated trace is
    still a valid trace of its suffix).  Host spans keep a second ring of
    the same length, their drops counted in ``spans_dropped``."""

    enabled = True

    def __init__(self, max_events: int = 1 << 20):
        self.max_events = max_events
        self.events: deque = deque(maxlen=max_events)
        self.dropped = 0
        self._prev_counters: dict[int, dict] = {}
        # host spans: a ring of their own, as long, drops counted apart
        self.spans: deque = deque(maxlen=max_events)
        self.spans_dropped = 0
        self._clock = WallClock()       # until an engine binds its own
        self._replica = 0
        self._tick = 0
        self._open: list = []           # ids of the open spans, innermost last
        self._next_span = 0

    # -- recording ------------------------------------------------------
    def _append(self, ev: tuple):
        if len(self.events) == self.max_events:
            self.dropped += 1
        self.events.append(ev)

    def tick(self, core, t0, dur, b, chunk, commits=0):
        """Record one engine iteration.  All gathering happens here — the
        caller only passes scalars it already had in registers."""
        replica = getattr(core, "replica", 0)
        backend = core.backend
        decision = getattr(core.scheduler, "last_decision", None)
        counters = {}
        fn = getattr(backend, "telemetry_counters", None)
        if fn is not None:
            counters = fn()
        kv = getattr(backend, "kv", None)
        gauges = kv.gauges() if kv is not None else {}
        # per-tick prefill chunk assignments become lifecycle events
        for prid, off, n in getattr(backend, "last_prefill_plan", ()):
            self._append(("req", "prefill_chunk", prid, t0, replica,
                          {"offset": off, "n_tokens": n}))
        self._append(("tick", replica, t0, dur, {
            "b": b, "chunk": chunk, "commits": commits,
            "max_itl": getattr(core, "_max_itl", 0.0),
            "decision": decision, "counters": counters, "gauges": gauges}))

    def req(self, kind, rid, t, replica=0, **payload):
        self._append(("req", kind, rid, t, replica, payload))

    def counter(self, name, t, value, replica=0):
        """Ad-hoc counter sample (becomes its own Perfetto counter track)."""
        self._append(("counter", name, t, value, replica))

    def instant(self, kind, t, replica=0, **payload):
        """Replica-scoped instant with no request id (fault injections,
        recoveries) — rendered as a Perfetto ``i`` event, never a span."""
        self._append(("inst", kind, t, replica, payload))

    def bind(self, clock, replica=0, tick=0):
        """Time the spans that follow on ``clock``, under ``replica`` and
        engine tick ``tick`` (``EngineCore.tick`` binds its own at the
        start of every tick; until then spans read a ``WallClock`` made
        with the tracer)."""
        self._clock, self._replica, self._tick = clock, replica, tick

    def _now(self) -> float:
        return self._clock.now()

    def span(self, name, **args):
        """A context manager recording one host span: ``name``, its start
        and end on the bound clock, the span open around it (``parent``),
        the tick and replica, and ``args``."""
        return _Span(self, name, args)

    def span_records(self) -> list[dict]:
        """Spans as flat dicts, in the order they ended (a parent after
        its children): ``name``, ``t0``, ``t1``, ``id``, ``parent`` (None
        at the top), ``tick``, ``replica``, ``args``."""
        return [{"name": n, "t0": t0, "t1": t1, "id": i, "parent": p,
                 "tick": k, "replica": r, "args": a}
                for n, t0, t1, i, p, k, r, a in self.spans]

    # -- record → dict view ---------------------------------------------
    def records(self) -> list[dict]:
        """Events as flat dicts (the JSONL line format)."""
        out = []
        for ev in self.events:
            if ev[0] == "tick":
                _, replica, t0, dur, payload = ev
                d = {"kind": "tick", "replica": replica, "t": t0,
                     "dur": dur}
                d.update(payload)
            elif ev[0] == "req":
                _, kind, rid, t, replica, payload = ev
                d = {"kind": kind, "rid": rid, "t": t, "replica": replica}
                d.update(payload)
            elif ev[0] == "inst":
                _, kind, t, replica, payload = ev
                d = {"kind": kind, "t": t, "replica": replica}
                d.update(payload)
            else:
                _, name, t, value, replica = ev
                d = {"kind": "counter", "name": name, "t": t,
                     "value": value, "replica": replica}
            out.append(d)
        return out

    # -- exporters ------------------------------------------------------
    def to_jsonl(self, path: str):
        with open(path, "w") as f:
            f.write(json.dumps({"kind": "meta", "version": 1,
                                "dropped": self.dropped,
                                "n_events": len(self.events)}) + "\n")
            for rec in self.records():
                f.write(json.dumps(rec, default=float) + "\n")
        return path

    def to_perfetto(self, path: str | None = None) -> dict:
        """Chrome ``trace_event`` JSON (JSON-object format).  One process
        per replica: tid 0 carries the tick timeline (``X`` events whose
        args hold the full scheduler decision), request lifecycle spans are
        async ``b``/``n``/``e`` events keyed by rid, and every
        :data:`COUNTER_FIELDS` entry becomes a ``C`` counter track."""
        te = perfetto_events(self.records())
        te += span_events(self.span_records())
        doc = {"traceEvents": te, "displayTimeUnit": "ms",
               "otherData": {"source": "repro_torch.serving.telemetry",
                             "dropped_events": self.dropped}}
        if self.spans or self.spans_dropped:
            doc["otherData"]["dropped_spans"] = self.spans_dropped
        if path is not None:
            with open(path, "w") as f:
                json.dump(doc, f, default=float)
        return doc

    def export(self, path: str):
        """Write both formats: ``<path>`` (JSONL event log) and
        ``<path minus suffix>.perfetto.json`` (Perfetto trace)."""
        self.to_jsonl(path)
        base = path[:-len(".jsonl")] if path.endswith(".jsonl") else path
        self.to_perfetto(base + ".perfetto.json")
        return path, base + ".perfetto.json"


def load_jsonl(path: str) -> list[dict]:
    """Read a tracer JSONL event log (meta line skipped)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if rec.get("kind") != "meta":
                out.append(rec)
    return out


# ===========================================================================
# Perfetto / Chrome trace_event export + in-repo format checker
# ===========================================================================

_US = 1e6          # virtual seconds → trace microseconds

REQUEST_EVENT_KINDS = ("submit", "admit", "prefill_chunk", "first_token",
                       "finish", "preempt", "route", "spill", "reject",
                       "shed", "migrate", "wipe")
_INSTANT_KINDS = ("prefill_chunk", "preempt", "route", "spill", "reject",
                  "first_token", "shed", "migrate", "wipe", "fault",
                  "recover")


def perfetto_events(records: list[dict]) -> list[dict]:
    replicas = sorted({r.get("replica", 0) for r in records}) or [0]
    te = []
    for r in replicas:
        te.append({"ph": "M", "name": "process_name", "pid": r, "tid": 0,
                   "args": {"name": f"replica {r}"}})
        te.append({"ph": "M", "name": "thread_name", "pid": r, "tid": 0,
                   "args": {"name": "engine ticks"}})
    started: set = set()
    for rec in records:
        kind = rec["kind"]
        pid = rec.get("replica", 0)
        if kind == "tick":
            ts = rec["t"] * _US
            args = {"b": rec.get("b"), "chunk": rec.get("chunk"),
                    "commits": rec.get("commits")}
            if rec.get("decision"):
                args["decision"] = rec["decision"]
            te.append({"ph": "X", "name": "tick", "cat": "engine",
                       "pid": pid, "tid": 0, "ts": ts,
                       "dur": max(rec.get("dur", 0.0), 0.0) * _US,
                       "args": args})
            for name, value in _tick_counters(rec):
                te.append({"ph": "C", "name": name, "pid": pid, "tid": 0,
                           "ts": ts, "args": {"value": value}})
        elif kind == "counter":
            te.append({"ph": "C", "name": rec["name"], "pid": pid,
                       "tid": 0, "ts": rec["t"] * _US,
                       "args": {"value": rec["value"]}})
        elif kind in ("submit", "admit"):
            rid = rec["rid"]
            ph = "b" if rid not in started else "n"
            if ph == "b":
                started.add(rid)
            te.append({"ph": ph, "id": rid, "cat": "request",
                       "name": f"req {rid}", "pid": pid, "tid": 0,
                       "ts": rec["t"] * _US,
                       "args": {"event": kind}})
        elif kind == "finish":
            rid = rec["rid"]
            if rid not in started:       # span begin fell off the ring
                continue
            te.append({"ph": "e", "id": rid, "cat": "request",
                       "name": f"req {rid}", "pid": pid, "tid": 0,
                       "ts": rec["t"] * _US,
                       "args": {"event": "finish"}})
        elif kind in _INSTANT_KINDS:
            args = {k: v for k, v in rec.items()
                    if k not in ("kind", "t", "replica")}
            te.append({"ph": "i", "name": kind, "cat": "request",
                       "pid": pid, "tid": 0, "ts": rec["t"] * _US,
                       "s": "p", "args": args})
    return te


SPAN_TID = 1       # the host-spans thread of each replica's process


def span_events(spans: list[dict]) -> list[dict]:
    """Host spans (:meth:`Tracer.span_records`) as ``X`` events on each
    replica's ``host spans`` thread; Perfetto nests them by time."""
    te = [{"ph": "M", "name": "thread_name", "pid": r, "tid": SPAN_TID,
           "args": {"name": "host spans"}}
          for r in sorted({s["replica"] for s in spans})]
    for s in sorted(spans, key=lambda s: (s["t0"], s["id"])):
        te.append({"ph": "X", "name": s["name"], "cat": "span",
                   "pid": s["replica"], "tid": SPAN_TID, "ts": s["t0"] * _US,
                   "dur": max(s["t1"] - s["t0"], 0.0) * _US,
                   "args": {"tick": s["tick"], "id": s["id"],
                            "parent": s["parent"], **s["args"]}})
    return te


def _tick_counters(rec: dict):
    gauges = rec.get("gauges") or {}
    counters = rec.get("counters") or {}
    decision = rec.get("decision") or {}
    vals = {
        "kv_util": gauges.get("utilization"),
        "pages_in_use": gauges.get("pages_in_use"),
        "bc": (rec.get("b") or 0) * (rec.get("chunk") or 0),
        "prefill_backlog": counters.get("prefill_backlog",
                                        decision.get("prefill_tokens")),
        "host_transfer_bytes": counters.get("host_transfer_bytes"),
        "decode_dispatches": counters.get("decode_dispatches"),
        "prefill_dispatches": counters.get("prefill_dispatches"),
        "device_dispatches": counters.get("device_dispatches"),
        "collective_bytes": counters.get("collective_bytes"),
        "max_itl": rec.get("max_itl"),
        "prefix_hits": counters.get("prefix_hits"),
        "prefix_misses": counters.get("prefix_misses"),
        "prefix_hit_tokens": counters.get("prefix_hit_tokens"),
        "pages_shared": counters.get("pages_shared"),
        "cow_copies": counters.get("cow_copies"),
        "swap_in_bytes": counters.get("swap_in_bytes"),
        "swap_out_bytes": counters.get("swap_out_bytes"),
        "graph_captures": counters.get("graph_captures"),
        "graph_capture_s": counters.get("graph_capture_s"),
        "graph_replays": counters.get("graph_replays"),
    }
    out = [(name, v) for name in COUNTER_FIELDS
           if (v := vals.get(name)) is not None]
    # sharded page pool: one per-shard utilization track per shard
    for i, used in enumerate(gauges.get("shard_pages_in_use") or ()):
        out.append((f"pages_in_use/shard{i}", used))
    return out


_PHASES = {"X", "B", "E", "i", "I", "C", "b", "n", "e", "M", "s", "t", "f",
           "P", "N", "O", "D"}


def validate_trace_events(doc) -> list[str]:
    """In-repo catapult ``trace_event`` format checker.  Accepts the parsed
    JSON-object-format document (or a path) and returns a list of
    violations — empty means the trace is loadable by Perfetto/catapult."""
    if isinstance(doc, str):
        with open(doc) as f:
            doc = json.load(f)
    errors = []
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        return ["document is not an object with a 'traceEvents' array"]
    evs = doc["traceEvents"]
    if not isinstance(evs, list):
        return ["'traceEvents' is not an array"]
    for i, ev in enumerate(evs):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            errors.append(f"{where}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in _PHASES:
            errors.append(f"{where}: unknown phase {ph!r}")
            continue
        if not isinstance(ev.get("name", ""), str):
            errors.append(f"{where}: non-string name")
        if not isinstance(ev.get("pid", 0), int):
            errors.append(f"{where}: non-integer pid")
        if ph != "M":
            ts = ev.get("ts")
            if not isinstance(ts, (int, float)):
                errors.append(f"{where}: phase {ph} missing numeric ts")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errors.append(f"{where}: X event needs dur >= 0")
        if ph == "C":
            args = ev.get("args")
            if not isinstance(args, dict) or not args or \
                    not all(isinstance(v, (int, float))
                            for v in args.values()):
                errors.append(f"{where}: C event needs numeric args")
        if ph in ("b", "n", "e"):
            if "id" not in ev or not isinstance(ev.get("cat", ""), str) \
                    or not ev.get("cat"):
                errors.append(f"{where}: async event needs id and cat")
    return errors


# ===========================================================================
# Scheduler decision replay
# ===========================================================================

class _ReplayTU:
    """Token-utilization stub returning the logged per-candidate estimates
    (JSON turns int keys into strings; accept both)."""

    def __init__(self, estimates: dict):
        self._est = {int(k): float(v) for k, v in estimates.items()}

    def estimate(self, c: int) -> float:
        return self._est[int(c)]

    def update_batch(self, commit_masks, valid_lens):
        pass


def replay_select(scheduler, decision: dict) -> int:
    """Re-run ``ElasticScheduler.select`` from a logged tick decision.

    ``scheduler`` supplies the static configuration (latency model,
    candidate set, hysteresis, memory knee) — exactly what a run's
    construction path pins; the logged decision supplies the dynamic state
    (per-candidate TU estimates, the hysteresis incumbent) and the inputs
    (``b``, ``kv_util``, ``prefill_tokens``).  Returns the replayed chunk,
    which must equal ``decision["chunk"]`` for a faithful log."""
    if decision.get("policy") == "fixed":
        return decision["chunk"]
    from repro_torch.core.scheduler import ElasticScheduler
    sch = ElasticScheduler(scheduler.latency_model,
                           _ReplayTU(decision["tu"]),
                           tuple(scheduler.candidates),
                           hysteresis=scheduler.hysteresis,
                           memory_lo=scheduler.memory_lo,
                           memory_hi=scheduler.memory_hi,
                           failover_margin=getattr(
                               scheduler, "failover_margin", 0.15),
                           conservative_cap=getattr(
                               scheduler, "conservative_cap", None))
    sch._current = decision["cur"]
    return sch.select(decision["b"], kv_util=decision["kv_util"],
                      prefill_tokens=decision["prefill_tokens"],
                      conservative=decision.get("conservative", False))


# ===========================================================================
# Offline analysis (consumed by repro_torch.launch.trace_view and tests)
# ===========================================================================

def build_spans(records: list[dict]) -> dict[int, dict]:
    """Per-request lifecycle spans derived from the event log.

    Returns ``{rid: span}`` where each span has ``submit`` (first seen),
    ``admits`` (every (re-)admission tick), ``prefill_chunks``
    ``[(t, offset, n)]``, ``first_token``, ``preempts`` ``[(t, reason)]``,
    ``finish``, ``replica`` (last placement) and the derived breakdown:
    ``queue_wait`` (submit → first admit), ``prefill_time`` (first admit →
    first token), ``decode_time`` (first token → finish), ``ttft`` and
    ``n_preempts``."""
    spans: dict[int, dict] = {}

    def span(rid):
        return spans.setdefault(rid, {
            "rid": rid, "submit": None, "admits": [], "prefill_chunks": [],
            "first_token": None, "preempts": [], "finish": None,
            "replica": None})

    for rec in records:
        kind = rec["kind"]
        if kind == "tick" or kind == "counter" or "rid" not in rec:
            continue
        s = span(rec["rid"])
        t = rec["t"]
        if kind == "submit":
            s["submit"] = t if s["submit"] is None else min(s["submit"], t)
        elif kind == "admit":
            s["admits"].append(t)
            s["replica"] = rec.get("replica", s["replica"])
        elif kind == "prefill_chunk":
            s["prefill_chunks"].append((t, rec.get("offset"),
                                        rec.get("n_tokens")))
        elif kind == "first_token":
            if s["first_token"] is None:
                s["first_token"] = t
        elif kind == "preempt":
            s["preempts"].append((t, rec.get("reason", "?")))
        elif kind == "finish":
            s["finish"] = t
            s["replica"] = rec.get("replica", s["replica"])
        elif kind == "route":
            s["replica"] = rec.get("replica", s["replica"])

    for s in spans.values():
        sub = s["submit"]
        adm = min(s["admits"]) if s["admits"] else None
        ft, fin = s["first_token"], s["finish"]
        s["n_preempts"] = len(s["preempts"])
        s["queue_wait"] = (adm - sub) if sub is not None and adm is not None \
            else None
        s["prefill_time"] = (ft - adm) if adm is not None and ft is not None \
            else None
        s["ttft"] = (ft - sub) if sub is not None and ft is not None else None
        s["decode_time"] = (fin - ft) if ft is not None and fin is not None \
            else None
    return spans


def decision_summary(records: list[dict]) -> dict:
    """Reconstruct, for every tick, the chunk chosen and the scheduler
    inputs that chose it; aggregate into a per-chunk table."""
    ticks = [r for r in records if r["kind"] == "tick"]
    per_chunk: dict[int, dict] = {}
    cap_bound = held = 0
    decisions = []
    for r in ticks:
        d = r.get("decision") or {}
        c = r.get("chunk")
        row = per_chunk.setdefault(c, {"count": 0, "b_sum": 0.0,
                                       "kv_sum": 0.0, "kv_n": 0,
                                       "pf_sum": 0.0})
        row["count"] += 1
        row["b_sum"] += d.get("b", r.get("b") or 0)
        if d.get("kv_util") is not None:
            row["kv_sum"] += d["kv_util"]
            row["kv_n"] += 1
        row["pf_sum"] += d.get("prefill_tokens", 0) or 0
        if d:
            decisions.append({"t": r["t"], "replica": r.get("replica", 0),
                              **d})
            if d.get("held"):
                held += 1
            cands = d.get("candidates")
            if cands and d.get("cap") is not None \
                    and d["cap"] < max(cands):
                cap_bound += 1
    table = {}
    for c, row in sorted(per_chunk.items(), key=lambda kv: (kv[0] is None,
                                                            kv[0])):
        n = max(row["count"], 1)
        table[c] = {"ticks": row["count"],
                    "mean_b": row["b_sum"] / n,
                    "mean_kv_util": (row["kv_sum"] / row["kv_n"])
                    if row["kv_n"] else None,
                    "mean_prefill_tokens": row["pf_sum"] / n}
    return {"n_ticks": len(ticks), "per_chunk": table,
            "hysteresis_held_ticks": held,
            "memory_cap_bound_ticks": cap_bound,
            "decisions": decisions}


def phase_attribution(records: list[dict]) -> dict[int, dict]:
    """Per-replica time attribution over the tick timeline: busy time split
    into decode / mixed (decode + prefill) / prefill-only ticks, idle gaps,
    plus end-of-trace cumulative dispatch and host-transfer counters —
    NanoFlow-style utilization accounting from the recorded timeline.

    Dispatch counters in the snapshot are *logical* (phase-level): a
    split-KV step across ``kv_shards`` devices still counts once, so the
    attribution never multiply-counts per-shard work.  The per-device view
    lives in the separate ``device_dispatches`` / ``collective_bytes``
    counters; ``kv_shards`` in the result records the pool's shard count
    (1 when unsharded)."""
    out: dict[int, dict] = {}
    for rec in records:
        if rec["kind"] != "tick":
            continue
        r = rec.get("replica", 0)
        a = out.setdefault(r, {"ticks": 0, "busy": 0.0, "decode": 0.0,
                               "mixed": 0.0, "prefill_only": 0.0,
                               "span_start": None, "span_end": None,
                               "commits": 0, "counters": {},
                               "kv_shards": 1})
        gauges = rec.get("gauges") or {}
        a["kv_shards"] = max(a["kv_shards"], gauges.get("kv_shards", 1))
        t0, dur = rec["t"], rec.get("dur", 0.0)
        a["ticks"] += 1
        a["busy"] += dur
        a["commits"] += rec.get("commits") or 0
        b = rec.get("b") or 0
        counters = rec.get("counters") or {}
        d = rec.get("decision") or {}
        pf = counters.get("prefill_tick_tokens",
                          d.get("prefill_tokens", 0)) or 0
        if b > 0 and pf > 0:
            a["mixed"] += dur
        elif b > 0:
            a["decode"] += dur
        else:
            a["prefill_only"] += dur
        a["span_start"] = t0 if a["span_start"] is None \
            else min(a["span_start"], t0)
        a["span_end"] = t0 + dur if a["span_end"] is None \
            else max(a["span_end"], t0 + dur)
        a["counters"] = counters or a["counters"]
    for a in out.values():
        span = (a["span_end"] - a["span_start"]) \
            if a["span_start"] is not None else 0.0
        a["span"] = span
        a["idle"] = max(span - a["busy"], 0.0)
        a["utilization"] = a["busy"] / span if span > 0 else float("nan")
    return out


def ttft_breakdown(spans: dict[int, dict]) -> dict:
    """Aggregate TTFT decomposition (queue wait vs prefill) and stall
    summary over finished requests."""
    import numpy as np
    fin = [s for s in spans.values() if s.get("ttft") is not None]
    if not fin:
        return {"n_requests": 0}
    q = np.array([s["queue_wait"] for s in fin], float)
    p = np.array([s["prefill_time"] for s in fin], float)
    t = np.array([s["ttft"] for s in fin], float)
    pre = [s for s in fin if s["n_preempts"] > 0]
    return {
        "n_requests": len(fin),
        "ttft_p50": float(np.percentile(t, 50)),
        "ttft_p90": float(np.percentile(t, 90)),
        "queue_wait_p90": float(np.percentile(q, 90)),
        "prefill_time_p90": float(np.percentile(p, 90)),
        "queue_wait_share": float(q.sum() / max(t.sum(), 1e-12)),
        "n_preempted": len(pre),
        "max_preempts_per_request": max((s["n_preempts"] for s in fin),
                                        default=0),
    }


def fault_summary(records: list[dict]) -> dict:
    """Aggregate the fault-tolerance story out of an event log: injected
    faults and recoveries per replica, migrations vs re-submissions, shed
    and rejected requests with their structured reasons, and per-fault
    recovery lag (fault instant → the last migrated/re-routed request's
    finish)."""
    faults, recovers = [], []
    migrates, sheds, rejects, wipes = [], [], [], []
    finish_t: dict[int, float] = {}
    for rec in records:
        kind = rec.get("kind")
        if kind == "fault":
            faults.append(rec)
        elif kind == "recover":
            recovers.append(rec)
        elif kind == "migrate":
            migrates.append(rec)
        elif kind == "shed":
            sheds.append(rec)
        elif kind == "reject":
            rejects.append(rec)
        elif kind == "wipe":
            wipes.append(rec)
        elif kind == "finish":
            finish_t[rec.get("rid")] = rec["t"]
    reasons: dict[str, int] = {}
    for rec in sheds + rejects:
        r = rec.get("reason", "unknown")
        reasons[r] = reasons.get(r, 0) + 1
    displaced = [r for r in migrates if r.get("rid") in finish_t]
    recovery_lag = None
    if faults and displaced:
        t0 = min(r["t"] for r in faults)
        recovery_lag = max(finish_t[r["rid"]] for r in displaced) - t0
    return {
        "n_faults": len(faults),
        "faults_by_kind": {k: sum(1 for f in faults
                                  if f.get("fault") == k)
                          for k in {f.get("fault") for f in faults}},
        "n_recoveries": len(recovers),
        "n_migrations": len(migrates),
        "n_migrated_finished": len(displaced),
        "n_shed": len(sheds),
        "n_rejects": len(rejects),
        "n_wiped": len({r.get("rid") for r in wipes}),
        "wiped_tokens": sum(r.get("lost", 0) for r in wipes),
        "reject_reasons": reasons,
        "recovery_lag_s": recovery_lag,
    }
