"""The system under test, and the harness's probes around it.

``build`` makes the program's model, backend and scheduler from a
configuration file; ``warm_up`` drives the backend through every dispatch
shape the cell can use, before the clock starts; ``drive`` runs the
program's ``EngineCore`` on a wall clock against an open-loop schedule.

The probes wrap the backend and the scheduler the engine is handed.  They
add nothing to the program's work: each call goes straight through, and
the probe notes when it started and ended (the harness's spans), what the
call was given and what it returned (chunk sizes, commits, output tokens,
the context lengths the paged kernel read).  Only the protocol the engine
itself uses is touched, so the program's internals can change under them.
"""

from __future__ import annotations

import time
from contextlib import nullcontext
from dataclasses import dataclass, field

import numpy as np
import torch


def arch_config(cfg_json: dict):
    """The program's ``ArchConfig`` from a configuration file's ``arch``."""
    from repro_torch.models.common import ArchConfig
    return ArchConfig(**{k: tuple(v) if isinstance(v, list) else v
                         for k, v in cfg_json["arch"].items()})


def build_model(cfg_json: dict):
    from repro_torch.models.registry import build_model as _build
    return _build(arch_config(cfg_json))


def build_backend(model, params, cfg_json: dict, device):
    from repro_torch.serving.backends import ModelBackend
    s = cfg_json["serve"]
    return ModelBackend(model, params, n_slots=s.get("n_slots", 8),
                        max_len=s["max_len"], decode_mode=s["decode_mode"],
                        cache_dtype=model.cfg.pdt, kv_pages=s.get("kv_pages"),
                        device=device)


def build_scheduler(model, cfg_json: dict, traffic: dict):
    from repro_torch.core.latency_model import AnalyticDeviceModel, DEVICES
    from repro_torch.core.scheduler import scheduler_for_mode
    s = cfg_json["serve"]
    return scheduler_for_mode(
        s["mode"], AnalyticDeviceModel(model.cfg, DEVICES[s["device_spec"]]),
        prior_tokens_per_step=traffic["tokens_per_step_bd32"])


def engine(backend, scheduler, cfg_json: dict, clock):
    """The program's ``EngineCore``.  A probed backend whose record carries
    the program's tracer (the timed engine of a traced run) hands it to the
    engine, which hands it on to the backend and its graph cache; every
    other engine keeps the null tracer."""
    from repro_torch.serving.engine import EngineCore
    tracer = backend.rec.tracer if isinstance(backend, BackendProbe) \
        else None
    return EngineCore(backend, scheduler,
                      max_batch=cfg_json["serve"]["max_batch"], clock=clock,
                      tracer=tracer)


def request(a, dataset: str = "bench"):
    from repro_torch.serving.request import Request
    return Request(rid=a.rid, arrival_time=a.due, prompt_len=len(a.prompt),
                   max_new_tokens=a.max_new, prompt_tokens=list(a.prompt),
                   dataset=dataset)


def graph_count(backend) -> int | None:
    """Graphs the backend's cache has captured (None: nothing captured)."""
    g = getattr(backend, "graphs", None)
    return None if g is None else len(g.entries)


# ---------------------------------------------------------------------------
# Probes
# ---------------------------------------------------------------------------

@dataclass
class Call:
    """One ``decode_step`` call."""
    t0: float
    t1: float
    chunk: int
    rows: list              # decode rows [(ctx, valid)]
    prefill: list           # prefill rows [(offset, n)]
    commits: int
    computed: int


@dataclass
class Record:
    """What the probes saw, on the engine's clock."""
    spans: list = field(default_factory=list)       # (name, t0, t1)
    calls: list = field(default_factory=list)       # [Call]
    admit: dict = field(default_factory=dict)       # rid → t
    commits: dict = field(default_factory=dict)     # rid → [(t, n)]
    steps: dict = field(default_factory=dict)       # rid → [(c, mask, v)]
    outputs: dict = field(default_factory=dict)     # rid → tokens
    submitted: dict = field(default_factory=dict)   # rid → t submitted
    pages: list = field(default_factory=lambda: [0, 0])
    # the KV pool's peak pages: [holding a live request's KV, that plus the
    # parked prefix pages] (paged path; after each admission and step)
    tracer: object = None   # the program's Tracer for the timed engine
    label = None            # profiler range factory while tracing

    def note_pages(self, backend):
        if not backend.paged:
            return
        kv = backend.kv
        live = kv.n_pages - kv.free_pages
        self.pages[0] = max(self.pages[0], live)
        self.pages[1] = max(self.pages[1], live + kv.cached_pages)

    def span(self, name, t0, t1):
        self.spans.append((name, t0, t1))

    def ranged(self, name):
        return self.label(name) if self.label is not None else nullcontext()


class BackendProbe:
    """The backend as the engine sees it, with spans and outputs noted."""

    def __init__(self, inner, rec: Record, clock):
        self.inner, self.rec, self.clock = inner, rec, clock

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def admit(self, req):
        rec = self.rec
        t0 = self.clock.now()
        with rec.ranged("admit"):
            out = self.inner.admit(req)
        t1 = self.clock.now()
        rec.span("admit", t0, t1)
        rec.admit[req.rid] = t0
        rec.note_pages(self.inner)
        n = self.inner.state(req.rid).n_committed
        if n:                   # the slot path prefills and commits here
            rec.commits.setdefault(req.rid, []).append((t1, n))
            rec.steps.setdefault(req.rid, []).append(
                (1, np.ones(1, bool), 1))
            rec.calls.append(Call(t0, t1, 0, [], [(0, req.prompt_len)], n,
                                  0))
        return out

    def decode_step(self, rids, chunk):
        rec, inner = self.rec, self.inner
        before = {r: (inner.state(r).prompt_len, inner.state(r).frozen)
                  for r in rids}
        t0 = self.clock.now()
        with rec.ranged("decode_step"):
            lat, infos = inner.decode_step(rids, chunk)
        t1 = self.clock.now()
        rec.span("decode_step", t0, t1)
        rec.note_pages(inner)
        rows, commits, computed = [], 0, 0
        for r in rids:
            info = infos[r]
            if info.valid_len > 0:
                p, f = before[r]
                rows.append((p + f, int(info.valid_len)))
                computed += int(info.valid_len)
                rec.steps.setdefault(r, []).append(
                    (chunk, np.asarray(info.commit_mask, bool).copy(),
                     int(info.valid_len)))
            if info.n_committed > 0:
                commits += int(info.n_committed)
                rec.commits.setdefault(r, []).append((t1, info.n_committed))
        plan = [(off, n) for _, off, n in inner.last_prefill_plan]
        rec.calls.append(Call(t0, t1, chunk, rows, plan, commits, computed))
        return lat, infos

    def release(self, rid):
        self.rec.outputs[rid] = list(self.inner.state(rid).output_tokens)
        self.inner.release(rid)


class SchedulerProbe:
    def __init__(self, inner, rec: Record, clock):
        self.inner, self.rec, self.clock = inner, rec, clock

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def select(self, *a, **kw):
        t0 = self.clock.now()
        with self.rec.ranged("select"):
            c = self.inner.select(*a, **kw)
        self.rec.span("select", t0, self.clock.now())
        return c


# ---------------------------------------------------------------------------
# Warm-up: every dispatch shape, before the clock starts
# ---------------------------------------------------------------------------

class _Cycle:
    """Warm-up scheduler: chunk sizes in turn."""

    def __init__(self, chunks):
        self.chunks, self.i = list(chunks), 0

    def select(self, b, **kw):
        self.i += 1
        return self.chunks[self.i % len(self.chunks)]

    def observe(self, *a):
        pass


def _bucket(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


def warm_up(backend, cfg_json: dict, clock) -> int:
    """Drive the backend through the dispatch shapes the cell's traffic
    uses, so that none is captured inside the window.  On the paged path:
    every decode batch bucket up to the configuration's ``warm_batch`` at
    every chunk the scheduler may pick, and chunked-prefill batches of the
    ``warm_prefill_batches`` sizes at every token bucket up to one block;
    on the slot path a slot prefill and an AR step.  Every request is
    released after.  Returns the ticks run."""
    from repro_torch.core.scheduler import DEFAULT_CHUNKS
    from repro_torch.serving.request import Request
    s = cfg_json["serve"]
    chunks = s.get("warm_chunks", DEFAULT_CHUNKS)
    core = engine(backend, _Cycle(chunks), cfg_json, clock)
    vocab = backend.cfg.vocab_size
    rid = [10 ** 9]
    ticks = [0]

    def submit(n_prompt, max_new, count=1):
        for _ in range(count):
            rid[0] += 1
            toks = [4 + (rid[0] * 7919 + i) % (vocab - 4)
                    for i in range(n_prompt)]
            core.submit(Request(rid[0], clock.now(), n_prompt, max_new,
                                prompt_tokens=toks))

    def settle():
        while core.n_pending or backend.prefill_tick_tokens():
            core.tick()
            ticks[0] += 1

    if not backend.paged:
        submit(4, 2, count=2)
        while core.tick():
            ticks[0] += 1
        return ticks[0]
    block = backend.cfg.block_size
    for bp in s.get("warm_prefill_batches", (1, 2, 4, 8)):
        tp = 1
        while tp <= block:
            first = tp if tp < block else block + 1 - bp
            submit(first, 1)
            submit(1, 1, count=bp - 1)
            settle()
            tp *= 2
        while core.tick():                  # the short requests end
            ticks[0] += 1
    long_new = s["max_len"] - 1
    b = 1
    while b <= _bucket(s.get("warm_batch", s["max_batch"])):
        for _ in range(b - core.n_active):  # one prompt a tick: (1, 1)
            submit(1, long_new)
            settle()
        for _ in chunks:
            core.tick()
            ticks[0] += 1
        b *= 2
    for r in core.active_requests():
        backend.release(r.rid)
    return ticks[0]


# ---------------------------------------------------------------------------
# The timed loop
# ---------------------------------------------------------------------------

def drive(core, arrivals, clock, t_end: float, rec: Record, start: int = 0,
          on_tick=None) -> int:
    """Run ``core`` on ``clock`` until ``t_end``, submitting each arrival
    when it falls due (open loop: a request's times count from its due
    time, however late the loop gets to it).  Returns the index of the
    first arrival not yet submitted."""
    i = start
    while True:
        now = clock.now()
        if now >= t_end:
            return i
        while i < len(arrivals) and arrivals[i].due <= now:
            core.submit(request(arrivals[i]))
            rec.submitted[arrivals[i].rid] = now
            i += 1
        if core.idle:
            nxt = arrivals[i].due if i < len(arrivals) else t_end
            time.sleep(max(0.0, min(nxt, t_end) - clock.now()))
            continue
        t0 = clock.now()
        with rec.ranged("tick"):
            core.tick()
        t1 = clock.now()
        rec.span("tick", t0, t1)
        if on_tick is not None:
            on_tick(t1)


def device_name(device) -> str:
    return torch.cuda.get_device_name(device) if \
        torch.device(device).type == "cuda" else "cpu"
