"""The port's host spans (``Tracer.span``): the engine's, the model step's
and the graph cache's, each nested in its parent within one tick; the null
tracer's spans record nothing and open no profiler range; a tick's
duration and ``busy_time`` measured on a wall clock and, on the virtual
clock, the JAX package's to the bit; the graph cache's counters; spans in
the Perfetto export."""

import dataclasses
import json

import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.serving as jserving
from repro.models.common import ArchConfig as JaxArchConfig
import repro_torch.core as tcore
import repro_torch.serving as tserving
from repro_torch.configs import get_smoke_config
from repro_torch.models import ArchConfig, build_model
from repro_torch.serving.clock import VirtualClock, WallClock
from repro_torch.serving.graphs import RerunCapturer
from repro_torch.serving.telemetry import (NULL_TRACER, Tracer,
                                           phase_attribution,
                                           validate_trace_events)

SDAR = dataclasses.asdict(get_smoke_config("sdar-8b"))
CFG = dict(name="t", family="dense", n_layers=2, d_model=64, n_heads=4,
           n_kv_heads=2, d_ff=128, vocab_size=256, block_size=8,
           confidence_threshold=0.6)
CFG_RWKV = dict(name="r", family="ssm", n_layers=2, d_model=64,
                rwkv_head_dim=16, d_ff=128, vocab_size=256, diffusion=False)
CFG_HYBRID = dict(name="h", family="hybrid", n_layers=4, d_model=64,
                  n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256,
                  attn_period=4, attn_offset=1, block_size=8)

# every span of the paged path and the span it opens inside
PAGED_PARENT = {
    "engine.tick": None, "engine.admit": "engine.tick",
    "engine.select": "engine.tick", "engine.step": "engine.tick",
    "engine.commit": "engine.tick",
    "prefill.plan": "engine.step", "prefill.dispatch": "engine.step",
    "prefill.fetch": "engine.step", "prefill.advance": "engine.step",
    "kv.reserve": "engine.step", "decode.window": "engine.step",
    "decode.dispatch": "engine.step", "decode.fetch": "engine.step",
    "decode.commit": "engine.step", "kv.trim": "engine.step"}
DISPATCHES = ("prefill.dispatch", "decode.dispatch")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sdar():
    model = build_model(ArchConfig(**SDAR))
    return model, model.init_params(torch.Generator().manual_seed(0),
                                    device="cpu")


def _own(cfg):
    model = build_model(ArchConfig(**cfg))
    return model, model.init_params(torch.Generator().manual_seed(0),
                                    device="cpu")


def _requests(n, vocab, prompt=(6, 40), seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        p = int(rng.integers(*prompt))
        out.append(tserving.Request(
            rid=i, arrival_time=0.0, prompt_len=p,
            max_new_tokens=int(rng.integers(8, 16)),
            prompt_tokens=rng.integers(4, vocab, p).tolist()))
    return out


def _serve(model, params, tracer, graphs, clock=None, n=3, chunk=8, **kw):
    be = tserving.ModelBackend(model, params, device="cpu", n_slots=4,
                               max_len=96, graphs=graphs, **kw)
    core = tserving.EngineCore(be, tcore.FixedScheduler(chunk), max_batch=4,
                               tracer=tracer, clock=clock)
    for r in _requests(n, model.cfg.vocab_size):
        core.submit(r)
    core.drain()
    return be, core


def _by_id(spans):
    return {s["id"]: s for s in spans}


def _check_nesting(spans):
    """Every span lies inside its parent, in the parent's tick."""
    by = _by_id(spans)
    for s in spans:
        assert s["t0"] <= s["t1"]
        if s["parent"] is None:
            continue
        p = by[s["parent"]]
        assert p["t0"] <= s["t0"] and s["t1"] <= p["t1"], (s, p)
        assert p["tick"] == s["tick"] and p["replica"] == s["replica"]


def test_paged_path_spans_nest_under_their_layer(sdar):
    model, params = sdar
    tr = Tracer()
    be, core = _serve(model, params, tr, RerunCapturer(), clock=WallClock())
    spans = tr.span_records()
    by = _by_id(spans)
    names = {s["name"] for s in spans}
    assert set(PAGED_PARENT) | {"graph.capture", "graph.load",
                                "graph.replay"} <= names
    assert "graph.eager" not in names
    _check_nesting(spans)
    for s in spans:
        parent = by[s["parent"]]["name"] if s["parent"] is not None \
            else None
        if s["name"].startswith("graph."):
            # the graph cache opens inside a dispatch (or a COW copy in
            # the pool's reservation)
            assert parent in DISPATCHES + ("prefill.plan", "kv.reserve")
        else:
            assert parent == PAGED_PARENT[s["name"]], s
    # one engine.tick per engine tick, holding every other span of it
    ticks = [s for s in spans if s["name"] == "engine.tick"]
    assert len(ticks) == core._steps == len({s["tick"] for s in spans})
    admits = [s for s in spans if s["name"] == "engine.admit"]
    assert sorted(s["args"]["rid"] for s in admits) == [0, 1, 2]
    for s in spans:
        if s["name"] in DISPATCHES:
            assert s["args"]["batch"] >= 1 and s["args"]["tokens"] >= 1
    caps = [s for s in spans if s["name"] == "graph.capture"]
    assert len(caps) == len(be.graphs.entries)
    assert all(s["args"]["key"].startswith("(") for s in caps)
    assert tr.spans_dropped == 0 and core.tracer is tr and be.tracer is tr


def test_eager_path_has_one_graph_span_per_dispatch(sdar):
    model, params = sdar
    tr = Tracer()
    be, _ = _serve(model, params, tr, False, clock=WallClock())
    spans = tr.span_records()
    by = _by_id(spans)
    graph = [s for s in spans if s["name"].startswith("graph.")]
    assert graph and {s["name"] for s in graph} == {"graph.eager"}
    assert all(by[s["parent"]]["name"] in DISPATCHES for s in graph)
    n_dispatch = sum(1 for s in spans if s["name"] in DISPATCHES)
    assert len(graph) == n_dispatch == be.decode_dispatches + \
        be.prefill_dispatches
    # no graph cache: no graph counters
    ticks = [r for r in tr.records() if r["kind"] == "tick"]
    assert "graph_capture_s" not in ticks[-1]["counters"]


@pytest.mark.parametrize("cfg,mode,chunk", [(CFG_RWKV, "ar", 1),
                                            (CFG_HYBRID, "elastic", 8)],
                         ids=["rwkv_ar", "hybrid"])
def test_slot_path_spans(cfg, mode, chunk):
    model, params = _own(cfg)
    tr = Tracer()
    _serve(model, params, tr, RerunCapturer(), clock=WallClock(),
           chunk=chunk, decode_mode=mode)
    spans = tr.span_records()
    by = _by_id(spans)
    names = {s["name"] for s in spans}
    assert {"slot.prefill", "slot.dispatch", "slot.fetch",
            "slot.sample"} <= names
    assert not any(n.startswith(("prefill.", "decode.", "kv."))
                   for n in names)
    _check_nesting(spans)
    for s in spans:
        if s["parent"] is None:
            continue
        parent = by[s["parent"]]["name"]
        if s["name"] == "slot.prefill":
            assert parent == "engine.admit"
        elif s["name"] == "slot.dispatch":
            assert parent == "engine.step"
        elif s["name"] in ("slot.fetch", "slot.sample"):
            # an AR admission samples its first token as it admits
            assert parent in ("engine.admit", "engine.step")


def _profiled_ranges(run):
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        run()
    return {ev.name for ev in prof.events()}


def test_null_tracer_records_nothing_and_opens_no_range(sdar):
    model, params = sdar
    assert NULL_TRACER.span("engine.tick") is NULL_TRACER.span("x", a=1)
    be = [None]

    def untraced():
        be[0], _ = _serve(model, params, None, False, n=2)

    seen = _profiled_ranges(untraced)
    assert be[0].tracer is NULL_TRACER
    assert not any(n.startswith(("engine.", "prefill.", "decode.", "kv.",
                                 "graph.")) for n in seen)
    tr = Tracer()
    seen = _profiled_ranges(lambda: _serve(model, params, tr, False, n=2))
    assert {"engine.tick", "engine.step", "decode.dispatch", "graph.eager",
            "prefill.fetch"} <= seen
    # no session recording: the enabled tracer opens no range
    assert not torch.autograd._profiler_enabled()


def test_wall_clock_tick_takes_the_step_time(sdar):
    model, params = sdar
    tr = Tracer()
    _, core = _serve(model, params, tr, False, clock=WallClock())
    rep = core.report()
    ticks = [r for r in tr.records() if r["kind"] == "tick"]
    steps = [s for s in tr.span_records() if s["name"] == "engine.step"]
    assert ticks and all(r["dur"] > 0 for r in ticks)
    # busy: the steps, and the admissions' own time on the wall clock
    assert rep.busy_time >= sum(r["dur"] for r in ticks) > 0
    # each tick's dur is its engine.step span, within the clock's reads
    for r, s in zip(ticks, steps):
        assert abs(r["dur"] - (s["t1"] - s["t0"])) < 1e-3
    pa = phase_attribution(tr.records())[0]
    assert pa["utilization"] > 0


def test_virtual_clock_ticks_are_the_references_bit_for_bit():
    """A sim run on the virtual clock: the tick durations, ``busy_time``
    and the JSONL event log equal the JAX package's exactly."""
    logs, busy = [], []
    for core, serving, AC in ((jcore, jserving, JaxArchConfig),
                              (tcore, tserving, ArchConfig)):
        cfg = AC(**{**CFG, "name": "sdar-8b"})
        prof = serving.DATASETS["sharegpt"]
        be = serving.SimBackend(cfg, tokens_per_step=prof.tokens_per_step_bd32,
                                kv_pool_pages=512, seed=1)
        sched = core.ElasticScheduler.from_analytic(
            be.analytic, prior_tokens_per_step=prof.tokens_per_step_bd32)
        tr = serving.Tracer()
        eng = serving.EngineCore(be, sched, max_batch=32, tracer=tr)
        eng.submit_all(list(serving.PoissonWorkload(prof, 8.0, 30, seed=2)))
        eng.drain()
        busy.append(eng.report().busy_time)
        logs.append([json.dumps(r, default=float, sort_keys=True)
                     for r in tr.records()])
    assert busy[0] == busy[1] > 0
    assert logs[0] == logs[1]
    assert any('"dur": 0.0' not in ln and '"kind": "tick"' in ln
               for ln in logs[1])


def test_virtual_clock_spans_read_the_engine_clock():
    cfg = ArchConfig(**{**CFG, "name": "sdar-8b"})
    prof = tserving.DATASETS["sharegpt"]
    be = tserving.SimBackend(cfg, tokens_per_step=prof.tokens_per_step_bd32,
                             kv_pool_pages=512, seed=1)
    tr, clock = Tracer(), VirtualClock()
    eng = tserving.EngineCore(be, tcore.FixedScheduler(8), max_batch=8,
                              tracer=tr, clock=clock)
    eng.submit_all(list(tserving.PoissonWorkload(prof, 8.0, 6, seed=2)))
    eng.drain()
    spans = tr.span_records()
    ticks = [r for r in tr.records() if r["kind"] == "tick"]
    steps = [s for s in spans if s["name"] == "engine.step"]
    assert len(steps) == len(ticks)
    for r, s in zip(ticks, steps):
        # the clock advances after the step: the span is the instant
        # the tick record starts at
        assert s["t0"] == s["t1"] == r["t"]
    _check_nesting(spans)


def test_graph_counters_count_the_set_ups_captures(sdar):
    model, params = sdar
    be = tserving.ModelBackend(model, params, device="cpu", n_slots=4,
                               max_len=96, graphs=RerunCapturer())
    warm = tserving.EngineCore(be, tcore.FixedScheduler(8), max_batch=4)
    for r in _requests(2, model.cfg.vocab_size, seed=3):
        warm.submit(r)
    warm.drain()
    captured, spent = len(be.graphs.entries), be.graphs.capture_s
    assert captured > 0 and spent > 0
    tr = Tracer()
    core = tserving.EngineCore(be, tcore.FixedScheduler(8), max_batch=4,
                               tracer=tr, clock=WallClock())
    for r in _requests(2, model.cfg.vocab_size, seed=3):
        r.rid += 10
        core.submit(r)
    core.drain()
    first = next(r for r in tr.records() if r["kind"] == "tick")
    c = first["counters"]
    assert c["graph_capture_s"] >= spent and c["graph_captures"] >= captured
    last = [r for r in tr.records() if r["kind"] == "tick"][-1]["counters"]
    assert last["graph_replays"] == be.graphs.replays > 0
    assert last["graph_captures"] == len(be.graphs.entries)


def test_perfetto_export_holds_the_spans(sdar):
    model, params = sdar
    tr = Tracer()
    _serve(model, params, tr, RerunCapturer(), clock=WallClock())
    doc = tr.to_perfetto()
    assert validate_trace_events(doc) == []
    xs = [e for e in doc["traceEvents"]
          if e["ph"] == "X" and e.get("cat") == "span"]
    assert len(xs) == len(tr.spans)
    assert {e["tid"] for e in xs} == {1}
    assert {"engine.tick", "decode.fetch", "graph.replay"} <= \
        {e["name"] for e in xs}
    assert any(e["ph"] == "M" and e["tid"] == 1 and
               e["args"]["name"] == "host spans" for e in doc["traceEvents"])
    assert any(e["ph"] == "C" and e["name"] == "graph_capture_s"
               for e in doc["traceEvents"])
    assert doc["otherData"]["dropped_spans"] == 0
    # a tracer with no spans exports what it exported before
    assert "dropped_spans" not in Tracer().to_perfetto()["otherData"]


def test_span_ring_is_bounded_and_counts_drops():
    tr = Tracer(max_events=4)
    for i in range(10):
        with tr.span("engine.tick", i=i):
            pass
    assert len(tr.spans) == 4 and tr.spans_dropped == 6
    assert [s["args"]["i"] for s in tr.span_records()] == [6, 7, 8, 9]
    # a span that raises is still recorded, and the stack unwinds
    with pytest.raises(ValueError):
        with tr.span("outer"):
            with tr.span("inner"):
                raise ValueError
    inner, outer = tr.span_records()[-2:]
    assert inner["parent"] == outer["id"] and outer["parent"] is None
    assert tr._open == []
