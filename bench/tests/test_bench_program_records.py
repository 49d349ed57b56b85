"""The program's own records in the harness: the traced run hands the
timed engine the program's tracer (and the untraced run keeps the null
tracer), a ``Run`` offers the window's tick records and spans, the readers
of ``bench/metrics/`` read them, and the profiled slice names each idle gap
by the innermost host range open, the harness's or the program's.  The
readers are held on hand-made records; the whole runs below depend on no
request finishing inside their windows."""

import json
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from harness import runner, serve, trace
from harness.spec import Cell

DATA = Path(__file__).resolve().parent / "data"
SEED = 2 ** 33 + 3


def _run(ticks=(), spans=(), tr=None, w0=1.0, w1=2.0):
    return runner.Run(None, [], serve.Record(), w0, w1, 0.0, None, tr, {},
                      tick_log=list(ticks), span_log=list(spans))


def _read(name, run):
    return runner.load_reader(name)(run)


def _s(name, t0, t1, tick=1):
    return {"name": name, "t0": t0, "t1": t1, "tick": tick, "replica": 0}


def _tick(t, counters=None, gauges=None):
    return {"kind": "tick", "t": t, "replica": 0, "counters": counters or {},
            "gauges": gauges or {}}


# ---------------------------------------------------------------------------
# The readers, on hand-made records
# ---------------------------------------------------------------------------

def test_run_offers_the_window_ticks_and_spans():
    ticks = [_tick(t) for t in (0.5, 1.0, 1.5, 2.0)]
    spans = [_s("engine.tick", 0.9, 1.1, tick=1), _s("decode.fetch", 0.95,
                                                     1.0, tick=1),
             _s("engine.tick", 1.2, 1.4, tick=2), _s("graph.replay", 1.25,
                                                     1.3, tick=2),
             _s("engine.tick", 1.9, 2.1, tick=3)]
    r = _run(ticks, spans)
    assert [t["t"] for t in r.ticks()] == [1.0, 1.5]
    assert [s["name"] for s in r.spans()] == ["engine.tick", "graph.replay"]
    assert _run().ticks() == [] and _run().spans() == []


def test_tick_host_time_leaves_out_the_flights_and_the_slice():
    spans = [_s("engine.tick", 0.0, 0.030),
             _s("graph.replay", 0.002, 0.003),
             _s("prefill.fetch", 0.003, 0.010),
             _s("graph.replay", 0.015, 0.016),
             _s("decode.fetch", 0.016, 0.025),
             _s("engine.tick", 0.040, 0.050, tick=2),
             _s("graph.eager", 0.041, 0.045, tick=2),
             _s("slot.fetch", 0.045, 0.046, tick=2),
             _s("engine.tick", 0.060, 0.070, tick=3)]
    # tick 1: 30 - 8 - 10 ms; tick 2: 10 - 5 ms; tick 3 past the window
    assert _read("tick_host_ms", _run(spans=spans, w0=0.0, w1=0.055)) == \
        pytest.approx(8.5)
    # the ticks of the profiled slice are left out
    sl = {"t0": 0.039, "t1": 0.051}
    assert _read("tick_host_ms", _run(spans=spans, tr=sl, w0=0.0,
                                      w1=0.055)) == pytest.approx(12.0)
    assert _read("tick_host_ms", _run()) is None


def test_pool_share_takes_the_window_peak():
    ticks = [_tick(t, gauges={"pages_in_use": u, "n_pages": 200})
             for t, u in ((0.5, 90), (1.0, 10), (1.5, 30))]
    assert _read("kv_live_pages_share", _run(ticks)) == pytest.approx(15.0)
    # the slot path reads no pool gauges
    assert _read("kv_live_pages_share", _run([_tick(1.2)])) is None


def test_capture_seconds_at_the_window_first_tick():
    ticks = [_tick(t, counters={"graph_capture_s": c})
             for t, c in ((0.5, 1.0), (1.0, 2.0), (1.5, 2.5))]
    assert _read("graph_capture_s", _run(ticks)) == 2.0
    assert _read("graph_capture_s", _run(ticks, w0=5.0, w1=6.0)) is None
    # a backend with no graph cache has no such counter
    assert _read("graph_capture_s", _run([_tick(1.0)])) is None


def test_padded_share_reads_the_window_counters():
    ticks = [_tick(t, counters={"prefill_dispatches": d,
                                "prefill_padded_tokens": p,
                                "prefill_tick_tokens": k})
             for t, d, p, k in ((0.5, 1, 32, 30), (1.0, 2, 64, 20),
                                (1.5, 3, 576, 448), (1.7, 3, 576, 0),
                                (1.9, 4, 640, 40))]
    assert _read("prefill_padded_share", _run(ticks)) == \
        pytest.approx(100 * 488 / 576)
    # a program without the counter, or no prefill dispatch in the window
    parent = [_tick(t, counters={"prefill_dispatches": 3}) for t in (1.0,
                                                                     1.5)]
    assert _read("prefill_padded_share", _run(parent)) is None
    idle = [_tick(t, counters={"prefill_padded_tokens": 64,
                               "prefill_tick_tokens": 0}) for t in (1.0, 1.5)]
    assert _read("prefill_padded_share", _run(idle)) is None


def test_step_idle_share_needs_a_program_range():
    both = {"decode.commit": 2.0, "graph.load": 1.0, "engine.commit": 0.5,
            "decode_step": 3.0}
    tr = {"idle_by_span": both, "window_s": 10.0}
    assert _read("step_host_idle_share", _run(tr=tr)) == pytest.approx(30.0)
    # only the harness's names: the program's tracer was not on
    tr = {"idle_by_span": {"decode_step": 5.0, "tick": 1.0}, "window_s": 10.0}
    assert _read("step_host_idle_share", _run(tr=tr)) is None
    assert _read("step_host_idle_share", _run()) is None


def test_a_new_reader_file_alone_reads_a_new_counter(tmp_path, monkeypatch):
    """A counter the program adds later is read by one new file in
    ``metrics/``, found by its name, through ``Run.ticks()``."""
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "experts_touched.py").write_text(
        "def read(run):\n"
        "    c = [t['counters'].get('experts_touched') for t in run.ticks()]\n"
        "    c = [v for v in c if v is not None]\n"
        "    return c[-1] - c[0] if len(c) > 1 else None\n")
    monkeypatch.setattr(runner, "BENCH", tmp_path)
    ticks = [_tick(t, counters={"experts_touched": n})
             for t, n in ((0.5, 7), (1.0, 100), (1.5, 212), (2.5, 999))]
    assert _read("experts_touched", _run(ticks)) == 112
    assert _read("experts_touched", _run([_tick(1.0)])) is None


# ---------------------------------------------------------------------------
# The profiled slice: idle gaps named by the innermost open range
# ---------------------------------------------------------------------------

def test_range_names():
    assert trace.range_name("bench.decode_step") == "decode_step"
    assert trace.range_name("decode.fetch") == "decode.fetch"
    assert trace.range_name("engine.tick") == "engine.tick"
    assert trace.range_name("aten::copy_") is None
    assert trace.range_name("cudaGraphLaunch") is None


def test_gaps_take_the_innermost_open_range():
    ranges = [(0, 100, "tick"), (1, 99, "engine.tick"),
              (10, 90, "decode_step"), (20, 40, "engine.step"),
              (25, 30, "decode.commit"), (95, 99, "select")]
    gaps = [(27, 28), (35, 36), (50, 60), (96, 97), (200, 300), (5, 6)]
    assert trace.name_gaps(ranges, gaps) == [
        "decode.commit", "engine.step", "decode_step", "select", "loop",
        "engine.tick"]


def test_idle_gaps_busy_time_and_seconds_by_name():
    ns = 1e9
    ranges = [(0, 10 * ns, "tick"), (1 * ns, 8.2 * ns, "decode_step"),
              (1.8 * ns, 3.5 * ns, "graph.load")]
    device = [(0, 2 * ns), (1 * ns, 1.5 * ns), (3 * ns, 4 * ns),
              (8 * ns, 8.5 * ns), (9.5 * ns, 10 * ns)]
    g = trace.idle_gaps(ranges, device)
    assert g["busy_s"] == pytest.approx(4.0)
    assert g["idle_gaps"] == [["decode_step", 4.0], ["graph.load", 1.0],
                              ["tick", 1.0]]
    assert g["idle_by_span"] == {"decode_step": 4.0, "graph.load": 1.0,
                                 "tick": 1.0}
    assert len(trace.idle_gaps(ranges, device, longest=1)["idle_gaps"]) == 1


def _ev(name, start_us, end_us, device=False, annotation=False):
    kind = torch.autograd.DeviceType.CUDA if device else \
        torch.autograd.DeviceType.CPU
    return SimpleNamespace(name=name, device_type=kind,
                           is_user_annotation=annotation,
                           time_range=SimpleNamespace(start=start_us,
                                                      end=end_us))


def test_slice_names_gaps_by_program_ranges_and_keeps_every_op():
    """The nesting of a traced tick: the harness's ``tick`` around the
    engine's ``engine.tick`` and ``engine.step``, the harness's
    ``decode_step`` probe inside that, the backend's spans innermost."""
    long_name = "void_paged_chunk_attn_mma_kernel_" + "x" * 200
    events = [
        _ev("bench.tick", 0, 100), _ev("engine.tick", 1, 99),
        _ev("engine.step", 3, 97), _ev("bench.decode_step", 5, 95),
        _ev("decode.fetch", 30, 90),
        _ev("aten::copy_", 31, 32),                 # a host op: no range
        _ev("decode.fetch", 30, 90, device=True, annotation=True),
        _ev("nvjet_a", 0, 20, device=True),
        _ev(long_name, 40, 50, device=True),
        _ev("nvjet_a", 60, 70, device=True),
        _ev("nvjet_b", 95, 96, device=True),
        _ev("nvjet_b", 98, 100, device=True)]
    sl = trace.Slice()
    sl.prof = SimpleNamespace(events=lambda: events)
    sl.t0, sl.t1, sl.ticks = 0.0, 1e-4, 1
    out = sl.analyse(("paged_chunk_attn",))
    assert out["busy_s"] == pytest.approx(43e-6)
    assert out["n_device_ops"] == 5
    assert out["by_name"] == pytest.approx({"nvjet_a": 30e-6,
                                            long_name: 10e-6,
                                            "nvjet_b": 3e-6})
    assert out["device_ops"][1] == [long_name[:160], pytest.approx(10e-6)]
    assert out["kernel_s"] == pytest.approx(10e-6)
    assert out["idle_by_span"] == pytest.approx({"decode.fetch": 35e-6,
                                                 "decode_step": 20e-6,
                                                 "engine.step": 2e-6})
    assert [n for n, _ in out["idle_gaps"]] == [
        "decode.fetch", "decode_step", "decode.fetch", "engine.step"]


# ---------------------------------------------------------------------------
# Whole runs at the SMOKE sizes: which engine holds which tracer
# ---------------------------------------------------------------------------

def _cell():
    cfg = json.loads((DATA / "sdar-smoke.json").read_text())
    mix = json.loads((DATA / "small-poisson.json").read_text())
    return Cell("smoke", cfg, mix, [{"name": "setup_s", "unit": "s"}],
                [{"name": "kv_live_pages_share", "unit": "%"}])


@pytest.mark.parametrize("traced", [False, True], ids=["untraced", "traced"])
def test_only_a_traced_run_times_its_engine_with_the_program_tracer(
        traced, monkeypatch):
    from repro_torch.serving.telemetry import NULL_TRACER, Tracer
    cores, runs = [], []
    base_engine, base_run = serve.engine, runner.Run

    def engine(*a, **kw):
        cores.append(base_engine(*a, **kw))
        return cores[-1]

    def run(*a, **kw):
        runs.append(base_run(*a, **kw))
        return runs[-1]

    monkeypatch.setattr(serve, "engine", engine)
    monkeypatch.setattr(runner, "Run", run)
    runner.run(_cell(), SEED, 1.0, traced, "cpu", time.perf_counter(),
               log=lambda s: None)
    timed = [c for c in cores if isinstance(c.scheduler, serve.SchedulerProbe)]
    assert len(timed) == 1 and len(cores) >= 2
    for c in cores:                         # the warm-up's: the null tracer
        if c is not timed[0]:
            assert c.tracer is NULL_TRACER
    (r,) = runs
    if traced:
        assert isinstance(timed[0].tracer, Tracer)
        assert timed[0].backend.inner.tracer is timed[0].tracer
        assert r.tick_log and r.span_log    # the pre-roll's ticks at least
        assert {s["name"] for s in r.span_log} >= {"engine.tick",
                                                   "engine.step"}
    else:
        assert timed[0].tracer is NULL_TRACER
        assert timed[0].backend.inner.tracer is NULL_TRACER
        assert r.tick_log == [] and r.span_log == []
        assert r.ticks() == [] and r.spans() == []
