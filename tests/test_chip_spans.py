"""``chip_spans.py``: the benchmark's run with the program's tracer on, and
the readers of its spans.  One traced run of the benchmark at the SMOKE
sizes on the CPU (shared by the module's cases) reads ``tick_host_ms``,
``kv_live_pages_share`` and ``graph_capture_s``; the harness's own
untraced run leaves the engine on the null tracer; the gap naming,
``idle_by_span`` and ``step_host_idle_share`` are held on hand-made
events."""

import importlib.util
import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
DATA = ROOT / "bench" / "tests" / "data"
for p in (str(ROOT / "src"), str(ROOT / "bench")):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness import runner, serve  # noqa: E402
from harness.spec import Cell  # noqa: E402
from repro_torch.serving.graphs import RerunCapturer  # noqa: E402
from repro_torch.serving.telemetry import NULL_TRACER  # noqa: E402

_spec = importlib.util.spec_from_file_location("chip_spans",
                                               ROOT / "chip_spans.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

SEED = 2 ** 33 + 1
LAYER = [{"name": n, "unit": "x"} for n in ("decode_step_ms",
                                            "queue_wait_p90_ms")]
E2E = [{"name": "tokens_per_s", "unit": "tokens/s"}]


def _cell():
    cfg = json.loads((DATA / "sdar-smoke.json").read_text())
    mix = json.loads((DATA / "small-poisson.json").read_text())
    return Cell("smoke", cfg, mix, E2E, LAYER)


def _captured_backend(model, params, cfg_json, device):
    """``serve.build_backend`` with the CPU's stand-in graph capturer, so
    the graph cache's spans and counters run here."""
    from repro_torch.serving.backends import ModelBackend
    s = cfg_json["serve"]
    return ModelBackend(model, params, n_slots=s.get("n_slots", 8),
                        max_len=s["max_len"], decode_mode=s["decode_mode"],
                        cache_dtype=model.cfg.pdt, kv_pages=s.get("kv_pages"),
                        device=device, graphs=RerunCapturer())


@pytest.fixture(scope="module")
def runs():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    mp = pytest.MonkeyPatch()
    mp.setattr(serve, "build_backend", _captured_backend)
    cores = []
    base = serve.engine

    def engine(*a, **kw):
        cores.append(base(*a, **kw))
        return cores[-1]

    try:
        traced = cs.run_once(_cell(), SEED, 3.0, True, "cpu")
        mp.setattr(serve, "engine", engine)
        plain = runner.run(_cell(), SEED, 2.0, False, "cpu", 0.0,
                           log=lambda s: None)
    finally:
        mp.undo()
        torch.set_num_threads(n)
    return traced, plain, cores


def test_traced_run_reads_the_program_spans(runs):
    traced, _, _ = runs
    assert traced["correct"]
    sp = traced["spans"]
    for name in ("tick_host_ms", "kv_live_pages_share", "graph_capture_s"):
        assert isinstance(sp[name], float) and sp[name] > 0, name
    # the host's share of a tick lies below the model step's whole span
    assert sp["tick_host_ms"] < traced["metrics"]["decode_step_ms"]
    assert sp["kv_live_pages_share"] <= 100.0
    assert sp["spans_per_tick"] > 5 and sp["dropped"] == 0 \
        and sp["spans_dropped"] == 0


def test_untraced_harness_run_keeps_the_null_tracer(runs):
    _, plain, cores = runs
    assert "tokens_per_s" in plain["metrics"]
    timed = [c for c in cores if isinstance(c.scheduler, serve.SchedulerProbe)]
    assert len(timed) == 1
    assert timed[0].tracer is NULL_TRACER
    assert timed[0].backend.inner.tracer is NULL_TRACER


def test_gaps_take_the_innermost_open_range():
    ranges = [(0, 100, "tick"), (10, 90, "decode_step"),
              (20, 40, "engine.step"), (25, 30, "decode.commit"),
              (95, 99, "select")]
    gaps = [(27, 28), (35, 36), (50, 60), (96, 97), (200, 300), (5, 6)]
    assert cs.name_gaps(ranges, gaps) == [
        "decode.commit", "engine.step", "decode_step", "select", "loop",
        "tick"]


def test_harness_names_stay_where_no_program_range_is_open():
    ns = 1e9
    ranges = [(0, 10 * ns, "tick"), (1 * ns, 8.2 * ns, "decode_step")]
    device = [(0, 2 * ns), (3 * ns, 4 * ns), (8 * ns, 8.5 * ns),
              (9.5 * ns, 10 * ns)]
    g = cs.idle_gaps(ranges, device)
    assert g["idle_gaps"] == [["decode_step", 4.0], ["decode_step", 1.0],
                              ["tick", 1.0]]
    assert g["idle_by_span"] == {"decode_step": 5.0, "tick": 1.0}
    # only the harness's names: no reading of the program's share
    assert cs.step_host_idle_share(g["idle_by_span"], 10.0) is None
    both = {"decode.commit": 2.0, "graph.load": 1.0, "engine.commit": 0.5,
            "decode_step": 3.0}
    assert cs.step_host_idle_share(both, 10.0) == pytest.approx(30.0)


def test_range_names():
    assert cs.range_name("bench.decode_step") == "decode_step"
    assert cs.range_name("decode.fetch") == "decode.fetch"
    assert cs.range_name("aten::copy_") is None
    assert cs.range_name("cudaGraphLaunch") is None


def _s(name, t0, t1, tick=1):
    return {"name": name, "t0": t0, "t1": t1, "tick": tick, "replica": 0}


def test_tick_host_time_leaves_out_the_flights():
    spans = [_s("engine.tick", 0.0, 0.030),
             _s("graph.replay", 0.002, 0.003), _s("prefill.fetch", 0.003,
                                                   0.010),
             _s("graph.replay", 0.015, 0.016), _s("decode.fetch", 0.016,
                                                  0.025),
             _s("engine.tick", 0.040, 0.050, tick=2),
             _s("graph.eager", 0.041, 0.045, tick=2),
             _s("slot.fetch", 0.045, 0.046, tick=2),
             _s("engine.tick", 0.060, 0.070, tick=3)]
    # tick 1: 30 - 8 - 10 ms; tick 2: 10 - 5 ms; tick 3 past the window
    assert cs.tick_host_ms(spans, 0.0, 0.055) == pytest.approx(8.5)
    # a tick inside the skipped interval is left out
    assert cs.tick_host_ms(spans, 0.0, 0.055, skip=(0.039, 0.051)) == \
        pytest.approx(12.0)
    assert cs.tick_host_ms([], 0.0, 1.0) is None


def test_pool_and_capture_readers_take_the_window():
    recs = [{"kind": "tick", "t": t, "counters": {"graph_capture_s": c},
             "gauges": {"pages_in_use": u, "n_pages": 200}}
            for t, c, u in ((0.5, 1.0, 90), (1.0, 2.0, 10), (1.5, 2.5, 30))]
    recs.append({"kind": "admit", "t": 1.2})
    assert cs.kv_live_pages_share(recs, 1.0, 2.0) == pytest.approx(15.0)
    assert cs.graph_capture_s(recs, 1.0, 2.0) == 2.0
    assert cs.graph_capture_s(recs, 5.0, 6.0) is None
    # the parent program's counters have no graph_capture_s
    assert cs.graph_capture_s([{"kind": "tick", "t": 1.0, "counters": {}}],
                              0.0, 2.0) is None


def test_span_means_split_at_the_profiled_slice():
    spans = [_s("engine.tick", 0.0, 0.010), _s("graph.replay", 0.001, 0.003),
             _s("engine.tick", 0.020, 0.040, tick=2),
             _s("graph.replay", 0.021, 0.031, tick=2)]
    assert cs.span_ms(spans, 0.0, 1.0) == pytest.approx(
        {"engine.tick": 15.0, "graph.replay": 6.0})
    assert cs.span_ms(spans, 0.0, 1.0, ("out", 0.015, 0.05)) == \
        pytest.approx({"engine.tick": 10.0, "graph.replay": 2.0})
    assert cs.span_ms(spans, 0.0, 1.0, ("in", 0.015, 0.05)) == \
        pytest.approx({"engine.tick": 20.0, "graph.replay": 10.0})
