#!/usr/bin/env python3
"""Serve a benchmark cell with the program's tracer on, and read its spans.

    python3 chip_spans.py --workload sdar8b-sharegpt-0.8knee \\
        --seeds 11 12 13 [--seconds 51] [--mode readings|cost] [--out F]

Each run is the benchmark's own (``bench/run.py``'s ``harness.runner.run``,
in this process, its files untouched): the same set-up, warm-up, pre-roll,
window, probes and check.  The one difference: the timed ``EngineCore`` gets
a ``repro_torch.serving.telemetry.Tracer``, so the engine, the model step
and the graph cache record their spans, and the tracer samples its
counters and the pool's gauges every tick.

``--mode readings`` (``--trace 1`` runs): the harness's per-layer metrics,
and from the program's records the readers below, which read the raw span
and tick records and import no analysis of the program:

* ``tick_host_ms``: mean over the window's ticks (the profiled slice's
  left out) of ``engine.tick``'s time not covered by any dispatch's flight,
  a flight running from a ``graph.replay``, ``graph.eager`` or
  ``graph.capture`` start to the end of the next ``*.fetch``;
* ``step_host_idle_share``: % of the profiled slice's wall time in which
  the device is idle and the innermost open range, when the gap began, is
  one of the model step's or the graph cache's spans;
* ``kv_live_pages_share``: peak over the window's ticks of the pool gauge
  ``pages_in_use`` over ``n_pages``, in %;
* ``graph_capture_s``: the counter ``graph_capture_s`` at the window's
  first tick (host seconds of set-up spent capturing graphs);

with the slice's idle gaps named by the innermost open range, the
harness's (``bench.*``) or the program's, and the idle seconds by that
name (``idle_by_span``).  ``--mode cost`` (``--trace 0`` runs, the tracer
off and on in turns, the order swapped each seed): ``tokens_per_s``,
``decode_step_ms`` and, with the tracer on, ``tick_host_ms`` over the
whole window, unprofiled.  Either mode prints one JSON line a run and,
last, the list of them (also written to ``--out``).
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from contextlib import contextmanager
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FLIGHT_STARTS = ("graph.replay", "graph.eager", "graph.capture")
# the model step's and the graph cache's spans; the engine's are engine.*
STEP_LAYERS = ("prefill.", "decode.", "kv.", "slot.", "graph.")
PROGRAM_LAYERS = ("engine.",) + STEP_LAYERS


def bench_environment():
    """``bench/run.py``'s environment: its caches, threads and paths."""
    spec = importlib.util.spec_from_file_location(
        "bench_run", ROOT / "bench" / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod._environment()


# ---------------------------------------------------------------------------
# Readers: raw span and tick records in, one number (or None) out
# ---------------------------------------------------------------------------

def _covered(intervals, lo: float, hi: float) -> float:
    """Length of the union of ``intervals`` inside [lo, hi]."""
    total, end = 0.0, lo
    for a, b in sorted(intervals):
        a, b = max(a, end), min(b, hi)
        if b > a:
            total += b - a
            end = b
    return total


def tick_host_ms(spans: list, w0: float, w1: float, skip=None):
    """Mean host time of the window's ticks outside every dispatch's flight,
    in ms; ``skip`` an interval whose ticks are left out."""
    ticks: dict = {}
    for s in spans:
        ticks.setdefault((s["replica"], s["tick"]), []).append(s)
    host = []
    for group in ticks.values():
        tick = next((s for s in group if s["name"] == "engine.tick"), None)
        if tick is None or tick["t0"] < w0 or tick["t1"] > w1:
            continue
        if skip is not None and tick["t1"] > skip[0] and tick["t0"] < skip[1]:
            continue
        fetches = sorted((s["t0"], s["t1"]) for s in group
                         if s["name"].endswith(".fetch"))
        flights = []
        for a in sorted(s["t0"] for s in group if s["name"] in FLIGHT_STARTS):
            end = next((f1 for f0, f1 in fetches if f0 >= a), None)
            if end is not None:
                flights.append((a, end))
        dur = tick["t1"] - tick["t0"]
        host.append(dur - _covered(flights, tick["t0"], tick["t1"]))
    return 1e3 * sum(host) / len(host) if host else None


def span_ms(spans: list, w0: float, w1: float, inside=None) -> dict:
    """Mean duration in ms of each span name over the window's ticks:
    those outside the interval ``inside`` (None: all), or with ``inside``
    given as ``("in", lo, hi)`` those overlapping it."""
    ticks: dict = {}
    for s in spans:
        ticks.setdefault((s["replica"], s["tick"]), []).append(s)
    acc: dict = {}
    for group in ticks.values():
        tick = next((s for s in group if s["name"] == "engine.tick"), None)
        if tick is None or tick["t0"] < w0 or tick["t1"] > w1:
            continue
        if inside is not None:
            hit = tick["t1"] > inside[1] and tick["t0"] < inside[2]
            if hit != (inside[0] == "in"):
                continue
        for s in group:
            n, t = acc.get(s["name"], (0, 0.0))
            acc[s["name"]] = (n + 1, t + s["t1"] - s["t0"])
    return {k: 1e3 * t / n for k, (n, t) in sorted(acc.items())}


def _window_ticks(records: list, w0: float, w1: float) -> list:
    return [r for r in records if r["kind"] == "tick" and w0 <= r["t"] < w1]


def kv_live_pages_share(records: list, w0: float, w1: float):
    """Peak of the pool gauge ``pages_in_use`` over ``n_pages`` across the
    window's ticks, in %."""
    v = [100.0 * g["pages_in_use"] / g["n_pages"]
         for r in _window_ticks(records, w0, w1)
         if (g := r.get("gauges")) and g.get("n_pages")]
    return max(v) if v else None


def graph_capture_s(records: list, w0: float, w1: float):
    """The counter ``graph_capture_s`` at the window's first tick."""
    ticks = _window_ticks(records, w0, w1)
    if not ticks:
        return None
    return (ticks[0].get("counters") or {}).get("graph_capture_s")


def step_host_idle_share(idle_by_span: dict, window_s: float):
    """% of the slice's wall time idle under a model-step or graph-cache
    span; None where no program span named a gap."""
    if not any(n.startswith(PROGRAM_LAYERS) for n in idle_by_span):
        return None
    idle = sum(v for n, v in idle_by_span.items() if n.startswith(STEP_LAYERS))
    return 100.0 * idle / window_s


# ---------------------------------------------------------------------------
# The profiled slice: idle gaps named by the innermost open range
# ---------------------------------------------------------------------------

def range_name(name: str):
    """A host range's name: the harness's without its ``bench.`` prefix,
    the program's as it is; None for any other event."""
    if name.startswith("bench."):
        return name[len("bench."):]
    return name if name.startswith(PROGRAM_LAYERS) else None


def name_gaps(ranges: list, gaps: list) -> list:
    """The innermost of ``ranges`` ``(start, end, name)`` open at each
    gap's start (``gaps`` ``(start, end)``), or ``loop`` where none is;
    one name a gap, in the gaps' order."""
    order = sorted(range(len(gaps)), key=lambda i: gaps[i][0])
    rs = sorted(ranges)
    out, open_, j = [None] * len(gaps), [], 0
    for i in order:
        t = gaps[i][0]
        while j < len(rs) and rs[j][0] <= t:
            open_.append(rs[j])
            j += 1
        open_ = [r for r in open_ if r[1] > t]
        inner = min(open_, key=lambda r: r[1] - r[0], default=None)
        out[i] = inner[2] if inner is not None else "loop"
    return out


def idle_gaps(ranges: list, device: list, longest: int = 10) -> dict:
    """The device's idle gaps between ``device`` operations ``(start,
    end)`` (times in any one unit, read as ns), each named by
    :func:`name_gaps`: the ``longest`` as ``[name, seconds]`` and the
    idle seconds by name."""
    gaps, cur = [], None
    for s, e in sorted(device):
        if cur is not None and s > cur:
            gaps.append((cur, s))
        cur = e if cur is None else max(cur, e)
    names = name_gaps(ranges, gaps)
    by: dict = {}
    for (a, b), n in zip(gaps, names):
        by[n] = by.get(n, 0.0) + (b - a) / 1e9
    top = sorted(range(len(gaps)), key=lambda i: gaps[i][0] - gaps[i][1])
    return {"idle_gaps": [[names[i], (gaps[i][1] - gaps[i][0]) / 1e9]
                          for i in top[:longest]],
            "idle_by_span": dict(sorted(by.items(), key=lambda x: -x[1]))}


def profiler_gaps(prof) -> dict:
    """:func:`idle_gaps` of a finished ``torch.profiler`` session."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    ranges, device = [], []
    for ev in prof.events():
        s, e = ev.time_range.start * 1000, ev.time_range.end * 1000
        if ev.device_type == cuda:
            if not getattr(ev, "is_user_annotation", False):
                device.append((s, e))
        elif (n := range_name(ev.name)) is not None:
            ranges.append((s, e, n))
    return idle_gaps(ranges, device)


# ---------------------------------------------------------------------------
# One run of the benchmark with the tracer on
# ---------------------------------------------------------------------------

@contextmanager
def traced_harness(tracer):
    """The harness, untouched, with the timed engine handed ``tracer``
    (None: the harness as it is); yields a dict that fills with the run's
    ``Run`` and profiled ``Slice``."""
    from harness import runner, serve
    from repro_torch.serving.engine import EngineCore
    held: dict = {}
    base_engine, base_run, base_slice = serve.engine, runner.Run, runner.Slice

    def engine(backend, scheduler, cfg_json, clock):
        if tracer is None or not isinstance(scheduler, serve.SchedulerProbe):
            return base_engine(backend, scheduler, cfg_json, clock)
        return EngineCore(backend, scheduler,
                          max_batch=cfg_json["serve"]["max_batch"],
                          clock=clock, tracer=tracer)

    class Run(base_run):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            held["run"] = self

    class Slice(base_slice):
        def start(self, clock):
            held["slice"] = self
            super().start(clock)

    serve.engine, runner.Run, runner.Slice = engine, Run, Slice
    try:
        yield held
    finally:
        serve.engine, runner.Run, runner.Slice = \
            base_engine, base_run, base_slice


def run_once(cell, seed: int, seconds: float, trace: bool, device,
             tracer_on: bool = True, log=lambda s: None) -> dict:
    """One benchmark run of ``cell``; the harness's result with the span
    readings (``spans``) beside it."""
    from harness import runner
    from repro_torch.serving.telemetry import Tracer
    tracer = Tracer() if tracer_on else None
    t_start = time.perf_counter()
    with traced_harness(tracer) as held:
        out = runner.run(cell, seed, seconds, trace, device, t_start, log=log)
    run = held["run"]
    sl = held.get("slice")
    res = {"seed": seed, "tracer": tracer_on, "trace": trace,
           "correct": out["correct"],
           "metrics": {k: v["value"] for k, v in out["metrics"].items()},
           "device": out["device"], "breakdown": out.get("breakdown")}
    if tracer is None:
        return res
    spans, records = tracer.span_records(), tracer.records()
    n_ticks = sum(1 for r in records if r["kind"] == "tick")
    skip = (run.trace["t0"], run.trace["t1"]) if run.trace else None
    sp = {"tick_host_ms": tick_host_ms(spans, run.w0, run.w1, skip),
          "kv_live_pages_share": kv_live_pages_share(records, run.w0,
                                                     run.w1),
          "graph_capture_s": graph_capture_s(records, run.w0, run.w1),
          "ticks": n_ticks, "spans": len(spans), "events": len(records),
          "spans_per_tick": len(spans) / max(n_ticks, 1),
          "events_per_tick": len(records) / max(n_ticks, 1),
          "dropped": tracer.dropped, "spans_dropped": tracer.spans_dropped}
    sp["span_ms"] = span_ms(spans, run.w0, run.w1,
                            ("out",) + skip if skip else None)
    if sl is not None and sl.prof is not None:
        sp["span_ms_profiled"] = span_ms(spans, run.w0, run.w1,
                                         ("in",) + skip)
        g = profiler_gaps(sl.prof)
        sp.update(g, step_host_idle_share=step_host_idle_share(
            g["idle_by_span"], run.trace["window_s"]))
    res["spans"] = sp
    return res


def card() -> str | None:
    """``name, power limit`` of the card, from nvidia-smi (None without)."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None


def spread(v: list) -> float | None:
    """Interquartile distance over the median (``statistics.quantiles``)."""
    if len(v) < 2:
        return None
    q = statistics.quantiles(v, n=4)
    return (q[2] - q[0]) / statistics.median(v)


def summary(runs: list) -> dict:
    out: dict = {}
    for on in (False, True):
        rows = [r for r in runs if r["tracer"] == on]
        for key in ("tokens_per_s", "decode_step_ms"):
            v = [r["metrics"][key] for r in rows if key in r["metrics"]]
            if v:
                out[f"{key}.tracer_{'on' if on else 'off'}"] = {
                    "median": statistics.median(v), "spread": spread(v),
                    "runs": v}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--mode", choices=("readings", "cost"),
                    default="readings")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    bench_environment()
    import torch

    from harness import runner
    from harness.spec import load_cell
    if not torch.cuda.is_available():
        print("chip_spans: needs a CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    print(json.dumps({"card": card(), "torch": torch.__version__}),
          flush=True)
    cell = load_cell(args.workload, ROOT)
    if args.mode == "cost":         # untraced runs read decode_step_ms too
        cell = dataclasses.replace(cell, end_to_end=cell.end_to_end + [
            {"name": "decode_step_ms", "unit": "ms"}])
    runs = []
    for i, seed in enumerate(args.seeds):
        if args.mode == "readings":
            turns = [(True, True)]
        else:
            turns = [(False, on) for on in ((False, True) if i % 2 == 0
                                            else (True, False))]
        for trace, on in turns:
            res = run_once(cell, seed, args.seconds, trace, "cuda", on)
            runs.append(res)
            print(json.dumps(res), flush=True)
            gc.collect()
            torch.cuda.empty_cache()
    bad = runner.forbidden_modules()
    if bad:
        print(f"chip_spans: the process loaded {bad}", file=sys.stderr)
        return 3
    doc = {"workload": args.workload, "mode": args.mode, "card": card(),
           "summary": summary(runs), "runs": runs}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(doc, indent=1))
    print(json.dumps(doc["summary"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
