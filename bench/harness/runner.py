"""One run of one cell: set-up, pre-roll, the window, the readers, the check.

``run`` is what ``bench/run.py`` calls once it has found the card; the
tests call it on the CPU at a small size.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from harness import check, costs, serve, stats, weights
from harness.spec import BENCH, Cell
from harness.trace import Slice, warm_profiler
from harness.traffic import make_arrivals

# the profiled slice: where it opens in the window, and its engine ticks
TRACE_AT = 0.4
TRACE_TICKS = 16
PAGED_KERNELS = ("paged_chunk_attn",)


@dataclass
class Run:
    """What a reader is handed: the cell, the arrivals, the probes' record,
    the window [w0, w1) on the engine clock, and the rest of the run; in a
    traced run also the timed engine's own records, from the program's
    tracer (``ticks()``, ``spans()``)."""
    cell: Cell
    arrivals: list
    rec: serve.Record
    w0: float
    w1: float
    setup_s: float
    graphs: tuple                   # (captured at w0, at w1), or None
    trace: dict | None
    shape: dict                     # the model's sizes for the arithmetic
    extra: dict = field(default_factory=dict)
    tick_log: list = field(default_factory=list)    # the tracer's ticks
    span_log: list = field(default_factory=list)    # and its host spans

    @property
    def seconds(self) -> float:
        return self.w1 - self.w0

    def calls(self) -> list:
        return stats.calls_in(self.rec.calls, self.w0, self.w1)

    def ticks(self) -> list:
        """The timed engine's tick records (``Tracer.records()``) that
        started inside the window, in order, each with the program's
        ``counters`` and the pool's ``gauges``; none in an untraced run."""
        return [r for r in self.tick_log if self.w0 <= r["t"] < self.w1]

    def spans(self) -> list:
        """The program's host spans (``Tracer.span_records()``) of the
        ticks whose ``engine.tick`` lies inside the window; none in an
        untraced run."""
        inside = {(s["replica"], s["tick"]) for s in self.span_log
                  if s["name"] == "engine.tick" and self.w0 <= s["t0"]
                  and s["t1"] <= self.w1}
        return [s for s in self.span_log
                if (s["replica"], s["tick"]) in inside]


def load_reader(name: str):
    """``bench/metrics/<name>.py``'s ``read``."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def model_shape(model, layout: dict, config: dict) -> dict:
    cfg, arch = model.cfg, config["arch"]
    attn = len(model.attn_positions()) * model.n_periods
    return {"params": costs.matmul_params(layout,
                                          config.get("zero_leaves", ()),
                                          arch.get("n_experts", 0),
                                          arch.get("top_k", 0)),
            "d_model": cfg.d_model, "vocab": cfg.vocab_size,
            "n_attn_layers": attn, "n_heads": cfg.n_heads,
            "n_kv_heads": cfg.n_kv_heads, "head_dim": cfg.hd,
            "block": cfg.block_size, "page_size": cfg.kv_page_size,
            # a chunked-prefill chunk's alignment: a page, or for a
            # diffusion model the least multiple of page and block
            "prefill_align": math.lcm(cfg.kv_page_size, cfg.block_size)
            if cfg.diffusion else cfg.kv_page_size,
            "itemsize": torch.empty(0, dtype=cfg.pdt).element_size()}


def forbidden_modules() -> list:
    """Top-level names of the JAX stack or the JAX package in this
    process, compared whole (``repro_torch`` is not ``repro``)."""
    bad = {"jax", "jaxlib", "flax", "repro"}
    return sorted({m.split(".")[0] for m in sys.modules} & bad)


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, log=print) -> dict:
    """One run; returns the result's fields (``metrics`` by name)."""
    from repro_torch.serving.clock import WallClock
    from repro_torch.serving.telemetry import Tracer
    cfg, mix = cell.config, cell.traffic
    dev = torch.device(device)
    model = serve.build_model(cfg)
    layout = model.init_params(device="meta")
    params, _ = weights.draw(layout, cfg, seed, dev)
    backend = serve.build_backend(model, params, cfg, dev)
    warm_ticks = serve.warm_up(backend, cfg, WallClock())
    graphs_warm = serve.graph_count(backend)
    if trace and dev.type == "cuda":
        warm_profiler(lambda: serve.warm_up(backend, dict(
            cfg, serve=dict(cfg["serve"], warm_batch=1,
                            warm_prefill_batches=[])), WallClock()))

    preroll = mix["preroll_s"]
    arrivals = make_arrivals(mix, seed, preroll + seconds + 5.0,
                             model.cfg.vocab_size)
    # a traced run's timed engine, and it alone, records the program's
    # spans and counters
    rec = serve.Record(tracer=Tracer() if trace else None)
    clock = WallClock()
    core = serve.engine(serve.BackendProbe(backend, rec, clock),
                        serve.SchedulerProbe(
                            serve.build_scheduler(model, cfg, mix), rec,
                            clock),
                        cfg, clock)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    gc.collect()
    gc.freeze()
    nxt = serve.drive(core, arrivals, clock, preroll, rec)
    w0 = clock.now()
    setup_s = time.perf_counter() - t_start
    w1 = w0 + seconds
    g0 = serve.graph_count(backend)
    sl = Slice() if trace and dev.type == "cuda" else None

    def on_tick(t):
        if sl is None:
            return
        if sl.prof is None and t >= w0 + TRACE_AT * seconds:
            rec.label = lambda n: torch.profiler.record_function(f"bench.{n}")
            sl.start(clock)
        elif sl.open:
            sl.ticks += 1
            if sl.ticks >= TRACE_TICKS:
                rec.label = None
                sl.stop(clock)

    serve.drive(core, arrivals, clock, w1, rec, start=nxt, on_tick=on_tick)
    if sl is not None and sl.open:
        rec.label = None
        sl.stop(clock)
    g1 = serve.graph_count(backend)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else 0
    tr = sl.analyse(PAGED_KERNELS) if sl is not None and sl.prof else None
    gc.unfreeze()

    shape = model_shape(model, layout, cfg)
    extra = {"warm_ticks": warm_ticks, "graphs_warm": graphs_warm,
             "preemptions": core.preemptions,
             "kv_pages": backend.kv.n_pages if backend.paged else None}
    tracer, logs = core.tracer, {}     # the timed engine's own records
    if tracer.enabled:
        extra["tracer_dropped"] = [tracer.dropped, tracer.spans_dropped]
        logs = {"tick_log": [e for e in tracer.records()
                             if e["kind"] == "tick"],
                "span_log": tracer.span_records()}
    r = Run(cell, arrivals, rec, w0, w1, setup_s,
            None if g0 is None else (g0, g1), tr, shape, extra, **logs)
    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        v = load_reader(m["name"])(r)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    readings = readings_of(r)
    log(json.dumps({"readings": readings}))

    # the program's state goes before the reference runs
    del core, backend
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
    ck = cfg["check"]
    rids = check.sample(rec.outputs, arrivals, seed, ck["sample_tokens"],
                        ck["sample_requests"])
    t_ref = time.perf_counter()
    result = check.judge(cfg, params, check.served(rec, arrivals, rids),
                         dev)
    correct, checked = check.verdict(cfg, result)
    ref_s = time.perf_counter() - t_ref
    info = {"requests": len(rids), "tokens": result["tokens"],
            "flips": result["flips"], "faults": result["faults"][:5],
            "commit_shortfall": result.get("commit_shortfall"),
            "skip_excess": result.get("skip_excess"),
            "decision_error": result.get("decision_error"),
            "decisions": result.get("decisions"), "seconds": ref_s}
    if "witness" in ck:
        # a second reading of the same sample (not judged): the reference
        # run with the configuration's stated departure, to name a cause
        w = check.judge(cfg, params, check.served(rec, arrivals, rids), dev,
                        **ck["witness"])
        info["witness"] = {"gap": w["gap"], "flips": w["flips"],
                           **ck["witness"]}
    log(json.dumps({"reference": info}))
    out = {"correct": correct,
           "attempted": len(stats.due_in(arrivals, w0, w1)),
           "failed": 0, "metrics": metrics,
           "device": {"platform": "gpu" if dev.type == "cuda" else "cpu",
                      "kind": serve.device_name(dev), "count": 1,
                      "memory_peak_bytes": int(peak)}}
    if tr is not None:
        out["device"]["busy_s"] = tr["busy_s"]
        out["device"]["window_s"] = tr["window_s"]
        out["breakdown"] = {"device_ops": tr["device_ops"],
                            "idle_gaps": tr["idle_gaps"]}
    out["checked"] = checked
    return out


def shapes_used(calls, align: int = 1) -> dict:
    """How often each dispatch shape ran: ``decode BpxC`` and ``prefill
    BpxTp``, each padded to the program's power-of-two buckets, a prefill's
    token axis to at least one aligned chunk (``align``), as the program
    pads it on the card."""
    out: dict = {}
    for c in calls:
        keys = []
        if c.rows:
            keys.append(f"decode {serve._bucket(len(c.rows))}x{c.chunk}")
        if c.prefill:
            tp = max(align, max(n for _, n in c.prefill))
            keys.append(f"prefill {serve._bucket(len(c.prefill))}x"
                        f"{serve._bucket(tp)}")
        for k in keys:
            out[k] = out.get(k, 0) + 1
    return dict(sorted(out.items()))


def readings_of(r: Run) -> dict:
    """Numbers printed beside the metrics, not judged: load, tails in
    every cell, the engine's batch, and what the warm-up captured."""
    due = stats.due_in(r.arrivals, r.w0, r.w1)
    calls = r.calls()
    late = [r.rec.submitted[a.rid] - a.due for a in due
            if a.rid in r.rec.submitted]
    tt = stats.ttfts(r.arrivals, r.rec.commits, r.w0, r.w1)
    tp = stats.token_gaps(r.arrivals, r.rec.commits, r.w0, r.w1)
    return {
        "due": len(due),
        "finished": sum(1 for a in due if a.rid in r.rec.outputs),
        "ttft_p50_ms": float(np.median(tt)) * 1e3 if tt else None,
        "ttft_p90_ms": (stats.p90(tt) or 0) * 1e3 if tt else None,
        "tpot_p50_ms": float(np.median(tp)) * 1e3 if tp else None,
        "tpot_p90_ms": (stats.p90(tp) or 0) * 1e3 if tp else None,
        "late_max_ms": max(late) * 1e3 if late else None,
        "ticks": len(calls),
        "batch_mean": float(np.mean([len(c.rows) for c in calls]))
        if calls else 0.0,
        "batch_max": max((len(c.rows) for c in calls), default=0),
        "keys": shapes_used(calls, r.shape["prefill_align"]),
        "chunks": {str(k): sum(1 for c in calls if c.chunk == k)
                   for k in sorted({c.chunk for c in calls})},
        "backlog_w0": stats.backlog(r.arrivals, r.rec.commits, r.w0),
        "backlog_w1": stats.backlog(r.arrivals, r.rec.commits, r.w1),
        "pool_pages": {"n": r.extra.get("kv_pages"),
                       "live_peak": r.rec.pages[0],
                       "held_peak": r.rec.pages[1]},
        "setup_s": r.setup_s, **r.extra,
        "graphs": r.graphs,
    }
