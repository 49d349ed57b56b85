"""Offline trace analyzer for tracer JSONL event logs.

    PYTHONPATH=src python -m repro_torch.launch.trace_view trace.jsonl

Reconstructs, from a recorded serving run (``--trace`` on
``repro_torch.launch.serve`` / ``serve_cluster``):

* **scheduler decisions** — for every tick, the chunk size chosen and the
  inputs that chose it (live batch, KV utilization, queued prefill tokens,
  the memory cap and hysteresis state), aggregated per chunk;
* **per-phase time attribution** — busy time split into decode / mixed
  (decode+prefill) / prefill-only ticks plus idle gaps per replica
  (NanoFlow-style utilization accounting);
* **TTFT / stall breakdowns** — queue wait vs prefill decomposition over
  request lifecycle spans, preemption counts, max inter-token stall.

``--replay`` re-runs every logged elastic decision through
:func:`repro_torch.serving.telemetry.replay_select` and reports mismatches (a
faithful log replays 100%); ``--validate-perfetto <file>`` checks an
exported ``.perfetto.json`` against the in-repo catapult ``trace_event``
format checker; ``--json`` emits the full analysis as one JSON object for
scripting.
"""

from __future__ import annotations

import argparse
import json
import sys

from repro_torch.serving.telemetry import (build_spans, decision_summary,
                                     fault_summary, load_jsonl,
                                     phase_attribution, ttft_breakdown,
                                     validate_trace_events)


def _fmt(v, scale=1.0, unit="", nd=2):
    if v is None:
        return "-"
    try:
        return f"{v * scale:.{nd}f}{unit}"
    except (TypeError, ValueError):
        return str(v)


def print_decisions(ds: dict):
    print(f"scheduler decisions over {ds['n_ticks']} ticks "
          f"(hysteresis held {ds['hysteresis_held_ticks']}, "
          f"memory-cap bound {ds['memory_cap_bound_ticks']}):")
    print(f"  {'chunk':>6} {'ticks':>7} {'mean b':>8} {'mean kv':>8} "
          f"{'mean prefill':>13}")
    for c, row in ds["per_chunk"].items():
        print(f"  {str(c):>6} {row['ticks']:>7} "
              f"{_fmt(row['mean_b']):>8} "
              f"{_fmt(row['mean_kv_util']):>8} "
              f"{_fmt(row['mean_prefill_tokens'], nd=1):>13}")


def print_phases(pa: dict):
    print("per-replica time attribution:")
    print(f"  {'replica':>7} {'ticks':>7} {'busy':>9} {'decode':>9} "
          f"{'mixed':>9} {'prefill':>9} {'idle':>9} {'util':>7}")
    for r, a in sorted(pa.items()):
        print(f"  {r:>7} {a['ticks']:>7} "
              f"{_fmt(a['busy'], unit='s'):>9} "
              f"{_fmt(a['decode'], unit='s'):>9} "
              f"{_fmt(a['mixed'], unit='s'):>9} "
              f"{_fmt(a['prefill_only'], unit='s'):>9} "
              f"{_fmt(a['idle'], unit='s'):>9} "
              f"{_fmt(a['utilization'], 100, '%', 1):>7}")
        if a.get("counters"):
            c = a["counters"]
            print(f"          dispatches: {c.get('decode_dispatches', '-')}"
                  f" decode / {c.get('prefill_dispatches', '-')} prefill,"
                  f" host transfer: {c.get('host_transfer_bytes', '-')} B")
            hits = c.get("prefix_hits")
            if hits is not None:
                total = hits + (c.get("prefix_misses") or 0)
                rate = hits / total if total else 0.0
                print(f"          kv cache: {hits}/{total} prefix hits "
                      f"({rate * 100:.1f}%), "
                      f"{c.get('prefix_hit_tokens', 0)} prompt tokens "
                      f"served from cache, "
                      f"{c.get('cow_copies', 0)} COW copies, swap "
                      f"in/out: {c.get('swap_in_bytes', 0)}/"
                      f"{c.get('swap_out_bytes', 0)} B")
            if a.get("kv_shards", 1) > 1:
                print(f"          kv shards: {a['kv_shards']} "
                      f"(device dispatches: "
                      f"{c.get('device_dispatches', '-')}, "
                      f"collective bytes: "
                      f"{c.get('collective_bytes', '-')} B)")


def print_ttft(tb: dict, spans: dict):
    if not tb.get("n_requests"):
        print("no finished request spans in trace")
        return
    print(f"TTFT breakdown over {tb['n_requests']} requests:")
    print(f"  TTFT P50/P90:        {_fmt(tb['ttft_p50'], 1e3, ' ms')} / "
          f"{_fmt(tb['ttft_p90'], 1e3, ' ms')}")
    print(f"  queue wait P90:      {_fmt(tb['queue_wait_p90'], 1e3, ' ms')} "
          f"({_fmt(tb['queue_wait_share'], 100, '%', 1)} of total TTFT)")
    print(f"  prefill time P90:    "
          f"{_fmt(tb['prefill_time_p90'], 1e3, ' ms')}")
    print(f"  preempted requests:  {tb['n_preempted']} "
          f"(max {tb['max_preempts_per_request']} evictions/request)")
    worst = sorted((s for s in spans.values() if s.get("ttft") is not None),
                   key=lambda s: -s["ttft"])[:5]
    if worst:
        print("  worst TTFT requests:")
        for s in worst:
            print(f"    rid {s['rid']:>5}: ttft "
                  f"{_fmt(s['ttft'], 1e3, ' ms')} "
                  f"(queue {_fmt(s['queue_wait'], 1e3, ' ms')}, "
                  f"prefill {_fmt(s['prefill_time'], 1e3, ' ms')}, "
                  f"{s['n_preempts']} preempts, "
                  f"replica {s['replica']})")


def print_faults(fs: dict):
    if not fs["n_faults"] and not fs["n_shed"] and not fs["n_rejects"]:
        return
    print()
    kinds = " ".join(f"{k}={v}"
                     for k, v in sorted(fs["faults_by_kind"].items()))
    print(f"faults & recovery: {fs['n_faults']} injected ({kinds or '-'}), "
          f"{fs['n_recoveries']} recoveries")
    if fs["n_migrations"]:
        print(f"  migrations: {fs['n_migrations']} "
              f"({fs['n_migrated_finished']} finished), recovery lag "
              f"{_fmt(fs['recovery_lag_s'], 1e3, ' ms')}")
    if fs["n_shed"] or fs["n_rejects"]:
        reasons = " ".join(f"{k}={v}"
                           for k, v in sorted(fs["reject_reasons"].items()))
        print(f"  shed: {fs['n_shed']}  rejects: {fs['n_rejects']} "
              f"({reasons or '-'})")


def run_replay(records: list[dict]) -> dict:
    """Replay every logged elastic decision purely from the log; report
    fidelity (in-process tests use ``telemetry.replay_select`` against the
    live scheduler — offline we reproduce the argmax+hysteresis from the
    logged scores, which the live path must also match)."""
    n = ok = 0
    mismatches = []
    for rec in records:
        if rec.get("kind") != "tick":
            continue
        d = rec.get("decision")
        if not d or d.get("policy") != "elastic":
            continue
        n += 1
        got = _replay_standalone(d)
        if got == d["chunk"]:
            ok += 1
        elif len(mismatches) < 10:
            mismatches.append({"t": rec["t"], "logged": d["chunk"],
                               "replayed": got})
    return {"n_decisions": n, "n_match": ok, "mismatches": mismatches}


def _replay_standalone(d: dict) -> int:
    """Offline replay without the run's scheduler object: the decision's
    logged TU estimates and scores pin the dynamic state, so we only need
    the argmax + hysteresis + cap arithmetic, not the latency model."""
    scores = {int(k): float(v) for k, v in (d.get("scores") or {}).items()}
    if not scores:
        return d["chunk"]
    best = max(scores, key=lambda c: scores[c])
    cur = d.get("cur")
    if cur in scores and scores[best] <= \
            (1 + d.get("hysteresis", 0.05)) * scores[cur]:
        best = cur
    return best


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.trace_view",
        description="Analyze a serving telemetry JSONL event log.")
    ap.add_argument("trace", nargs="?", help="tracer JSONL event log")
    ap.add_argument("--json", action="store_true",
                    help="emit the full analysis as one JSON object")
    ap.add_argument("--replay", action="store_true",
                    help="replay logged elastic decisions and report "
                         "fidelity")
    ap.add_argument("--validate-perfetto", metavar="FILE",
                    help="check a .perfetto.json export against the "
                         "trace_event format (exit 1 on violations)")
    args = ap.parse_args(argv)

    if args.validate_perfetto:
        errors = validate_trace_events(args.validate_perfetto)
        if errors:
            for e in errors[:50]:
                print(f"VIOLATION: {e}", file=sys.stderr)
            print(f"{len(errors)} violations", file=sys.stderr)
            return 1
        print(f"{args.validate_perfetto}: valid trace_event JSON")
        if not args.trace:
            return 0

    if not args.trace:
        ap.error("a trace JSONL path is required")
    records = load_jsonl(args.trace)
    spans = build_spans(records)
    ds = decision_summary(records)
    pa = phase_attribution(records)
    tb = ttft_breakdown(spans)
    fs = fault_summary(records)
    replay = run_replay(records) if args.replay else None

    if args.json:
        out = {"decision_summary": ds, "phase_attribution": pa,
               "ttft_breakdown": tb, "fault_summary": fs,
               "spans": {str(k): v for k, v in spans.items()}}
        if replay is not None:
            out["replay"] = replay
        json.dump(out, sys.stdout, default=float)
        print()
    else:
        n_req = len(spans)
        print(f"{args.trace}: {len(records)} events, {n_req} requests, "
              f"{ds['n_ticks']} ticks")
        print()
        print_decisions(ds)
        print()
        print_phases(pa)
        print()
        print_ttft(tb, spans)
        print_faults(fs)
        if replay is not None:
            print()
            print(f"decision replay: {replay['n_match']}/"
                  f"{replay['n_decisions']} elastic decisions reproduce")
            for m in replay["mismatches"]:
                print(f"  MISMATCH at t={m['t']}: logged {m['logged']} "
                      f"vs replayed {m['replayed']}")
    if replay is not None and replay["n_match"] != replay["n_decisions"]:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
