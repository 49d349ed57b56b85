"""Multi-replica cluster serving launcher (virtual-clock simulation).

    PYTHONPATH=src python -m repro_torch.launch.serve_cluster \\
        --replicas 4 --router saturation --dataset sharegpt \\
        --rate 8.0 --requests 200

Serves one open-loop workload (poisson | bursty | diurnal) across N replica
engines through a pluggable router with KV-pressure admission (and optional
low-priority preemption), then prints cluster goodput, per-replica
utilization, and tail latency.  ``--trace <path>`` records the full
telemetry timeline (tick events, scheduler decisions, request lifecycle)
to a JSONL event log plus a Perfetto-loadable ``.perfetto.json`` — inspect
with ``python -m repro_torch.launch.trace_view <path>``.
"""

from __future__ import annotations

import argparse

from repro_torch.cluster import RecoveryPolicy, build_sim_cluster
from repro_torch.common.faults import FaultPlan
from repro_torch.configs import get_config
from repro_torch.core.latency_model import DEVICES
from repro_torch.serving import DATASETS, Tracer, make_trace


def build_fault_plan(args):
    """``--faults`` spec string, or a seeded random plan from the
    ``--crash-rate`` / ``--stall-rate`` / ``--oom-rate`` knobs."""
    if getattr(args, "faults", None):
        return FaultPlan.parse(args.faults)
    rates = (getattr(args, "crash_rate", 0.0),
             getattr(args, "stall_rate", 0.0),
             getattr(args, "oom_rate", 0.0))
    if not any(rates):
        return None
    horizon = getattr(args, "fault_horizon", None) \
        or args.requests / max(args.rate, 1e-9)
    return FaultPlan.random(
        args.replicas, horizon_s=horizon,
        seed=getattr(args, "fault_seed", None) or args.seed,
        crash_rate=rates[0], stall_rate=rates[1], oom_rate=rates[2],
        warn_s=getattr(args, "fault_warn_s", 0.1))


def run_cluster(args, profile, tracer=None):
    plan = build_fault_plan(args)
    recovery = None
    if plan is not None:
        recovery = RecoveryPolicy(
            migrate=not getattr(args, "no_migration", False),
            migration_bw=getattr(args, "migration_bw", 16e9),
            max_retries=getattr(args, "retry_budget", 8),
            backoff_s=getattr(args, "retry_backoff_s", 0.0))
    cluster = build_sim_cluster(
        get_config(args.arch), profile, args.replicas, args.router,
        device=DEVICES[args.device], mode=args.mode,
        kv_pages=args.kv_pages, max_batch=args.max_batch, seed=args.seed,
        kv_watermark=args.kv_watermark, preemption=args.preemption,
        kv_admission=args.kv_admission, prefill_mode=args.prefill_mode,
        prefill_token_budget=args.prefill_budget,
        kv_shards=args.kv_shards,
        prefix_cache=not getattr(args, "no_prefix_cache", False),
        host_kv_pages=getattr(args, "host_kv_pages", 0),
        fault_plan=plan, recovery=recovery, tracer=tracer)
    wl_kw = {"share_ratio": args.share_ratio} \
        if getattr(args, "share_ratio", None) is not None \
        and args.workload == "shared" else {}
    wl = list(make_trace(profile, args.workload, args.rate, args.requests,
                         seed=args.seed, **wl_kw))
    frac = args.high_priority_frac
    if frac is None:
        frac = 0.25 if args.preemption else 0.0
    if frac > 0:
        stride = max(int(round(1.0 / frac)), 1)
        for r in wl:
            r.priority = 1 if r.rid % stride == 0 else 0
    deadline_s = getattr(args, "deadline_s", None)
    if deadline_s is not None:
        for r in wl:
            r.deadline = r.arrival_time + deadline_s
            r.slo_class = "deadline"
    return cluster.run(wl)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="sdar-8b")
    ap.add_argument("--mode", default="elastic",
                    help="elastic | ar | bd<chunk> (e.g. bd32)")
    ap.add_argument("--device", default="h100-sxm", choices=list(DEVICES))
    ap.add_argument("--dataset", default="sharegpt", choices=list(DATASETS))
    ap.add_argument("--replicas", type=int, default=4)
    ap.add_argument("--router", default="saturation",
                    help="round_robin | jsq | saturation")
    ap.add_argument("--workload", default="poisson",
                    choices=["poisson", "bursty", "diurnal", "shared"],
                    help="open-loop arrival process shape; shared = "
                         "multi-turn/system-prompt trace with real token "
                         "ids (exercises the prefix cache)")
    ap.add_argument("--share-ratio", type=float, default=0.8,
                    help="shared workload: fraction of fresh requests "
                         "prepending a pooled system prompt")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="disable cross-request KV prefix reuse")
    ap.add_argument("--host-kv-pages", type=int, default=0,
                    help="per-replica host spill tier capacity in pages "
                         "(0 = disabled)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="record the telemetry timeline to PATH (JSONL) "
                         "and PATH's stem + .perfetto.json (Chrome "
                         "trace_event JSON for ui.perfetto.dev)")
    ap.add_argument("--rate", type=float, default=8.0,
                    help="cluster-wide request rate (req/s)")
    ap.add_argument("--requests", type=int, default=200)
    ap.add_argument("--max-batch", type=int, default=256)
    ap.add_argument("--kv-pages", type=int, default=1 << 16,
                    help="KV pool pages per replica")
    ap.add_argument("--kv-shards", type=int, default=1,
                    help="stripe each replica's page pool across this many "
                         "KV shards (sharded allocator bookkeeping + "
                         "per-shard telemetry tracks)")
    ap.add_argument("--kv-watermark", type=float, default=0.05,
                    help="free-page fraction kept after admission")
    ap.add_argument("--kv-admission", default="incremental",
                    choices=["incremental", "reserve"],
                    help="incremental page growth + memory preemption "
                         "(default) vs legacy worst-case reservation")
    ap.add_argument("--prefill-mode", default="chunked",
                    choices=["chunked", "wave"],
                    help="chunked: interleave budget-bounded prefill "
                         "chunks with replica decode ticks (default); "
                         "wave: charge each admission's whole prompt "
                         "synchronously (baseline)")
    ap.add_argument("--prefill-budget", type=int, default=None,
                    help="fixed max prompt tokens prefetched per replica "
                         "tick (default: adaptive Sarathi-style budget "
                         "target_bc - live b*c)")
    ap.add_argument("--preemption", action="store_true",
                    help="evict low-priority requests under KV pressure")
    ap.add_argument("--high-priority-frac", type=float, default=None,
                    help="fraction of requests tagged priority 1 "
                         "(default 0.25 when --preemption is on, else 0)")
    ap.add_argument("--slo-tpot-ms", type=float, default=50.0)
    ap.add_argument("--seed", type=int, default=0)
    # -- fault tolerance -------------------------------------------------
    ap.add_argument("--faults", default=None, metavar="SPEC",
                    help="deterministic fault schedule, e.g. "
                         "'crash@2.5:r1:down=1.0:warn=0.25;"
                         "stall@1:r0:dur=0.5:slow=4;oom@3:r2:frac=0.5'")
    ap.add_argument("--crash-rate", type=float, default=0.0,
                    help="random plan: crashes per replica-second")
    ap.add_argument("--stall-rate", type=float, default=0.0,
                    help="random plan: transient stalls per replica-second")
    ap.add_argument("--oom-rate", type=float, default=0.0,
                    help="random plan: OutOfPages storms per replica-second")
    ap.add_argument("--fault-seed", type=int, default=None,
                    help="seed for the random fault plan (default: --seed)")
    ap.add_argument("--fault-horizon", type=float, default=None,
                    help="random plan horizon in seconds (default: "
                         "requests/rate)")
    ap.add_argument("--fault-warn-s", type=float, default=0.1,
                    help="crash warning lead time (drain window)")
    ap.add_argument("--no-migration", action="store_true",
                    help="naive baseline: crashed replicas' requests "
                         "re-submit from scratch instead of migrating "
                         "host-spilled state to healthy peers")
    ap.add_argument("--migration-bw", type=float, default=16e9,
                    help="host-to-host KV transfer bandwidth (bytes/s)")
    ap.add_argument("--retry-budget", type=int, default=8,
                    help="per-request failover/spill retry budget")
    ap.add_argument("--retry-backoff-s", type=float, default=0.0,
                    help="exponential backoff base between placement "
                         "retries of the same request (0 = immediate)")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="attach an absolute deadline of arrival + this "
                         "many seconds to every request (deadline-based "
                         "load shedding)")
    args = ap.parse_args()

    profile = DATASETS[args.dataset]
    tracer = Tracer() if args.trace else None
    rep = run_cluster(args, profile, tracer=tracer)
    slo = args.slo_tpot_ms * 1e-3

    print(f"replicas: {args.replicas}  router: {args.router}  "
          f"workload: {args.workload}  rate: {args.rate} req/s")
    print(f"requests completed: {len(rep.metrics)}")
    print(f"cluster throughput: {rep.throughput:.1f} tok/s")
    print(f"cluster goodput (TPOT<= {args.slo_tpot_ms:.0f}ms): "
          f"{rep.goodput(slo):.1f} tok/s "
          f"(SLO attainment {rep.slo_attainment(slo)*100:.1f}%)")
    print(f"P50/P90/P99 TPOT: {rep.tpot_percentile(50)*1e3:.1f} / "
          f"{rep.tpot_percentile(90)*1e3:.1f} / "
          f"{rep.tpot_percentile(99)*1e3:.1f} ms")
    print(f"P90 TTFT: {rep.ttft_percentile(90)*1e3:.1f} ms")
    util = rep.replica_utilization()
    print("per-replica utilization: " +
          " ".join(f"r{i}={u*100:.1f}%" for i, u in enumerate(util)))
    print("per-replica routed:      " +
          " ".join(f"r{i}={n}" for i, n in enumerate(rep.route_counts)))
    reasons = rep.reject_reasons()
    reason_str = "  ".join(f"{k}={v}" for k, v in sorted(reasons.items())) \
        or "none"
    print(f"spill-backs: {rep.spills}  preemptions: {rep.preemptions}  "
          f"rejected: {len(rep.rejected)} ({reason_str})")
    print(f"token utilization: {rep.token_utilization:.3f}")
    if rep.faults:
        kinds = {}
        for f in rep.faults:
            if f["op"] in ("crash", "stall", "oom"):
                kinds[f["op"]] = kinds.get(f["op"], 0) + 1
        kind_str = " ".join(f"{k}={v}" for k, v in sorted(kinds.items()))
        print(f"faults applied: {kind_str}  migrations: {rep.migrations} "
              f"(+{rep.migrations_failed} failed)  "
              f"re-submissions: {rep.resubmissions}")
        print(f"lost to failures: {rep.lost_tokens} committed tokens, "
              f"{rep.lost_computed_tokens} computed tokens")
    if rep.preemptions:
        pi = rep.preemption_impact()
        print(f"preemption SLO impact: {pi['n_preempted']} requests "
              f"preempted (max {pi['max_preemptions_per_request']}×/req), "
              f"P90 TPOT {pi['preempted_tpot_p']*1e3:.1f} ms vs "
              f"{pi['clean_tpot_p']*1e3:.1f} ms clean "
              f"({pi['tpot_penalty']:.2f}x)")
    if tracer is not None:
        jsonl, perfetto = tracer.export(args.trace)
        print(f"trace: {len(tracer.events)} events "
              f"({tracer.dropped} dropped) -> {jsonl}, {perfetto}")


if __name__ == "__main__":
    main()
