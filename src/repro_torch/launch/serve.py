"""Serving launcher (PyTorch port).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch sdar-8b \
        --mode elastic --dataset sharegpt --rate 2.0 --requests 100

``--backend sim`` (default) runs the virtual-clock simulation calibrated to
the chosen analytic device spec; ``--backend model`` serves a real
(smoke-config) model end-to-end through the same engine on
``--torch-device`` (default ``cuda``; ``cpu`` runs the kernels' plain
versions).  Every family but encdec serves: the attention-only ones
through the paged KV pool, ssm (``--arch rwkv6-1.6b``) and hybrid
(``--arch jamba-1.5-large-398b``) through the recurrent-slot cache.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.latency_model import DEVICES
from repro_torch.core.scheduler import ElasticScheduler, scheduler_for_mode
from repro_torch.models.registry import build_model
from repro_torch.serving import (DATASETS, ModelBackend, ServingEngine,
                           SimBackend, Tracer, chunk_distribution,
                           make_trace)


def make_scheduler(mode: str, backend, profile):
    return scheduler_for_mode(
        mode, backend.analytic if backend is not None else None,
        prior_tokens_per_step=profile.tokens_per_step_bd32)


def run_single_replica_faults(args, profile):
    """``--faults`` on the sim backend: serve the same workload through a
    one-replica cluster engine (the fault timeline lives there)."""
    from repro_torch.cluster import build_sim_cluster
    from repro_torch.common.faults import FaultPlan

    wl_kw = {"share_ratio": args.share_ratio} \
        if args.workload == "shared" else {}
    cluster = build_sim_cluster(
        get_config(args.arch), profile, 1, "rr",
        device=DEVICES[args.device], mode=args.mode,
        kv_pages=args.kv_pages or 1 << 16, max_batch=args.max_batch,
        seed=args.seed, kv_admission=args.kv_admission,
        prefill_mode=args.prefill_mode,
        prefill_token_budget=args.prefill_budget, kv_shards=args.kv_shards,
        prefix_cache=not args.no_prefix_cache,
        host_kv_pages=args.host_kv_pages,
        fault_plan=FaultPlan.parse(args.faults))
    wl = make_trace(profile, args.workload, args.rate, args.requests,
                    seed=args.seed, **wl_kw)
    rep = cluster.run(list(wl))
    print(f"requests: {len(rep.metrics)}")
    print(f"decode throughput: {rep.throughput:.1f} tok/s")
    print(f"P50/P90/P99 TPOT: {rep.tpot_percentile(50)*1e3:.1f} / "
          f"{rep.tpot_percentile(90)*1e3:.1f} / "
          f"{rep.tpot_percentile(99)*1e3:.1f} ms")
    kinds = {}
    for f in rep.faults:
        if f["op"] in ("crash", "stall", "oom"):
            kinds[f["op"]] = kinds.get(f["op"], 0) + 1
    print("faults applied: " +
          (" ".join(f"{k}={v}" for k, v in sorted(kinds.items())) or "none"))
    print(f"re-submissions: {rep.resubmissions}  "
          f"lost tokens: {rep.lost_tokens}")
    reasons = rep.reject_reasons()
    print("rejects: " + (" ".join(f"{k}={v}"
                                  for k, v in sorted(reasons.items()))
                         or "none"))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="sdar-8b")
    ap.add_argument("--mode", default="elastic",
                    help="elastic | ar | bd<chunk> (e.g. bd32)")
    ap.add_argument("--backend", default="sim", choices=["sim", "model"])
    ap.add_argument("--device", default="h100-sxm", choices=list(DEVICES))
    ap.add_argument("--dataset", default="sharegpt", choices=list(DATASETS))
    ap.add_argument("--rate", type=float, default=2.0)
    ap.add_argument("--requests", type=int, default=100)
    ap.add_argument("--max-batch", type=int, default=256)
    ap.add_argument("--obs", action="store_true",
                    help="out-block streaming for large chunks")
    ap.add_argument("--kv-pages", type=int, default=None,
                    help="KV pool pages (sim default 65536; model default "
                         "mirrors 8 slots × max_len)")
    ap.add_argument("--kv-shards", type=int, default=1,
                    help="split the paged KV pool across this many "
                         "devices on a 'kv' mesh axis (model backend: "
                         "split-KV paged decode with an exact partial "
                         "merge, one visible card a shard; sim backend: "
                         "sharded allocator bookkeeping)")
    ap.add_argument("--kv-admission", default="incremental",
                    choices=["incremental", "reserve"],
                    help="sim backend: incremental page growth with "
                         "preemption-on-OutOfPages (default) vs legacy "
                         "worst-case reservation at admit")
    ap.add_argument("--prefill-mode", default="chunked",
                    choices=["chunked", "wave"],
                    help="chunked: interleave budget-bounded page-aligned "
                         "prefill chunks with decode ticks (default); "
                         "wave: the monolithic whole-admission-wave "
                         "prefill baseline")
    ap.add_argument("--prefill-budget", type=int, default=None,
                    help="fixed max prompt tokens prefetched per engine "
                         "tick (default: the model backend on an H100 SXM "
                         "or A100 SXM takes the prefill dispatch's own "
                         "saturation point; the CPU and the sim the adaptive "
                         "Sarathi-style target_bc - live b*c)")
    ap.add_argument("--workload", default="poisson",
                    choices=["poisson", "bursty", "diurnal", "shared"],
                    help="arrival trace: shared = multi-turn/system-prompt "
                         "trace with real token ids (exercises the prefix "
                         "cache)")
    ap.add_argument("--share-ratio", type=float, default=0.8,
                    help="shared workload: fraction of fresh requests "
                         "prepending a pooled system prompt")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="disable cross-request KV prefix reuse")
    ap.add_argument("--host-kv-pages", type=int, default=0,
                    help="host-memory spill tier capacity in pages "
                         "(0 = disabled); preemptions spill instead of "
                         "discarding when the cost model favors the swap")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="record the telemetry timeline to PATH (JSONL) "
                         "and PATH's stem + .perfetto.json (Chrome "
                         "trace_event JSON for ui.perfetto.dev)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--faults", default=None, metavar="SPEC",
                    help="sim backend only: run through a single-replica "
                         "cluster engine with this deterministic fault "
                         "schedule (e.g. 'stall@1:r0:dur=0.5:slow=4'); "
                         "see serve_cluster for multi-replica failover")
    ap.add_argument("--torch-device", default="cuda",
                    help="model backend: torch device the model, page pool "
                         "and kernels run on (cpu runs the plain versions)")
    args = ap.parse_args()

    profile = DATASETS[args.dataset]
    if args.faults:
        if args.backend != "sim":
            ap.error("--faults requires --backend sim")
        run_single_replica_faults(args, profile)
        return
    wl_kw = {"share_ratio": args.share_ratio} \
        if args.workload == "shared" else {}
    if args.backend == "sim":
        cfg = get_config(args.arch)
        backend = SimBackend(cfg, DEVICES[args.device],
                             tokens_per_step=profile.tokens_per_step_bd32,
                             decode_mode="ar" if args.mode == "ar"
                             else "elastic", obs=args.obs, seed=args.seed,
                             kv_pool_pages=args.kv_pages or 1 << 16,
                             kv_admission=args.kv_admission,
                             prefill_mode=args.prefill_mode,
                             prefill_token_budget=args.prefill_budget,
                             kv_shards=args.kv_shards,
                             prefix_cache=not args.no_prefix_cache,
                             host_kv_pages=args.host_kv_pages)
        wl = make_trace(profile, args.workload, args.rate, args.requests,
                        seed=args.seed, **wl_kw)
        sched = make_scheduler(args.mode, backend, profile)
    else:
        cfg = get_smoke_config(args.arch)
        model = build_model(cfg)
        dev = torch.device(args.torch_device)
        params = model.init_params(
            torch.Generator(device=dev).manual_seed(args.seed), device=dev)
        # attention families serve through the paged KV pool automatically
        # (prompt-pages-only admission + incremental growth); ssm and hybrid
        # through the recurrent-slot cache, which ignores the pool's options
        backend = ModelBackend(model, params, n_slots=8, max_len=256,
                               decode_mode="ar" if args.mode == "ar"
                               else "elastic", obs=args.obs,
                               kv_pages=args.kv_pages,
                               prefill_mode=args.prefill_mode,
                               prefill_token_budget=args.prefill_budget,
                               kv_shards=args.kv_shards,
                               prefix_cache=not args.no_prefix_cache,
                               host_kv_pages=args.host_kv_pages,
                               device=dev)
        rng = np.random.default_rng(args.seed)
        mkw = dict(wl_kw)
        if args.workload == "shared":
            # real ids must stay inside the smoke vocab (away from the
            # reserved mask/eos ids at the top)
            mkw.update(vocab=max(cfg.vocab_size - 8, 16), prefix_len=32)
        wl = make_trace(profile, args.workload, args.rate, args.requests,
                        seed=args.seed, max_prompt=64, max_output=64, **mkw)
        for r in wl.requests:
            r.prompt_len = min(r.prompt_len, 64)
            r.max_new_tokens = min(r.max_new_tokens, 64)
            if r.prompt_tokens is not None:
                # shared trace carries real ids; just clamp to max_prompt
                r.prompt_tokens = r.prompt_tokens[:r.prompt_len]
            else:
                r.prompt_tokens = rng.integers(
                    4, cfg.vocab_size, r.prompt_len).tolist()
        # wall-clock-free scheduler from a quick analytic stand-in
        from repro_torch.core.latency_model import AnalyticDeviceModel, CPU_HOST
        if args.mode == "elastic":
            sched = ElasticScheduler.from_analytic(
                AnalyticDeviceModel(cfg, CPU_HOST),
                prior_tokens_per_step=profile.tokens_per_step_bd32,
                batches=(1, 2, 4, 8), ctx=128.0)
        else:
            sched = make_scheduler(args.mode, None, profile)

    tracer = Tracer() if args.trace else None
    engine = ServingEngine(backend, sched, max_batch=args.max_batch,
                           tracer=tracer)
    report = engine.run(list(wl))
    if tracer is not None:
        jsonl, perfetto = tracer.export(args.trace)
        print(f"trace: {len(tracer.events)} events "
              f"({tracer.dropped} dropped) -> {jsonl}, {perfetto}")
    print(f"requests: {len(report.metrics)}")
    print(f"decode throughput: {report.throughput:.1f} tok/s")
    print(f"P50/P90/P99 TPOT: {report.tpot_percentile(50)*1e3:.1f} / "
          f"{report.tpot_percentile(90)*1e3:.1f} / "
          f"{report.tpot_percentile(99)*1e3:.1f} ms")
    print(f"token utilization: {report.token_utilization:.3f}")
    print(f"memory preemptions: {report.preemptions}")
    print(f"runtime distributions: {chunk_distribution(report)}")


if __name__ == "__main__":
    main()
