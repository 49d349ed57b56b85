"""Walkthrough: multi-replica cluster serving on a shared virtual clock.

The ``repro_torch`` twin of ``examples/cluster_sim.py``, host only: builds
a 3-replica SDAR-8B cluster over the virtual-clock SimBackend, serves one
bursty trace through each router policy, and then demonstrates KV-pressure
spill-back and low-priority preemption with a deliberately tiny KV pool.
The replicas' analytic device is the port's default, ``H100_SXM``;
``main(device=TPU_V5E)`` runs the reference's.

    PYTHONPATH=src python examples/cluster_sim_torch.py
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.cluster import build_sim_cluster
from repro_torch.configs import get_config
from repro_torch.core.latency_model import H100_SXM
from repro_torch.serving import DATASETS, make_trace

CFG = get_config("sdar-8b")
PROF = DATASETS["sharegpt"]


def build_cluster(n_replicas, router_name, kv_pages=1 << 16,
                  preemption=False, seed=0, device=H100_SXM):
    """Each replica: its own SimBackend (independent RNG / KV pool) plus an
    ElasticScheduler profiled against the shared analytic device model."""
    return build_sim_cluster(CFG, PROF, n_replicas, router_name,
                             device=device, kv_pages=kv_pages,
                             preemption=preemption, seed=seed)


def router_comparison(device) -> dict:
    print("== router comparison: 3 replicas, bursty trace, 24 req/s ==")
    wl = list(make_trace(PROF, "bursty", 24.0, 150, seed=7))
    out = {}
    for router in ("round_robin", "jsq", "saturation"):
        rep = build_cluster(3, router, seed=7, device=device).run(wl)
        util = rep.replica_utilization()
        print(f"  {router:<12} {rep.throughput:7.1f} tok/s  "
              f"P90 TPOT {rep.tpot_percentile(90)*1e3:6.1f} ms  "
              f"util {np.mean(util)*100:5.1f}%±{np.std(util)*100:4.1f}  "
              f"routed {rep.route_counts}")
        out[router] = {"throughput": rep.throughput,
                       "p90_tpot_s": rep.tpot_percentile(90),
                       "routed": list(rep.route_counts)}
    return out


def kv_pressure(device) -> dict:
    print("== KV-pressure admission: tiny pools force cluster spill-back ==")
    # Memory-elastic admission reserves only ~17 prompt pages/request
    # (sharegpt ≈ 264 prompt tokens / 16-token pages) but requests grow to
    # ~34 pages; a 256-page pool spills the burst back to the cluster queue
    # and replicas preempt internally when in-flight growth outruns free
    # pages — everyone still completes.
    wl = list(make_trace(PROF, "poisson", 48.0, 120, seed=11))
    rep = build_cluster(3, "saturation", kv_pages=256, seed=11,
                        device=device).run(wl)
    print(f"  completed {len(rep.metrics)}/120, spill-backs {rep.spills}, "
          f"memory preemptions {rep.preemptions}, "
          f"throughput {rep.throughput:.1f} tok/s, "
          f"P90 TTFT {rep.ttft_percentile(90)*1e3:.0f} ms")
    return {"completed": len(rep.metrics), "spills": rep.spills,
            "preemptions": rep.preemptions, "throughput": rep.throughput}


def priority_preemption(device) -> dict:
    print("== preemption: high-priority burst evicts low-priority work ==")
    wl = list(make_trace(PROF, "poisson", 48.0, 120, seed=11))
    for r in wl:
        r.priority = 1 if r.rid % 4 == 0 else 0    # every 4th is interactive
    rep = build_cluster(3, "saturation", kv_pages=1024,
                        preemption=True, seed=11, device=device).run(wl)
    hi = [m for m in rep.metrics if m.rid % 4 == 0]
    lo = [m for m in rep.metrics if m.rid % 4 != 0]
    def p90(ms):
        return float(np.percentile([m.ttft for m in ms], 90)) * 1e3

    print(f"  completed {len(rep.metrics)}/120, preemptions "
          f"{rep.preemptions}, spill-backs {rep.spills}")
    print(f"  P90 TTFT  high-priority {p90(hi):7.0f} ms   "
          f"low-priority {p90(lo):7.0f} ms")
    return {"completed": len(rep.metrics), "preemptions": rep.preemptions,
            "spills": rep.spills, "p90_ttft_hi_ms": p90(hi),
            "p90_ttft_lo_ms": p90(lo)}


def main(argv=None, device=H100_SXM) -> dict:
    """The three demos on ``device`` (a ``DeviceSpec``, not a flag: the
    script takes none); returns what they printed, as numbers."""
    argparse.ArgumentParser(description=__doc__).parse_args(argv)
    out = {"routers": router_comparison(device)}
    print()
    out["kv_pressure"] = kv_pressure(device)
    print()
    out["preemption"] = priority_preemption(device)
    return out


if __name__ == "__main__":
    main()
