"""Saturation-frontier visualization: sweep (batch × chunk) with the
calibrated device model and show which granularity the elastic scheduler
picks at each load — the paper's Fig. 3(d)/Fig. 8 in table form.  The
``repro_torch`` twin of ``examples/scheduler_sim.py``: host only, the same
tables, with the port's device list (``h100-sxm``, its default, too).

    PYTHONPATH=src python examples/scheduler_sim_torch.py [--device a100-80g]
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core import (AnalyticDeviceModel, ElasticScheduler,
                              PiecewiseAffineLatencyModel, TokenUtilEstimator)
from repro_torch.core.latency_model import DEVICES
from repro_torch.serving import DATASETS, SimBackend

CHUNKS = [2, 4, 8, 16, 32]
BATCHES = [1, 2, 4, 8, 16, 32, 64, 128, 256]
CTX = 512


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="h100-sxm", choices=list(DEVICES))
    ap.add_argument("--dataset", default="sharegpt", choices=list(DATASETS))
    return ap.parse_args(argv)


def throughput_table(am, sim) -> dict:
    """Committed tokens/s at each (batch, chunk), printed as the table;
    returns {batch: row}."""
    print("committed tokens/sec by (batch ↓, chunk →):")
    print("  bs |" + "".join(f" c={c:<7d}" for c in CHUNKS) + " | best")
    table = {}
    for b in BATCHES:
        row = []
        for c in CHUNKS:
            n = sim.expected_commits(c)
            t = am.step_latency(b, c, CTX)
            row.append(n * b / t)
        table[b] = row
        best = CHUNKS[int(np.argmax(row))]
        print(f"{b:4d} |" + "".join(f" {v:8.0f}" for v in row) +
              f" | c={best}")
    return table


def scheduler_selections(am, sim) -> dict:
    """What the closed-loop scheduler picks at each batch, after 300 draws
    of the commit curve; printed, and returned as {batch: chunk}."""
    samples = [(b, c, am.step_latency(b, c, CTX)) for b in BATCHES
               for c in [1] + CHUNKS]
    pw = PiecewiseAffineLatencyModel.fit(samples)
    tu = TokenUtilEstimator(CHUNKS)
    rng = np.random.default_rng(0)
    for _ in range(300):
        tu.update(rng.random(32) < sim.p(np.arange(32)), 32)
    sch = ElasticScheduler(pw, tu, tuple(CHUNKS), hysteresis=0.0)
    picks = {b: sch.select(b) for b in BATCHES}
    print("\nelastic scheduler selections:", picks)
    print("→ the optimal granularity tracks the saturation frontier "
          "(paper Fig. 3d)")
    return picks


def main(argv=None) -> dict:
    args = parse_args(argv)
    cfg = get_config("sdar-8b")
    prof = DATASETS[args.dataset]
    dev = DEVICES[args.device]
    am = AnalyticDeviceModel(cfg, dev)
    sim = SimBackend(cfg, dev, tokens_per_step=prof.tokens_per_step_bd32).sim

    print(f"model={cfg.name} device={dev.name} dataset={prof.name}")
    ew = am.saturation_ew(CTX)
    print(f"saturation EW (b·c where compute overtakes memory): "
          f"{ew:.0f}\n")
    table = throughput_table(am, sim)
    picks = scheduler_selections(am, sim)
    return {"saturation_ew": float(ew), "table": table,
            "selections": {b: int(c) for b, c in picks.items()}}


if __name__ == "__main__":
    main()
