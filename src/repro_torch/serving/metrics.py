"""Serving-level aggregate metrics: SLO capacity search, distributions, and
cluster-level aggregation across replica EngineReports."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


def slo_capacity(run_at_rate, rates, slo_tpot: float, percentile: float = 90.0):
    """Max request rate whose P<percentile> TPOT meets the SLO (paper §7.4).

    ``run_at_rate(rate) -> EngineReport``.  Returns ``(capacity, curve)``
    where ``curve = [(rate, p_tpot, throughput), ...]`` — one 3-tuple per
    probed rate, carrying the report's output-token throughput alongside
    the latency percentile so Fig. 10-style capacity plots and
    throughput-vs-rate plots come from one sweep (shape pinned by
    ``tests/test_metrics_report.py``).
    """
    curve = []
    capacity = 0.0
    for rate in rates:
        rep = run_at_rate(rate)
        p = rep.tpot_percentile(percentile)
        curve.append((rate, p, rep.throughput))
        if p <= slo_tpot:
            capacity = rate
    return capacity, curve


@dataclass
class ClusterReport:
    """Aggregate over per-replica :class:`~repro_torch.serving.engine.EngineReport`s.

    Cluster time is the makespan (the slowest replica's virtual end time —
    replicas run concurrently, so wall time is the max, not the sum).
    ``throughput`` counts every output token; ``goodput(slo)`` counts only
    tokens of requests whose TPOT met the SLO (the capacity-planning
    quantity, cf. ADOR's latency/throughput operating points).
    """

    replica_reports: list
    spills: int = 0
    preemptions: int = 0
    route_counts: list = field(default_factory=list)
    rejected: list = field(default_factory=list)   # rids refused admission
    # -- fault tolerance (PR 9) -----------------------------------------
    rejections: list = field(default_factory=list)  # structured reject dicts
    migrations: int = 0             # state-preserving cross-replica moves
    migrations_failed: int = 0      # payload had no adopter → re-prefill
    resubmissions: int = 0          # fault-displaced from-scratch re-routes
    lost_tokens: int = 0            # committed tokens wiped by crashes
    lost_computed_tokens: int = 0   # compute discarded (crash or drain)
    wiped: list = field(default_factory=list)  # rids whose stream restarted
    faults: list = field(default_factory=list)     # applied fault-op log

    @property
    def metrics(self) -> list:
        return [m for r in self.replica_reports for m in r.metrics]

    @property
    def makespan(self) -> float:
        return max((r.total_time for r in self.replica_reports), default=0.0)

    @property
    def total_tokens(self) -> int:
        return sum(r.total_tokens for r in self.replica_reports)

    @property
    def computed_tokens(self) -> int:
        return sum(r.computed_tokens for r in self.replica_reports)

    @property
    def throughput(self) -> float:
        """Cluster output tokens/sec over the makespan."""
        return self.total_tokens / max(self.makespan, 1e-9)

    @property
    def token_utilization(self) -> float:
        return self.total_tokens / max(self.computed_tokens, 1)

    def goodput(self, slo_tpot: float) -> float:
        """Output tokens/sec from requests served *cleanly*: TPOT met the
        SLO and the stream never restarted mid-flight.  A crash that wipes
        committed tokens forces a from-scratch re-serve — the user saw
        their stream reset, so those tokens are re-served work, not
        well-served work (``wiped`` carries the rids)."""
        bad = set(self.wiped)
        good = sum(m.n_tokens for m in self.metrics
                   if m.n_tokens > 0 and m.tpot <= slo_tpot
                   and m.rid not in bad)
        return good / max(self.makespan, 1e-9)

    def slo_attainment(self, slo_tpot: float) -> float:
        bad = set(self.wiped)
        ms = [m for m in self.metrics if m.n_tokens > 0]
        if not ms:
            return float("nan")
        return sum(m.tpot <= slo_tpot and m.rid not in bad
                   for m in ms) / len(ms)

    def replica_utilization(self) -> list:
        """Fraction of the cluster makespan each replica spent computing."""
        span = max(self.makespan, 1e-9)
        return [r.busy_time / span for r in self.replica_reports]

    def tpot_percentile(self, q: float = 90.0) -> float:
        vals = [m.tpot for m in self.metrics if m.n_tokens > 0]
        return float(np.percentile(vals, q)) if vals else float("nan")

    def ttft_percentile(self, q: float = 90.0) -> float:
        vals = [m.ttft for m in self.metrics if m.first_token_time >= 0]
        return float(np.percentile(vals, q)) if vals else float("nan")

    def reject_reasons(self) -> dict:
        """Structured breakdown of refused admissions: ``never_fits``
        (bigger than any replica's pool/context — would queue forever),
        ``pool_pressure`` (spill-retry budget exhausted under sustained
        saturation), ``deadline`` (shed — even the optimistic service
        floor missed the request's deadline).  Legacy fault-free runs
        predate the structured records; their rejects all came from the
        ``fits_ever`` gate, so count them as ``never_fits``."""
        if not self.rejections and self.rejected:
            return {"never_fits": len(self.rejected)}
        out: dict = {}
        for rec in self.rejections:
            out[rec["reason"]] = out.get(rec["reason"], 0) + 1
        return out

    def preemption_impact(self, q: float = 90.0) -> dict:
        """SLO impact of eviction+recompute: TPOT percentile of requests
        that were preempted at least once vs never-preempted ("clean")
        requests, the penalty ratio between them, and the worst per-request
        eviction count (bounded by the engine's starvation guard)."""
        finished = [m for m in self.metrics if m.n_tokens > 0]
        pre = [m.tpot for m in finished if m.preemptions > 0]
        clean = [m.tpot for m in finished if m.preemptions == 0]
        p_pre = float(np.percentile(pre, q)) if pre else float("nan")
        p_clean = float(np.percentile(clean, q)) if clean else float("nan")
        return {
            "n_preempted": len(pre),
            "n_clean": len(clean),
            "total_preemptions": self.preemptions,
            "max_preemptions_per_request": max(
                (m.preemptions for m in self.metrics), default=0),
            "preempted_tpot_p": p_pre,
            "clean_tpot_p": p_clean,
            "tpot_penalty": p_pre / p_clean
            if pre and clean and p_clean > 0 else float("nan"),
        }


def chunk_distribution(report):
    """Fig. 11-style runtime distributions."""
    chunks = np.array([c for _, _, c in report.chunk_history], float)
    batches = np.array(report.batch_history, float)
    if len(chunks) == 0:
        return {}
    return {
        "chunk_mean": float(chunks.mean()),
        "chunk_median": float(np.median(chunks)),
        "chunk_min": float(chunks.min()),
        "chunk_max": float(chunks.max()),
        "batch_mean": float(batches.mean()),
        "batch_median": float(np.median(batches)),
        "batch_max": float(batches.max()),
    }
