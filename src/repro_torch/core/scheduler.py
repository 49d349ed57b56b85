"""Saturation-aware, memory-elastic scheduling (paper §5).

At every decode iteration the scheduler solves

    c* = argmax_{c ∈ C}  N_commit(c) · b / T_latency(c, b)

combining the offline-profiled piecewise-affine latency model (§5.2) with the
online token-utilization estimator (§5.3).  A small hysteresis keeps the
closed loop stable (the paper's "transition between granularities without
introducing instability").

The engine additionally feeds the allocator's KV utilization into
``select`` — a chunk of size ``c`` speculates ``c`` window tokens whose
commits claim fresh pages, so as free pages tighten the candidate set is
capped to smaller chunks (monotonically down to the smallest candidate),
trading a little token-throughput for fewer OutOfPages preemptions.  This
makes memory the same kind of runtime control signal as compute
saturation.

With the cross-request prefix cache (PR 8), ``kv_util`` counts *unique
physical* pages: a page shared by N block tables contributes once, and
ref-0 parked prefix pages count as free (they are reclaimable on demand),
so a warm cache never drives the memory knee — only genuinely pinned
memory throttles the chunk candidates.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.latency_model import PiecewiseAffineLatencyModel
from repro_torch.core.tu_model import TokenUtilEstimator

DEFAULT_CHUNKS = (2, 4, 8, 16, 32)


@dataclass
class ElasticScheduler:
    latency_model: PiecewiseAffineLatencyModel
    tu_estimator: TokenUtilEstimator
    candidates: tuple = DEFAULT_CHUNKS
    hysteresis: float = 0.05
    # KV-pressure knee: below memory_lo utilization the full candidate set
    # competes; between memory_lo and memory_hi the cap walks down the
    # sorted candidates; at/above memory_hi only the smallest chunk remains.
    # The knee is deliberately an EMERGENCY BRAKE (defaults measured in
    # benchmarks/kv_pressure_sweep): capping earlier throttles steady-state
    # throughput under tight pools for no memory-safety benefit, while
    # capping only near exhaustion trims the per-step reservation spike
    # exactly when free pages are about to run out — beating both an
    # aggressive cap and no cap on goodput at moderate pool pressure.
    memory_lo: float = 0.9
    memory_hi: float = 1.0
    # Failover mode: while a replica is absorbing migrated/re-submitted
    # requests after a fault, the engine passes ``conservative=True`` and
    # the scheduler evaluates the memory knee at
    # ``kv_util + failover_margin`` instead of ``kv_util``.  Big
    # speculative chunks claim big per-step page reservations; right after
    # a failover the pool is absorbing the dead replica's working set, so
    # the knee bites a margin early — trimming the spike exactly when it
    # could OutOfPages-preempt the very requests being rescued, while a
    # pool with headroom keeps serving at full chunk.  ``conservative_cap``
    # remains as an optional operator hard cap on top.
    failover_margin: float = 0.15
    conservative_cap: int | None = None
    _current: int = field(default=0, init=False)
    history: list = field(default_factory=list, init=False)
    # Decision log for telemetry: every ``select`` records its inputs AND
    # the internal state that chose the output (per-candidate TU estimates,
    # hysteresis incumbent, memory cap) — enough for
    # ``repro_torch.serving.telemetry.replay_select`` to re-run the decision from
    # the log and get the same chunk.  Rebuilt each call; a small dict, so
    # the untraced path pays ~nothing relative to the candidate scoring.
    last_decision: dict | None = field(default=None, init=False)

    def __post_init__(self):
        self._current = max(self.candidates)

    # ------------------------------------------------------------------
    def score(self, c: int, b: int, prefill_tokens: int = 0) -> float:
        """Estimated committed tokens per second at chunk size c, batch b.

        ``prefill_tokens`` is the prompt-token load the same tick carries
        (chunked prefill interleaved with the decode dispatch): it rides
        the same ``b·c`` effective-workload axis of the latency model, so
        chunk-size control and prefill share one saturation signal — near
        saturation, queued prefill pushes the pick toward smaller chunks."""
        n = self.tu_estimator.estimate(c)
        t = self.latency_model.predict_bc(b * c + prefill_tokens)
        return n * b / t

    def memory_cap(self, kv_util: float | None) -> int:
        """Largest admissible chunk at allocator utilization ``kv_util`` —
        monotonically non-increasing in utilization."""
        cands = sorted(self.candidates)
        if kv_util is None or kv_util <= self.memory_lo:
            return cands[-1]
        span = max(self.memory_hi - self.memory_lo, 1e-9)
        frac = min((kv_util - self.memory_lo) / span, 1.0)
        steps_down = int(round(frac * (len(cands) - 1)))
        return cands[len(cands) - 1 - steps_down]

    def select(self, b: int, kv_util: float | None = None,
               prefill_tokens: int = 0, conservative: bool = False) -> int:
        """Pick the chunk size for the next iteration given live batch b,
        (optionally) the KV allocator's utilization in [0, 1], the prompt
        tokens of chunked-prefill work sharing the tick, and whether the
        engine is draining a failover backlog (``conservative``)."""
        if b <= 0:
            best = max(self.candidates)
            self.last_decision = {
                "policy": "elastic", "b": b, "kv_util": kv_util,
                "prefill_tokens": prefill_tokens,
                "candidates": list(self.candidates), "cap": None,
                "cur": self._current, "held": False,
                "conservative": bool(conservative), "tu": {},
                "scores": {}, "chunk": best}
            return best
        cap = self.memory_cap(kv_util)
        if conservative:
            cap = min(cap, self.memory_cap(
                (kv_util or 0.0) + self.failover_margin))
            if self.conservative_cap is not None:
                cap = min(cap, self.conservative_cap)
        tu, scores = {}, {}
        for c in self.candidates:
            if c > cap:
                continue
            n = self.tu_estimator.estimate(c)
            tu[c] = n
            scores[c] = n * b / self.latency_model.predict_bc(
                b * c + prefill_tokens)
        best = max(scores, key=scores.get)
        cur = self._current
        held = cur in scores and \
            scores[best] <= (1 + self.hysteresis) * scores[cur]
        if held:
            best = cur
        self.last_decision = {
            "policy": "elastic", "b": b, "kv_util": kv_util,
            "prefill_tokens": prefill_tokens,
            "candidates": list(self.candidates), "cap": cap, "cur": cur,
            "held": bool(held), "hysteresis": self.hysteresis,
            "conservative": bool(conservative),
            "tu": tu, "scores": scores, "chunk": best}
        self._current = best
        self.history.append((b, best))
        return best

    def observe(self, commit_masks, valid_lens):
        """Feed back the realized commits of the last iteration."""
        self.tu_estimator.update_batch(commit_masks, valid_lens)

    # ------------------------------------------------------------------
    @classmethod
    def from_profile(cls, samples, candidates=DEFAULT_CHUNKS,
                     prior_tokens_per_step: float = 3.8, **kw):
        lm = PiecewiseAffineLatencyModel.fit(samples)
        tu = TokenUtilEstimator(candidates,
                                prior_tokens_per_step=prior_tokens_per_step)
        return cls(lm, tu, tuple(candidates), **kw)

    PROFILE_BATCHES = (1, 2, 4, 8, 16, 32, 64, 128, 256)
    PROFILE_CHUNKS = (1, 2, 4, 8, 16, 32)

    @classmethod
    def from_analytic(cls, analytic, prior_tokens_per_step: float = 3.8,
                      batches=PROFILE_BATCHES, chunks=PROFILE_CHUNKS,
                      ctx: float = 512.0, **kw):
        """Profile an :class:`AnalyticDeviceModel` over the standard
        offline grid (the stand-in for wall-clock profiling used by every
        launcher/benchmark) and fit the scheduler from it."""
        samples = [(b, c, analytic.step_latency(b, c, ctx))
                   for b in batches for c in chunks]
        return cls.from_profile(samples,
                                prior_tokens_per_step=prior_tokens_per_step,
                                **kw)


@dataclass
class FixedScheduler:
    """Baseline: fixed chunk/block size (BD-<c> or AR when c == 1)."""
    chunk: int
    history: list = field(default_factory=list, init=False)
    last_decision: dict | None = field(default=None, init=False)

    def select(self, b: int, kv_util: float | None = None,
               prefill_tokens: int = 0, conservative: bool = False) -> int:
        self.last_decision = {"policy": "fixed", "b": b, "kv_util": kv_util,
                              "prefill_tokens": prefill_tokens,
                              "chunk": self.chunk}
        self.history.append((b, self.chunk))
        return self.chunk

    def observe(self, commit_masks, valid_lens):
        pass


def scheduler_for_mode(mode: str, analytic=None,
                       prior_tokens_per_step: float = 3.8, **kw):
    """Single owner of the mode-string mapping used by every launcher:
    ``elastic`` | ``ar`` | ``bd<chunk>`` (e.g. ``bd32``)."""
    if mode == "elastic":
        return ElasticScheduler.from_analytic(
            analytic, prior_tokens_per_step=prior_tokens_per_step, **kw)
    if mode == "ar":
        return FixedScheduler(1)
    if mode.startswith("bd"):
        return FixedScheduler(int(mode[2:]))
    raise ValueError(f"unknown scheduler mode {mode!r}")
