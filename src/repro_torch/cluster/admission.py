"""KV-pressure-aware cluster admission with queue spill-back.

Fan et al. (*Taming the Memory Footprint Crisis*) show that at fleet scale
the binding constraint is KV-cache admission: placing a request on a replica
whose pool cannot (soon) hold it head-of-line-blocks that replica's whole
queue.  Since the KV layer went memory-elastic, backends admit on **prompt
pages only** and grow incrementally, so the policy reserves each queued
request's *admission* pages (prompt-only for incremental backends, the full
footprint for legacy ``reserve``-mode sims) and only places a request if the
pool keeps a free-page watermark after the reservation — the watermark is
now the headroom that absorbs in-flight page growth before the engine has
to preempt.  Otherwise the request *spills back* to the cluster queue and
is retried as replicas drain.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.serving.request import Request


def kv_tokens(req: Request) -> int:
    """Full KV footprint — every token the request holds at completion."""
    return req.prompt_len + req.max_new_tokens


def admission_pages(core, req: Request) -> int:
    """Pages the replica's backend claims when it admits ``req`` (the
    backend knows whether it reserves the prompt or the worst case).

    With the prefix cache this is the demand *net of prefix hits*: the
    backend's ``admit_pages`` subtracts pages the trie already holds for
    the prompt (and for a spilled request it is the swap-in footprint),
    so KV-pressure admission and the saturation router see the true
    marginal cost of placing the request on this replica."""
    fn = getattr(core.backend, "admit_pages", None)
    if fn is not None:
        return fn(req)
    kv = getattr(core.backend, "kv", None)
    return kv.pages_for(req.prompt_len) if kv is not None else 0


def fits_ever(core, req: Request) -> bool:
    """Whether the request could ever *complete* on an empty replica — it
    must hold its full ``prompt + max_new`` footprint at finish even under
    incremental growth, so a request bigger than the whole KV pool (or
    model context length) would queue/preempt forever and live-lock the
    event loop.  Paged model backends carry *both* bounds (allocator pages
    and per-request ``max_len``), so the checks compose."""
    kv = getattr(core.backend, "kv", None)
    if kv is not None and kv.pages_for(kv_tokens(req)) > kv.n_pages:
        return False
    max_len = getattr(core.backend, "max_len", None)
    if max_len is not None and kv_tokens(req) > max_len:
        return False
    return True


def service_floor(core, req: Request) -> float:
    """Optimistic lower bound on ``req``'s total service time on ``core``:
    a b=1 prefill forward plus decode assuming *every* window token of the
    best candidate chunk commits every step.  Real runs are strictly
    slower (batching queue, partial commits, preemptions), so deadline
    shedding against this floor only drops requests that cannot make
    their deadline even in the best case — it never sheds feasible work.
    Fixed-chunk baselines without a latency model return 0 (never shed on
    service time, only on a deadline already in the past)."""
    sched = getattr(core, "scheduler", None)
    lm = getattr(sched, "latency_model", None)
    if lm is None:
        return 0.0
    cands = getattr(sched, "candidates", None) or (1,)
    prefill = lm.predict_bc(req.prompt_len) if req.prompt_len > 0 else 0.0
    decode = min(-(-req.max_new_tokens // c) * lm.predict_bc(c)
                 for c in cands)
    return prefill + decode


@dataclass
class KVAdmissionPolicy:
    """Admit onto a replica only if, after reserving admission pages for
    every request already queued there, the new request still fits with
    ``low_watermark`` of the pool left free (headroom for in-flight page
    growth before memory preemption kicks in)."""

    low_watermark: float = 0.05

    def reserved_pages(self, core) -> int:
        kv = getattr(core.backend, "kv", None)
        if kv is None:
            return 0
        return sum(admission_pages(core, r) for r in core.pending_requests())

    def admissible(self, core, req: Request) -> bool:
        kv = getattr(core.backend, "kv", None)
        if kv is None:
            # Slot-cache ModelBackend (no allocator): queue if the request
            # can ever fit; the engine-level can_admit gate does the rest.
            # Sim and paged model backends both expose ``.kv`` and take the
            # page-reservation branch below — one KV-pressure signal.
            return core.backend.can_admit(req) or core.n_active > 0
        need = admission_pages(core, req)
        headroom = kv.free_pages - self.reserved_pages(core) - need
        return headroom >= self.low_watermark * kv.n_pages

    # -- preemption support ------------------------------------------------
    def preemption_victims(self, core, req: Request) -> list[int]:
        """Smallest set of lower-priority active rids whose eviction frees
        enough pages to admit ``req`` (lowest priority, least progress
        first).  Empty list ⇒ preemption cannot help on this replica.

        Starvation guard: requests already evicted ``core.preemption_cap``
        times are never picked again by *cluster-tier* preemption — the
        preemptor spills back to the cluster queue instead (unlike the
        engine's memory preemption, nothing here requires eviction for
        safety, so the guard has no waiver)."""
        kv = getattr(core.backend, "kv", None)
        if kv is None:
            return []
        need = admission_pages(core, req)
        deficit = need + self.reserved_pages(core) - kv.free_pages \
            + int(self.low_watermark * kv.n_pages)
        if deficit <= 0:
            return []            # admissible without eviction

        def progress(r):
            try:
                return core.backend.state(r.rid).n_committed
            except KeyError:
                return 0

        cap = getattr(core, "preemption_cap", None)
        count = getattr(core, "preemption_count", lambda rid: 0)
        candidates = sorted(
            (r for r in core.active_requests()
             if r.priority < req.priority
             and (cap is None or count(r.rid) < cap)),
            key=lambda r: (r.priority, progress(r)))
        victims, freed = [], 0
        for r in candidates:
            victims.append(r.rid)
            freed += kv.table_len(r.rid)
            if freed >= deficit:
                return victims
        return []                # even evicting everything would not fit
