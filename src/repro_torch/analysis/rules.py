"""Pass 1 — dispatch rules over the dispatch inventory.

Each rule takes artifacts of one dispatch — its op trace
(:mod:`repro_torch.analysis.optrace`), its returned tensors, the pool's
tensors before and after, the collective record — plus the entry's
declared expectations, and returns
:class:`~repro_torch.analysis.findings.Finding` records.  Rule IDs are the
JAX package's, each with its semantics in torch form:

======  ====================================================================
HLO001  pool in place — every pool tensor's ``data_ptr()`` is unchanged by
        the dispatch and the dispatch allocates no copy of a pool tensor
        (no op result of its shape and dtype in the op trace; on the card
        also no net growth of ``torch.cuda.memory_allocated`` as large as
        one): the torch form of donation
HLO002  vocab-axis escape — no returned tensor has a vocab-sized axis (the
        fused step must reduce ``[B,c,V]`` logits on device)
HLO003  host-transfer budget — the returned bytes that are not the pool's
        are bounded by the analytic formula (O(B·c) scalars), and on CUDA
        the dispatch makes no host synchronisation
HLO004  collective audit — the kinds and per-device bytes the dispatch
        reduced across shards (the collective record) match the analytic
        ``collective_bytes`` model exactly
HLO005  dispatch-shape churn — running an entry across the tick shape grid
        sees at most the declared number of input-shape signatures (the
        torch form of the jit cache size), and a backend's graph cache
        captures at most that many graphs over the raw batches (a slot
        backend's: 2 + one a distinct advance length)
HLO006  inventory registration — every dispatch call and graph-capture
        site in the serving modules is registered in
        :data:`repro_torch.analysis.inventory.KNOWN_DISPATCH_SITES`
======  ====================================================================

The port's tests and ``chip_smoke.py`` call these rules instead of private
checks (:func:`pool_tensors`, :func:`check_pool_donation`,
:func:`check_host_budget`).
"""

from __future__ import annotations

import warnings

import torch

from repro_torch.analysis.findings import Finding


def pool_tensors(pool) -> list:
    """The pool's tensors: a cache dict's ``k_pages``/``v_pages`` (each a
    tensor, or a sharded pool's list of blocks), a ``PagedKVAllocator``'s
    blocks, or a list of tensors as it is."""
    if hasattr(pool, "pool_blocks"):
        ks, vs, _ = pool.pool_blocks()
        return list(ks) + list(vs)
    if isinstance(pool, dict):
        out = []
        for name in ("k_pages", "v_pages"):
            t = pool[name]
            out += list(t) if isinstance(t, (list, tuple)) else [t]
        return out
    return list(pool)


def pool_ptrs(pool) -> tuple:
    return tuple(t.data_ptr() for t in pool_tensors(pool))


# ---------------------------------------------------------------------------
# HLO001 — the pool updated in place
# ---------------------------------------------------------------------------

def check_pool_donation(pool, ptrs_before, trace=None, *,
                        target: str = "dispatch",
                        grown_bytes: int | None = None) -> list:
    """The page pool must be updated in place: every tensor of ``pool``
    (after the dispatch) at the ``data_ptr`` it had before
    (``ptrs_before``), no op of ``trace`` allocating a tensor of a pool
    tensor's shape and dtype, and — on the card —
    ``torch.cuda.memory_allocated`` grown by less than a pool tensor's
    bytes (``grown_bytes``, after minus before)."""
    tensors = pool_tensors(pool)
    out = []
    moved = [i for i, (t, p) in enumerate(zip(tensors, ptrs_before))
             if t.data_ptr() != p]
    if moved or len(tensors) != len(ptrs_before):
        out.append(Finding(
            "HLO001", target,
            f"pool tensors {moved} moved (data_ptr changed; {len(tensors)} "
            f"tensors after, {len(ptrs_before)} before) — the dispatch "
            f"rebuilt the pool instead of updating it in place"))
    least = min(t.numel() * t.element_size() for t in tensors)
    kinds = {(tuple(t.shape), t.dtype) for t in tensors}
    if trace is not None:
        for op in trace.ops:
            copies = [m for m in op.allocs if (m.shape, m.dtype) in kinds]
            if copies:
                out.append(Finding(
                    "HLO001", target,
                    f"op {op.name} allocates {list(copies[0].shape)} "
                    f"{copies[0].dtype} ({copies[0].nbytes} B), a pool "
                    f"tensor's shape — each step materializes a pool copy"))
                break
    if grown_bytes is not None and grown_bytes >= least:
        out.append(Finding(
            "HLO001", target,
            f"memory_allocated grew {grown_bytes} B across the dispatch, >= "
            f"a pool tensor's {least} B — a pool copy outlives it"))
    return out


# ---------------------------------------------------------------------------
# HLO002 — no vocab-axis escape
# ---------------------------------------------------------------------------

def _vocab_shaped(dims, vocab_size: int) -> bool:
    return vocab_size in tuple(dims)


def check_vocab_escape(outputs, *, vocab_size: int,
                       target: str = "dispatch") -> list:
    """No returned tensor (``outputs``: the dispatch's, e.g. a trace's
    ``outputs``) may carry a vocab-sized axis.  Vocab-sized intermediates
    inside the dispatch are fine; a returned ``[B,c,V]`` is an O(V)
    transfer."""
    out = []
    for i, t in enumerate(outputs):
        shape = tuple(t.shape)
        if _vocab_shaped(shape, vocab_size):
            out.append(Finding(
                "HLO002", target,
                f"dispatch output {i} is {t.dtype}{list(shape)} "
                f"({t.numel() * t.element_size()} B) with a vocab-sized axis "
                f"(V={vocab_size}) — logits escape the fused step"))
    return out


def census_vocab_intermediates(trace, *, vocab_size: int) -> list:
    """Informational: traced intermediates carrying a vocab axis (allowed,
    reported by ``--verbose``), one (op, shape) each."""
    return [(op.name, m.shape) for op in trace.ops for m in op.outputs
            if _vocab_shaped(m.shape, vocab_size)]


# ---------------------------------------------------------------------------
# HLO003 — host-transfer budget, no host sync
# ---------------------------------------------------------------------------

def fresh_outputs(outputs, pool=None) -> list:
    """The returned tensors that are not the pool's (by storage)."""
    held = {t.untyped_storage().data_ptr() for t in pool_tensors(pool)} \
        if pool is not None else set()
    return [t for t in outputs
            if t.untyped_storage().data_ptr() not in held]


def check_host_budget(outputs, *, budget_bytes: int, pool=None,
                      syncs: int | None = None,
                      target: str = "dispatch") -> list:
    """The returned tensors other than the pool's are all a host fetch can
    move; their bytes must not exceed the analytic per-dispatch
    ``host_transfer_bytes`` formula (conf fp32 + tok int32 = 8 B per window
    slot for the fused decode step).  ``syncs``: the host synchronisations
    the dispatch made (:func:`count_syncs`, on CUDA), which must be 0."""
    fresh = fresh_outputs(outputs, pool)
    nbytes = sum(t.numel() * t.element_size() for t in fresh)
    out = []
    if nbytes > budget_bytes:
        shapes = ", ".join(f"{t.dtype}{list(t.shape)}" for t in fresh)
        out.append(Finding(
            "HLO003", target,
            f"non-pool output bytes {nbytes} exceed the analytic "
            f"host-transfer budget {budget_bytes} (fresh outputs: "
            f"{shapes})"))
    if syncs:
        out.append(Finding(
            "HLO003", target,
            f"the dispatch synchronised with the host {syncs} time(s) "
            f"(torch.cuda.set_sync_debug_mode) — a dispatch's only "
            f"transfer is its fetch of the results"))
    return out


# what torch.cuda's sync debug mode says at each synchronising operation
# (its first use also warns that the mode is a prototype: not a sync)
SYNC_WARNING = "called a synchronizing CUDA operation"


def count_syncs(run, device) -> tuple:
    """``(syncs, run())``: on a CUDA device the number of synchronising
    operations ``run`` made, under ``torch.cuda.set_sync_debug_mode
    ("warn")``; None elsewhere."""
    if torch.device(device).type != "cuda":
        return None, run()
    torch.cuda.synchronize(device)
    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = run()
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    n = sum(1 for w in caught if SYNC_WARNING in str(w.message))
    return n, out


# ---------------------------------------------------------------------------
# HLO004 — collective audit
# ---------------------------------------------------------------------------

def check_collectives(actual: dict, *, expected: dict,
                      target: str = "dispatch",
                      tolerance: float = 0.0) -> list:
    """What the dispatch reduced across shards must match the analytic
    model exactly: same kinds, same per-device operand bytes.  ``actual``
    maps kind → ``{"bytes", "count"}`` (the collective record over the
    dispatch); ``expected`` maps kind → bytes (e.g. ``{"all-reduce": N}``);
    an empty dict asserts no collective at all."""
    got = {k: v for k, v in actual.items() if v["count"] > 0}
    out = []
    for kind in sorted(set(got) - set(expected)):
        out.append(Finding(
            "HLO004", target,
            f"unexpected collective {kind}: {got[kind]['bytes']:.0f} B "
            f"({got[kind]['count']:.0f} ops) — analytic model declares "
            f"none"))
    for kind in sorted(set(expected) - set(got)):
        out.append(Finding(
            "HLO004", target,
            f"missing collective {kind}: analytic model expects "
            f"{expected[kind]:.0f} B, the dispatch reduced none"))
    for kind in sorted(set(expected) & set(got)):
        want, have = float(expected[kind]), float(got[kind]["bytes"])
        if abs(have - want) > tolerance * max(want, 1.0):
            out.append(Finding(
                "HLO004", target,
                f"{kind} volume mismatch: reduced {have:.0f} B vs "
                f"analytic {want:.0f} B ({got[kind]['count']:.0f} ops)"))
    return out


# ---------------------------------------------------------------------------
# HLO005 — dispatch-shape churn
# ---------------------------------------------------------------------------

def signature(args, kwargs) -> tuple:
    """The input-shape signature of a call: (shape, dtype) of every tensor
    argument, in order (a pool's blocks too)."""
    from torch.utils._pytree import tree_flatten
    return tuple((tuple(x.shape), x.dtype)
                 for x in tree_flatten((args, kwargs))[0]
                 if isinstance(x, torch.Tensor))


def check_recompile_churn(fn, arg_makers, *, declared_buckets: int,
                          target: str = "dispatch") -> list:
    """Run ``fn`` across the tick shape grid (each ``arg_makers[i]()``
    returns ``(args, kwargs)`` for one raw tick shape, already routed
    through the backend's bucketing); at most ``declared_buckets`` distinct
    input-shape signatures may appear.  More means a raw shape reaches the
    dispatch, and a captured graph would be made per batch size."""
    sigs, shapes_run = set(), []
    for make in arg_makers:
        args, kwargs = make()
        shapes_run.append(tuple(tuple(a.shape) for a in args
                                if isinstance(a, torch.Tensor)))
        sigs.add(signature(args, kwargs))
        fn(*args, **kwargs)
    if len(sigs) <= declared_buckets:
        return []
    return [Finding(
        "HLO005", target,
        f"{len(arg_makers)} grid shapes gave {len(sigs)} distinct input "
        f"signatures, declared bucket count is {declared_buckets} — "
        f"shape bucketing is leaking (grid: {shapes_run})")]


# the paged dispatch kinds of a backend's graph cache (its page moves,
# ``copy`` and ``swap_in``, are held by check_pool_graph_churn)
PAGED_KINDS = ("decode", "chunk", "wave")
POOL_KINDS = ("copy", "swap_in")


def check_graph_churn(graphs, drive, raw_batches, *, declared_buckets: int,
                      target: str = "graphs") -> list:
    """The captured half of HLO005: ``drive(b)`` runs one dispatch of raw
    batch ``b`` through a backend whose graph cache is ``graphs`` (a
    :class:`~repro_torch.serving.graphs.DispatchGraphs`); over
    ``raw_batches`` at most ``declared_buckets`` graphs of the paged kinds
    may be captured."""
    before = set(graphs.entries)
    for b in raw_batches:
        drive(b)
    new = [k for k in graphs.entries
           if k not in before and k[0] in PAGED_KINDS]
    if len(new) <= declared_buckets:
        return []
    return [Finding(
        "HLO005", target,
        f"raw batches {list(raw_batches)} captured {len(new)} graphs "
        f"({new}), declared bucket count is {declared_buckets} — a raw "
        f"batch reaches the graph cache unbucketed")]


def check_pool_graph_churn(graphs, pool, *,
                           target: str = "graphs@pool") -> list:
    """HLO005 for the page moves: each pool kind of a backend's graph
    cache holds at most ``blocks · (⌈log₂ P⌉ + 1)`` graphs, P the pages a
    block: one a block and power-of-two page count (the index vectors pad
    to one)."""
    ks, _, per = pool.pool_blocks()
    allowed = len(ks) * (max(per - 1, 0).bit_length() + 1)
    out = []
    for kind in POOL_KINDS:
        keys = [k for k in graphs.entries if k[0] == kind]
        if len(keys) > allowed:
            out.append(Finding(
                "HLO005", f"{target}:{kind}",
                f"{len(keys)} {kind} graphs ({keys}), more than {len(ks)} "
                f"blocks x (ceil(log2 {per}) + 1) = {allowed} — a page "
                f"count reaches the graph cache unpadded"))
    return out


def check_slot_graph_churn(graphs, advance_lengths, *,
                           target: str = "graphs@slot") -> list:
    """HLO005 in slot form: a recurrent-slot backend's graph cache
    (``graphs``) holds at most one ``slot_prefill`` graph (slot, length and
    the padded prompt are static inputs), one ``window`` graph and one
    ``advance`` graph a distinct T of ``advance_lengths`` (the lengths its
    advances ran at: T is never padded)."""
    allowed = 2 + len(set(advance_lengths))
    n = len(graphs.entries)
    if n <= allowed:
        return []
    return [Finding(
        "HLO005", target,
        f"the slot dispatches captured {n} graphs ({list(graphs.entries)}), "
        f"more than 2 + the {allowed - 2} distinct advance lengths — a slot "
        f"dispatch's key holds more than its shape")]
