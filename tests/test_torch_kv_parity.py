"""What the cluster's admission and preemption ride on, held to the JAX
package: the port's ``PagedKVAllocator`` driven op by op beside the
reference's (the random operations of the two-tier invariant test and the
share/write/unshare sequence), compared after every step; the port's
``ModelBackend`` under memory preemption; and the inherited prefix-cache
divergence, pinned: with the cache on, and with it off, the port commits
the reference's tokens."""

import jax
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.serving as jserving
from repro.models import build_model as jax_build
from repro.models.common import ArchConfig as JaxArchConfig
from repro.serving.kv_pool import OutOfPages as JOutOfPages
from repro.serving.kv_pool import PagedKVAllocator as JAllocator
import repro_torch.core as tcore
import repro_torch.serving as tserving
from repro_torch.models import ArchConfig, build_model, params_from_jax
from repro_torch.serving.kv_pool import OutOfPages as TOutOfPages
from repro_torch.serving.kv_pool import PagedKVAllocator as TAllocator

from test_kv_pool import _check_two_tier

SIDES = {"jax": (jcore, jserving), "torch": (tcore, tserving)}
CFG = dict(name="t", family="dense", n_layers=2, d_model=64, n_heads=4,
           n_kv_heads=2, d_ff=128, vocab_size=256, block_size=8,
           confidence_threshold=0.6)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The SMOKE models' ops are tiny, and the test workers already load
    every core: one intra-op thread, restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the allocators, op by op
# ---------------------------------------------------------------------------

def _trie(kv):
    out, stack = [], list(kv._prefix_root.children.values())
    while stack:
        nd = stack.pop()
        stack.extend(nd.children.values())
        out.append((tuple(int(t) for t in nd.tokens), nd.depth, nd.base,
                    nd.tier, nd.page, nd.host_slot))
    return sorted(out, key=repr)


def _snapshot(kv) -> dict:
    """Every piece of allocator state an admission decision can read."""
    return {
        "free": [list(f) for f in kv._free],
        "cached": [list(c) for c in kv._cached],
        "tables": {r: list(t) for r, t in kv._tables.items()},
        "lens": dict(kv._lens), "stripe": dict(kv._stripe),
        "refs": dict(kv._refs),
        "spilled": {r: (list(sp.slots), sp.n_tokens, sp.offset)
                    for r, sp in kv._spilled.items()},
        "host_free": None if kv.host is None else list(kv.host._free),
        "trie": _trie(kv), "gauges": kv.gauges(), "stats": dict(kv.stats),
    }


def _match(m):
    if m is None:
        return None
    return (m.covered, m.offset, m.page_size, m.partial,
            [(nd.tier, nd.page, nd.host_slot) for nd in m.nodes])


class _Sides(tuple):
    """An argument that differs by side: (reference's, port's)."""


class _Pair:
    """One operation on both allocators; the results (or the OutOfPages
    each raised) must agree, and so must the state after it.  Returns
    whether it succeeded, and each side's raw result as a ``_Sides``."""

    def __init__(self, *a, **k):
        self.j, self.t = JAllocator(*a, **k), TAllocator(*a, **k)

    def __call__(self, name, *a, conv=lambda x: x):
        seen, raw = [], []
        for i, (kv, oop) in enumerate(((self.j, JOutOfPages),
                                       (self.t, TOutOfPages))):
            args = [x[i] if isinstance(x, _Sides) else x for x in a]
            try:
                r = getattr(kv, name)(*args)
                seen.append(("ok", conv(r)))
            except oop as e:
                r = None
                seen.append(("OutOfPages", str(e)))
            raw.append(r)
        assert seen[1] == seen[0], name
        assert _snapshot(self.t) == _snapshot(self.j), name
        _check_two_tier(self.t)
        return seen[1][0] == "ok", _Sides(raw)


# tests/test_kv_pool.py's token streams: shared heads provoke trie sharing
STREAMS = [list(rng.integers(1, 50, 64))
           for rng in (np.random.default_rng(s) for s in range(3))]
STREAMS.append(STREAMS[0][:16] + STREAMS[1][:48])   # diverging branch


@pytest.mark.parametrize("shards,host", [(1, 0), (1, 8), (2, 0), (2, 8)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_two_tier_op_machine_matches_reference(shards, host, seed):
    """The operations of tests/test_kv_pool.py's
    ``test_two_tier_invariants_random_ops`` (allocate with prefix attach and
    registration, extend, trim, free, COW, spill, swap-in or discard), 60 of
    them drawn from a seed."""
    rng = np.random.default_rng(1000 * seed + 10 * shards + host)
    kv = _Pair(16, page_size=4, kv_shards=shards)
    if host:
        kv("attach_host", host, conv=lambda h: h is not None)
    nxt, live, spilled = 0, {}, []
    for _ in range(60):
        op, stream = int(rng.integers(0, 7)), int(rng.integers(0, 4))
        n_tok, pick = int(rng.integers(1, 41)), int(rng.integers(0, 10))
        flag = bool(rng.integers(0, 2))
        toks = STREAMS[stream][:max(n_tok, 1)]
        if op == 0:                                      # allocate (+reg)
            _, m = kv("lookup_prefix", toks, len(toks), conv=_match)
            if m[1] is not None and flag:
                _, fits = kv("can_admit_prefix", len(toks), m)
                if not fits[1]:
                    continue
                ok, _ = kv("allocate_prefix", nxt, len(toks), m)
            else:
                ok, _ = kv("allocate", nxt, len(toks))
            if ok:
                live[nxt] = toks
                kv("register_prefix", nxt, toks)
            nxt += 1
        elif op == 1 and live:                           # extend
            rid = list(live)[pick % len(live)]
            kv("extend", rid, kv.t.length(rid) + n_tok)
        elif op == 2 and live:                           # trim
            rid = list(live)[pick % len(live)]
            kv("trim", rid, max(kv.t.length(rid) - n_tok, 1))
        elif op == 3 and live:                           # free
            rid = list(live)[pick % len(live)]
            kv("free", rid)
            del live[rid]
        elif op == 4 and live:                           # COW
            rid = list(live)[pick % len(live)]
            kv("ensure_private", rid, 0, n_tok)
        elif op == 5 and live and host:                  # spill
            rid = list(live)[pick % len(live)]
            _, sp = kv("spill_request", rid, conv=lambda s: s is not None)
            if sp[1] is not None:
                spilled.append(rid)
                del live[rid]
        elif op == 6 and spilled:                        # swap in/discard
            rid = spilled.pop(pick % len(spilled))
            _, can = kv("can_swap_in", rid)
            if flag and can[1]:
                kv("swap_in_request", rid)
                live[rid] = None
            else:
                kv("discard_spilled", rid)
    for rid in list(live):
        kv("free", rid)
    for rid in spilled:
        kv("discard_spilled", rid)
    assert kv.t.free_pages == kv.t.n_pages


@pytest.mark.parametrize("shards,n_tok,joiners,seed",
                         [(1, 4, 1, 0), (1, 13, 3, 1), (2, 16, 2, 2),
                          (2, 31, 3, 5)])
def test_share_write_unshare_matches_reference(shards, n_tok, joiners, seed):
    """tests/test_kv_pool.py's share/write/unshare sequence: one registered
    prompt, joiners attaching its chain, each diverging (COW), then every
    holder freed."""
    kv = _Pair(32, page_size=4, kv_shards=shards)
    toks = list(np.random.default_rng(seed).integers(1, 99, n_tok))
    kv("allocate", 0, n_tok)
    kv("register_prefix", 0, toks)
    for i in range(1, joiners + 1):
        _, m = kv("lookup_prefix", toks, n_tok, conv=_match)
        assert m[1] is not None
        kv("allocate_prefix", i, n_tok, m)
    for i in range(1, joiners + 1):
        kv("ensure_private", i, 0, n_tok)
    for i in range(joiners, -1, -1):
        kv("free", i)
    assert kv.t.free_pages == kv.t.n_pages


# ---------------------------------------------------------------------------
# the model backend under memory preemption, and the prefix cache
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def weights():
    def bridged(diffusion):
        cfg = {**CFG, "diffusion": diffusion}
        jm = jax_build(JaxArchConfig(**cfg))
        jparams = jm.init(jax.random.PRNGKey(0))
        tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                                  device="cpu")
        return jm, jparams, build_model(ArchConfig(**cfg)), tparams
    return {True: bridged(True), False: bridged(False)}


def _backend(side, w, **kw):
    jm, jparams, tm, tparams = w
    _, serving = SIDES[side]
    if side == "jax":                 # the reference's jnp oracle
        return serving.ModelBackend(jm, jparams, attn_impl="ref", **kw)
    return serving.ModelBackend(tm, tparams, device="cpu", **kw)


def _preemption_requests(serving):
    """tests/test_preemption.py's: 1-page prompts that grow to 4 pages."""
    rng = np.random.default_rng(2)
    rs = list(serving.PoissonWorkload(serving.DATASETS["sharegpt"], 50.0, 6,
                                      seed=2))
    for r in rs:
        r.arrival_time = 0.0
        r.prompt_len, r.max_new_tokens = 16, 48
        r.prompt_tokens = rng.integers(4, CFG["vocab_size"], 16).tolist()
    return rs


def _serve_preempted(side, w, pages):
    core, serving = SIDES[side]
    be = _backend(side, w, max_len=64, kv_pages=pages, page_size=16)
    outs = {}
    release = be.release

    def spy(rid):
        outs[rid] = list(be.state(rid).output_tokens)
        release(rid)

    be.release = spy
    rep = serving.ServingEngine(be, core.FixedScheduler(8),
                                max_batch=8).run(_preemption_requests(serving))
    assert be.kv.free_pages == be.kv.n_pages       # no page leaks
    return rep, outs


def test_model_backend_preempted_outputs_identical(weights):
    """tests/test_preemption.py's test on the port: a tight pool forces
    mid-decode preemption, every victim re-prefills and commits the tokens
    of an unpressured run — and of the reference's pressured run."""
    w = weights[True]
    rep_roomy, out_roomy = _serve_preempted("torch", w, 64)
    rep_tight, out_tight = _serve_preempted("torch", w, 8)
    rep_ref, out_ref = _serve_preempted("jax", w, 8)
    assert rep_roomy.preemptions == 0
    assert rep_tight.preemptions > 0
    assert len(rep_tight.metrics) == 6
    assert all(m.n_tokens == 48 for m in rep_tight.metrics)
    assert out_tight == out_roomy == out_ref
    assert rep_tight.preemptions == rep_ref.preemptions
    assert [m.preemptions for m in rep_tight.metrics] == \
        [m.preemptions for m in rep_ref.metrics]
    preempted = [m for m in rep_tight.metrics if m.preemptions > 0]
    assert preempted and all(m.computed_tokens > m.n_tokens
                             for m in preempted)


def _shared_requests(serving, n, prompt, out, prefix, seed):
    """tests/test_kv_reuse.py's trace: every prompt shares a head."""
    rng = np.random.default_rng(seed)
    head = rng.integers(5, 250, prefix).tolist()
    reqs = list(serving.PoissonWorkload(serving.DATASETS["sharegpt"], 60.0,
                                        n, seed=seed))
    for r in reqs:
        r.prompt_len, r.max_new_tokens = prompt, out
        r.prompt_tokens = head + rng.integers(5, 250,
                                              prompt - prefix).tolist()
    return reqs


def _drive(be, reqs, chunk):
    """tests/test_kv_reuse.py's ``_drive_model``: the first request alone
    until its prefill registered the prompt, then the sharers."""
    be.admit(reqs[0])
    rids = [reqs[0].rid]
    for _ in range(64):
        be.decode_step(rids, chunk)
        if not be._prefill.pending(reqs[0].rid):
            break
    for r in reqs[1:]:
        be.admit(r)
        rids.append(r.rid)
    for _ in range(400):
        if all(be.state(r).done for r in rids) and not be._prefill.queue:
            break
        be.decode_step(rids, chunk)
    return {r: list(be.state(r).output_tokens) for r in rids}


@pytest.mark.parametrize("variant", ["slide", "obs", "ar"])
def test_prefix_cache_commits_reference_tokens(weights, variant):
    """The inherited divergence (tests/test_kv_reuse.py's
    ``test_model_tokens_identical_cache_on_off`` fails in the reference for
    slide and obs): the port commits the reference's tokens with the cache
    on and with it off, and so differs between the two exactly where the
    reference does."""
    w = weights[variant != "ar"]
    chunk = 1 if variant == "ar" else 8
    got = {}
    for side in ("jax", "torch"):
        _, serving = SIDES[side]
        for cache in (True, False):
            be = _backend(side, w, n_slots=8, max_len=96,
                          decode_mode="ar" if variant == "ar" else "elastic",
                          obs=variant == "obs", prefill_mode="chunked",
                          prefill_token_budget=16, prefix_cache=cache)
            reqs = _shared_requests(serving, 5, 40, 16, 32, 2)
            got[side, cache] = (_drive(be, reqs, chunk), be.prefix_hits)
    for cache in (True, False):
        assert got["torch", cache] == got["jax", cache], cache
    assert got["torch", True][1] > 0            # pages actually shared
    assert all(len(v) == 16 for v in got["torch", True][0].values())
