"""The port's serving path against the JAX package's: the same bridged
weights and the same requests through each package's ``ServingEngine`` and
paged ``ModelBackend`` must commit identical tokens per request, with the
same chunk/batch history and the same dispatch and host-byte counters —
in elastic, fixed-chunk and AR modes, and with wave prefill in slide, OBS
and AR; the moe (16 experts, the sorted path) and vlm (Qwen2-VL SMOKE)
families in elastic and wave modes.  The reference runs its jnp oracle (``attn_impl="ref"``; its
kernel-vs-oracle identity is pinned by its own tests; its wave prefill
runs the XLA flash path), the port its default path (the kernels' plain
versions on CPU).  The host-only half is held by an identical
``SimBackend`` report.
"""

import dataclasses
import hashlib

import jax
import numpy as np
import pytest

import repro.core as jcore
import repro.serving as jserving
from repro.core.latency_model import CPU_HOST as J_CPU_HOST
from repro.models import build_model as jax_build
from repro.models.common import ArchConfig as JaxArchConfig
import repro_torch.core as tcore
import repro_torch.serving as tserving
from repro_torch.configs import get_smoke_config
from repro_torch.core.latency_model import CPU_HOST as T_CPU_HOST
from repro_torch.models import ArchConfig, build_model, params_from_jax

CFG = dict(name="t", family="dense", n_layers=2, d_model=64, n_heads=4,
           n_kv_heads=2, d_ff=128, vocab_size=256, block_size=8,
           confidence_threshold=0.6)
# tests/test_prefill_interleave.py's AR config (causal prefill)
CFG_AR = {**CFG, "name": "tar", "diffusion": False}
# tests/test_torch_model.py's 16-expert config (the sorted MoE path)
CFG_MOE16 = {**CFG, "name": "moe16", "family": "moe", "d_ff": 64,
             "moe_d_ff": 48, "n_experts": 16, "top_k": 2}
FAMILY_CFGS = {
    "moe16": CFG_MOE16,
    "qwen2_vl_smoke": dataclasses.asdict(get_smoke_config("qwen2-vl-2b")),
}
SIDES = {
    "jax": (jcore, jserving, J_CPU_HOST),
    "torch": (tcore, tserving, T_CPU_HOST),
}


def _bridged(cfg):
    jm = jax_build(JaxArchConfig(**cfg))
    jparams = jm.init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    return jm, jparams, build_model(ArchConfig(**cfg)), tparams


@pytest.fixture(scope="module")
def weights():
    return _bridged(CFG)


@pytest.fixture(scope="module")
def ar_weights():
    return _bridged(CFG_AR)


def _requests(serving, n, seed=0):
    rng = np.random.default_rng(seed)
    reqs = list(serving.PoissonWorkload(serving.DATASETS["sharegpt"], 50.0,
                                        n, seed=seed))
    for r in reqs:
        r.prompt_len = int(rng.integers(6, 40))
        r.max_new_tokens = int(rng.integers(8, 20))
        r.prompt_tokens = rng.integers(4, CFG["vocab_size"],
                                       r.prompt_len).tolist()
    return reqs


def _scheduler(side, mode, cfg):
    core, serving, cpu_host = SIDES[side]
    if mode == "elastic":
        return core.ElasticScheduler.from_analytic(
            core.AnalyticDeviceModel(cfg, cpu_host),
            prior_tokens_per_step=serving.DATASETS["sharegpt"]
            .tokens_per_step_bd32, batches=(1, 2, 4, 8), ctx=128.0)
    return core.FixedScheduler(8 if mode == "fixed" else 1)


def _serve(side, weights, mode):
    jm, jparams, tm, tparams = weights
    _, serving, _ = SIDES[side]
    kw = dict(n_slots=8, max_len=64,
              decode_mode="ar" if mode == "ar" else "elastic")
    if mode == "fixed":
        kw["prefill_token_budget"] = 16      # several prefill chunks
    if side == "jax":
        be = serving.ModelBackend(jm, jparams, attn_impl="ref", **kw)
    else:
        be = serving.ModelBackend(tm, tparams, device="cpu", **kw)
    cfg = jm.cfg if side == "jax" else tm.cfg
    eng = serving.ServingEngine(be, _scheduler(side, mode, cfg), max_batch=4)
    outs = {}
    release = be.release

    def spy(rid):
        outs[rid] = be.state(rid).output_tokens
        release(rid)

    be.release = spy
    rep = eng.run(_requests(serving, 7, seed=3))
    counters = (be.decode_dispatches, be.prefill_dispatches,
                be.host_transfer_bytes, be.kv.free_pages, be.kv.n_pages)
    return rep, outs, counters


@pytest.mark.parametrize("mode", ["elastic", "fixed", "ar"])
def test_model_backend_commits_same_tokens(weights, mode):
    rep_j, out_j, cnt_j = _serve("jax", weights, mode)
    rep_t, out_t, cnt_t = _serve("torch", weights, mode)
    assert len(out_t) == len(out_j) == 7
    assert out_t == out_j
    assert rep_t.chunk_history == rep_j.chunk_history
    assert rep_t.batch_history == rep_j.batch_history
    assert (rep_t.total_tokens, rep_t.computed_tokens) == \
        (rep_j.total_tokens, rep_j.computed_tokens)
    assert cnt_t == cnt_j
    assert cnt_t[3] == cnt_t[4]                 # pool fully drained


@pytest.mark.parametrize("mode", ["elastic", "wave"])
@pytest.mark.parametrize("which", sorted(FAMILY_CFGS))
def test_model_backend_families_commit_same_tokens(which, mode):
    """The moe and vlm families through both engines: identical committed
    tokens per request and the same counters, with chunked prefill under
    the elastic scheduler, and with wave prefill under a fixed chunk."""
    w = _bridged(FAMILY_CFGS[which])
    if mode == "elastic":
        (rep_j, out_j, cnt_j), (rep_t, out_t, cnt_t) = (
            _serve(side, w, "elastic") for side in ("jax", "torch"))
        assert rep_t.chunk_history == rep_j.chunk_history
        n = 7
    else:
        (rep_j, out_j, be_j, _), (rep_t, out_t, be_t, shapes) = (
            _serve_fixed(side, w, "slide", "wave") for side in ("jax",
                                                                "torch"))
        cnt_j, cnt_t = ((be.decode_dispatches, be.prefill_dispatches,
                         be.host_transfer_bytes, be.kv.free_pages,
                         be.kv.n_pages) for be in (be_j, be_t))
        assert len(shapes["prefill_paged"]) == be_t.prefill_dispatches >= 1
        n = 6
    assert len(out_t) == len(out_j) == n
    assert out_t == out_j
    assert cnt_t == cnt_j
    assert cnt_t[3] == cnt_t[4]                 # pool fully drained


def _wave_requests(serving, n=6, prompt=40, out=16, seed=3):
    """tests/test_prefill_interleave.py's requests: all arrive at t = 0."""
    rng = np.random.default_rng(seed)
    reqs = list(serving.PoissonWorkload(serving.DATASETS["sharegpt"], 50.0,
                                        n, seed=seed))
    for r in reqs:
        r.prompt_len = prompt
        r.max_new_tokens = out
        r.prompt_tokens = rng.integers(4, CFG["vocab_size"], prompt).tolist()
        r.arrival_time = 0.0
    return reqs


def _serve_fixed(side, weights, variant, prefill_mode):
    """One fixed-chunk run (8 for diffusion, 1 for AR) with the given
    prefill mode.  Returns (report, tokens per rid, backend, the port's
    dispatch shapes by kind)."""
    jm, jparams, tm, tparams = weights
    core, serving, _ = SIDES[side]
    kw = dict(n_slots=8, max_len=64, prefill_mode=prefill_mode,
              prefill_token_budget=16, obs=variant == "obs",
              decode_mode="ar" if variant == "ar" else "elastic")
    shapes = {"prefill_paged": [], "prefill_chunk_paged": [],
              "decode_step_paged": []}
    if side == "jax":
        be = serving.ModelBackend(jm, jparams, attn_impl="ref", **kw)
    else:
        be = serving.ModelBackend(tm, tparams, device="cpu", **kw)
        for name in shapes:
            fn = getattr(tm, name)

            def rec(params, cache, tokens, *a, _n=name, _f=fn, **k):
                shapes[_n].append(tuple(tokens.shape))
                return _f(params, cache, tokens, *a, **k)
            setattr(be.model, name, rec)
    eng = serving.ServingEngine(
        be, core.FixedScheduler(1 if variant == "ar" else 8), max_batch=8)
    outs = {}
    release = be.release

    def spy(rid):
        outs[rid] = be.state(rid).output_tokens
        release(rid)

    be.release = spy
    try:
        rep = eng.run(_wave_requests(serving))
    finally:
        if side == "torch":
            for name in shapes:
                delattr(be.model, name)
    return rep, outs, be, shapes


@pytest.mark.parametrize("variant", ["slide", "obs", "ar"])
def test_model_backend_wave_matches_reference(weights, ar_weights, variant):
    """Wave prefill: identical committed tokens, prefill history and
    counters; one ``[Bp, Tp]`` prefill dispatch brings back ``8·Bp`` host
    bytes, each decode dispatch ``8·Bp·c``; no page leaks."""
    w = ar_weights if variant == "ar" else weights
    rep_j, out_j, be_j, _ = _serve_fixed("jax", w, variant, "wave")
    rep_t, out_t, be_t, shapes = _serve_fixed("torch", w, variant, "wave")
    assert len(out_t) == len(out_j) == 6
    assert out_t == out_j
    assert {m.rid: m.n_tokens for m in rep_t.metrics} == \
        {m.rid: m.n_tokens for m in rep_j.metrics}
    assert be_t.prefill_tokens_history == be_j.prefill_tokens_history
    assert be_t.prefill_tokens_history[0] == 6 * 40   # the whole wave
    assert rep_t.chunk_history == rep_j.chunk_history
    cnt = lambda be: (be.decode_dispatches, be.prefill_dispatches,
                      be.host_transfer_bytes, be.prefix_misses,
                      be.kv.free_pages, be.kv.n_pages)
    assert cnt(be_t) == cnt(be_j)
    assert not shapes["prefill_chunk_paged"]
    assert len(shapes["prefill_paged"]) == be_t.prefill_dispatches >= 1
    assert shapes["prefill_paged"][0] == (8, 64)      # pow-2 Bp and Tp
    assert be_t.host_transfer_bytes == \
        sum(8 * b for b, _ in shapes["prefill_paged"]) + \
        sum(8 * b * c for b, c in shapes["decode_step_paged"])
    assert be_t.kv.free_pages == be_t.kv.n_pages


@pytest.mark.parametrize("variant", ["slide", "obs", "ar"])
def test_model_backend_wave_matches_own_chunked(weights, ar_weights,
                                                variant):
    """The port's two prefill modes commit bit-identical tokens under a
    fixed chunk schedule (tests/test_prefill_interleave.py:72-94)."""
    w = ar_weights if variant == "ar" else weights
    rep_w, out_w, _, _ = _serve_fixed("torch", w, variant, "wave")
    rep_c, out_c, be_c, shapes = _serve_fixed("torch", w, variant,
                                              "chunked")
    assert len(rep_w.metrics) == len(rep_c.metrics) == 6
    assert out_c == out_w
    assert {m.rid: m.n_tokens for m in rep_c.metrics} == \
        {m.rid: m.n_tokens for m in rep_w.metrics}
    assert shapes["prefill_chunk_paged"] and not shapes["prefill_paged"]


def _report_hash(rep) -> str:
    h = hashlib.sha256()
    for m in sorted(rep.metrics, key=lambda m: m.rid):
        h.update(repr((m.rid, m.arrival_time, m.admit_time,
                       m.first_token_time, m.finish_time, m.n_tokens,
                       m.computed_tokens, m.decode_steps,
                       m.preemptions)).encode())
    h.update(repr((rep.chunk_history, rep.batch_history, rep.total_time,
                   rep.decode_time, rep.total_tokens, rep.computed_tokens,
                   rep.preemptions)).encode())
    return h.hexdigest()


@pytest.mark.parametrize("prefill_mode", ["wave", "chunked"])
def test_sim_backend_report_hash_equal(prefill_mode):
    hashes = []
    for side in ("jax", "torch"):
        core, serving, _ = SIDES[side]
        cfg = (JaxArchConfig if side == "jax" else ArchConfig)(
            **{**CFG, "name": "sdar-8b"})
        prof = serving.DATASETS["sharegpt"]
        be = serving.SimBackend(cfg, tokens_per_step=prof.tokens_per_step_bd32,
                                kv_pool_pages=512, seed=1,
                                prefill_mode=prefill_mode)
        sched = core.ElasticScheduler.from_analytic(
            be.analytic, prior_tokens_per_step=prof.tokens_per_step_bd32)
        eng = serving.ServingEngine(be, sched, max_batch=32)
        rep = eng.run(list(serving.PoissonWorkload(prof, 8.0, 30, seed=2)))
        assert len(rep.metrics) == 30
        hashes.append(_report_hash(rep))
    assert hashes[0] == hashes[1]


def _shared_requests(serving, n, prompt=40, out=12, prefix=32, seed=2):
    """All prompts share a ``prefix``-token head (prefix-cache hits)."""
    rng = np.random.default_rng(seed)
    head = rng.integers(5, 250, prefix).tolist()
    reqs = list(serving.PoissonWorkload(serving.DATASETS["sharegpt"], 60.0,
                                        n, seed=seed))
    for r in reqs:
        r.prompt_len = prompt
        r.max_new_tokens = out
        r.prompt_tokens = head + rng.integers(5, 250, prompt - prefix).tolist()
    return reqs


def _drive_reuse(be, reqs, chunk=8):
    """Warm the prefix trie with the first request, admit the sharers
    (copy-on-write on the shared pages), then spill one request to the host
    tier mid-decode and swap it back in."""
    be.admit(reqs[0])
    rids = [reqs[0].rid]
    while be._prefill.pending(reqs[0].rid):
        be.decode_step(rids, chunk)
    for r in reqs[1:]:
        be.admit(r)
        rids.append(r.rid)
    for _ in range(3):
        be.decode_step(rids, chunk)
    victim = reqs[1]
    assert be.spill(victim.rid, force=True)
    rids.remove(victim.rid)
    be.decode_step(rids, chunk)
    be.admit(victim)                       # swap-in from the host tier
    rids.append(victim.rid)
    for _ in range(200):
        if all(be.state(r).done for r in rids) and not be._prefill.queue:
            break
        be.decode_step(rids, chunk)
    return {r: be.state(r).output_tokens for r in rids}


@pytest.mark.parametrize("mode", ["elastic", "ar"])
def test_prefix_cache_cow_and_host_tier_match_reference(weights, mode):
    """Prefix hits, COW page copies (AR re-prefills the last prompt token of
    a fully cached prompt into a shared page) and a spill/swap-in round trip
    on the port's in-place pool commit the reference's tokens with the same
    counters, and the pool never moves."""
    jm, jparams, tm, tparams = weights
    kw = dict(max_len=64, prefill_token_budget=16, host_kv_pages=64,
              decode_mode=mode)
    prompt = 40 if mode == "elastic" else 32
    outs, stats = [], []
    for side in ("jax", "torch"):
        serving = SIDES[side][1]
        if side == "jax":
            be = serving.ModelBackend(jm, jparams, attn_impl="ref", **kw)
        else:
            be = serving.ModelBackend(tm, tparams, device="cpu", **kw)
            ptr = be.kv.k_pages.data_ptr(), be.kv.v_pages.data_ptr()
        reqs = _shared_requests(serving, 4, prompt=prompt)
        outs.append(_drive_reuse(be, reqs, chunk=8 if mode == "elastic"
                                 else 1))
        stats.append((be.prefix_hits, be.kv.stats["cow_copies"],
                      be.kv.stats["swap_in_pages"],
                      be.kv.stats["swap_out_pages"]))
    assert outs[1] == outs[0]
    assert stats[1] == stats[0]
    hits, cow, swap_in, _ = stats[1]
    assert hits > 0 and swap_in > 0 and (cow > 0 or mode == "elastic")
    assert (be.kv.k_pages.data_ptr(), be.kv.v_pages.data_ptr()) == ptr
