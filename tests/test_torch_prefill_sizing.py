"""Chunked prefill sized for the device served on (``ModelBackend``).

A CPU backend keeps the reference's ``CPU_HOST`` sizing: its plans and its
served tokens are the JAX package's, tick by tick.  On a known card the
budget is the prefill dispatch's own saturation point (448 tokens for
SDAR-8B on the H100), the plan's padded shape is bounded by
``bucket(budget)`` rows, and every shape of at most ``SETUP_PREFILL_ROWS``
rows the bounded planner can produce is captured at construction, counting
in no serving counter.  The card's
rule is exercised here by handing a CPU backend the H100's roofline
(``_card_spec`` patched) and the CPU stand-in capturer.
"""

import dataclasses
import logging

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro_torch.core as tcore
import repro_torch.serving as tserving
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.latency_model import (A100_80G, CPU_HOST, H100_SXM,
                                            AnalyticDeviceModel)
from repro_torch.distributed import collectives
from repro_torch.kernels import chunked_paged_attn as cpa
from repro_torch.models import ArchConfig, build_model
from repro_torch.serving import backends
from repro_torch.serving.backends import PrefillScheduler, own_prefill_budget
from repro_torch.serving.graphs import DispatchGraphs, RerunCapturer
from repro_torch.serving.request import Request

# block 32 on 16-token pages: one aligned chunk is 32 tokens, as SDAR-8B's
CFG = dict(name="t32", family="dense", n_layers=2, d_model=64, n_heads=4,
           n_kv_heads=2, d_ff=128, vocab_size=256, block_size=32,
           confidence_threshold=0.6)
SDAR = dataclasses.asdict(get_smoke_config("sdar-8b"))


def _requests(n, seed, vocab, lo=3, hi=120):
    """A seeded mixed-length trace: prompts of ``lo``–``hi`` tokens
    arriving over a few engine ticks."""
    rng = np.random.default_rng(seed)
    out = []
    for rid in range(n):
        p = int(rng.integers(lo, hi))
        out.append(Request(rid, float(rid // 3) * 1e-3, p,
                           int(rng.integers(6, 18)),
                           prompt_tokens=rng.integers(4, vocab,
                                                      p).tolist()))
    return out


def _serve(be, scheduler, reqs, max_batch=4):
    """Serve ``reqs``; returns (tokens by rid, the plan of every tick)."""
    outs, plans = {}, []
    release, step = be.release, be.decode_step

    def spy_release(rid):
        outs[rid] = list(be.state(rid).output_tokens)
        release(rid)

    def spy_step(rids, chunk):
        res = step(rids, chunk)
        plans.append(list(be.last_prefill_plan))
        return res

    be.release, be.decode_step = spy_release, spy_step
    serving = scheduler[0]
    rep = serving.ServingEngine(be, scheduler[1], max_batch=max_batch).run(
        reqs)
    return outs, plans, rep


# ---------------------------------------------------------------------------
# the CPU keeps the reference's sizing
# ---------------------------------------------------------------------------

def test_cpu_backend_plans_as_the_reference():
    """On the CPU the budget is one aligned chunk (32) whatever the decode
    batch, no padded-shape bound is set, and under the elastic scheduler
    every tick's plan, the chunk history and every served token equal the
    JAX package's on the same weights and requests."""
    import jax

    import repro.core as jcore
    import repro.serving as jserving
    from repro.core.latency_model import CPU_HOST as J_CPU_HOST
    from repro.models import build_model as jax_build
    from repro.models.common import ArchConfig as JaxArchConfig
    from repro_torch.models import params_from_jax

    jm = jax_build(JaxArchConfig(**CFG))
    jparams = jm.init(jax.random.PRNGKey(0))
    tm = build_model(ArchConfig(**CFG))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    kw = dict(n_slots=8, max_len=192)
    be_t = tserving.ModelBackend(tm, tparams, device="cpu", **kw)
    assert be_t._prefill.max_rows is None
    assert [be_t._prefill.tick_budget(bc) for bc in (0, 8, 64, 512)] == \
        [32] * 4
    be_j = jserving.ModelBackend(jm, jparams, attn_impl="ref", **kw)
    got = {}
    for side, be, core, serving, host, cfg in (
            ("jax", be_j, jcore, jserving, J_CPU_HOST, jm.cfg),
            ("torch", be_t, tcore, tserving, CPU_HOST, tm.cfg)):
        sched = core.ElasticScheduler.from_analytic(
            core.AnalyticDeviceModel(cfg, host), prior_tokens_per_step=3.0,
            batches=(1, 2, 4, 8), ctx=128.0)
        got[side] = _serve(be, (serving, sched),
                           _requests(12, seed=11, vocab=CFG["vocab_size"],
                                     hi=60))
    (out_j, plans_j, rep_j), (out_t, plans_t, rep_t) = got["jax"], \
        got["torch"]
    assert len(out_t) == 12 and out_t == out_j
    assert plans_t == plans_j
    assert any(len(p) > 1 for p in plans_t)         # co-batched chunks
    assert max(sum(n for _, _, n in p) for p in plans_t) == 32
    assert rep_t.chunk_history == rep_j.chunk_history
    assert be_t.prefill_padded_tokens >= sum(
        sum(n for _, _, n in p) for p in plans_t)


# ---------------------------------------------------------------------------
# the card's sizing rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch, spec, want", [
    ("sdar-8b", H100_SXM, 448),             # saturation 475.6 tokens
    ("sdar-8b", A100_80G, 192),             # 199.7
    ("sdar-8b", CPU_HOST, 32),              # 3.48: one aligned chunk
    ("smollm-135m", H100_SXM, 8192),        # never saturates: the clamp
    ("llama4-scout-17b-a16e", H100_SXM, 4352),   # MoE: total ≫ active
    ("kimi-k2-1t-a32b", H100_SXM, 8192),    # 11,533.6: the clamp
])
def test_own_budget_from_the_roofline(arch, spec, want):
    cfg = get_config(arch)
    am = AnalyticDeviceModel(cfg, spec)
    assert own_prefill_budget(am, 32) == want
    assert want % 32 == 0 and 32 <= want <= 8192
    assert want <= max(am.saturation_ew(), 32)


@pytest.mark.parametrize("name, want", [
    ("NVIDIA H100 80GB HBM3", H100_SXM), ("NVIDIA A100-SXM4-80GB", A100_80G),
    ("NVIDIA H100 PCIe", None), ("NVIDIA H100 NVL", None),
    ("NVIDIA A100-SXM4-40GB", None)])
def test_card_spec_by_name(monkeypatch, name, want):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: name)
    assert backends._card_spec(torch.device("cuda", 0)) is want
    assert backends._card_spec(torch.device("cpu")) is None


def test_unknown_card_keeps_cpu_sizing_and_logs_once(monkeypatch, caplog):
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "Some Card X1")
    monkeypatch.setattr(backends, "_UNKNOWN_CARDS", set())
    with caplog.at_level(logging.WARNING, logger=backends.__name__):
        for _ in range(3):
            assert backends._card_spec(torch.device("cuda", 0)) is None
    lines = [r for r in caplog.records if "Some Card X1" in r.getMessage()]
    assert len(lines) == 1


# ---------------------------------------------------------------------------
# the bounded planner
# ---------------------------------------------------------------------------

@settings(max_examples=150, deadline=None)
@given(st.sampled_from([16, 32, 48]), st.integers(1, 20),
       st.lists(st.tuples(st.integers(1, 900), st.integers(0, 899)),
                min_size=1, max_size=24), st.booleans())
def test_bounded_plans_keep_every_invariant(align, chunks, prompts, bound):
    """Over random queues (prompt lengths, cursors already past a prefix),
    drained tick by tick: Σ ≤ budget; with the bound, padded rows ≤
    bucket(budget) and every shape among ``shapes()``; FCFS (the plan is a
    prefix of the queue, in order); chunk ends aligned except final
    chunks; the queue head advances every tick."""
    budget = align * chunks
    p = PrefillScheduler(budget, align,
                         max_rows=backends._pow2(budget) if bound else None)
    for rid, (n, start) in enumerate(prompts):
        p.add(Request(rid, 0.0, n, 1), start=(start // align) * align
              if start < n else 0)
    max_len = max(n for n, _ in prompts)
    shapes = set(p.shapes(max_len)) if bound else None
    for _ in range(10_000):
        if not p.queue:
            break
        queue = [r.rid for r in p.queue]
        head_at = p.cursor[queue[0]]
        plan = p.plan()
        assert plan and plan[0][0].rid == queue[0] and plan[0][1] == head_at
        assert [r.rid for r, _, _ in plan] == queue[:len(plan)]
        assert sum(n for _, _, n in plan) <= budget
        for req, off, n in plan:
            assert n > 0 and off == p.cursor[req.rid]
            assert (off + n) % align == 0 or off + n == req.prompt_len
        if bound:
            bp, tp = p.padded(len(plan), max(n for _, _, n in plan))
            assert bp * tp <= backends._pow2(budget)
            assert (bp, tp) in shapes
        for req, _, n in plan:
            p.advance(req.rid, n)
    assert not p.queue


# ---------------------------------------------------------------------------
# served tokens, and the set-up captures
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke():
    torch.manual_seed(0)
    model = build_model(ArchConfig(**SDAR))
    return model, model.init_params(torch.Generator().manual_seed(1),
                                    device="cpu")


def _fixed_run(smoke, reqs, **kw):
    model, params = smoke
    be = tserving.ModelBackend(model, params, n_slots=8, max_len=160,
                               device="cpu", **kw)
    out, plans, _ = _serve(be, (tserving, tcore.FixedScheduler(8)), reqs,
                           max_batch=6)
    return be, out, plans


def test_budget_448_serves_the_tokens_of_budget_32(smoke):
    """fp32 SMOKE under a fixed chunk: an explicit budget of 448 takes
    each prompt in one or two dispatches, and commits exactly the tokens
    that a budget of 32 commits."""
    reqs = lambda: _requests(10, seed=5, vocab=SDAR["vocab_size"])  # noqa
    be32, out32, plans32 = _fixed_run(smoke, reqs(),
                                      prefill_token_budget=32)
    be448, out448, plans448 = _fixed_run(smoke, reqs(),
                                         prefill_token_budget=448)
    assert len(out448) == 10 and out448 == out32
    assert be448.prefill_dispatches < be32.prefill_dispatches
    assert max(sum(n for _, _, n in p) for p in plans448) > 32


def test_setup_captures_every_shape_and_count_nothing(smoke, monkeypatch):
    """A backend sized for the H100 (the SMOKE model never saturates it:
    budget 8192, shapes up to the 160-token ``max_len``) captures every
    prefill shape of at most ``SETUP_PREFILL_ROWS`` rows at construction:
    nothing is written to the pool, no serving counter moves, and serving
    a random trace adds prefill keys of more rows only; its tokens are the
    CPU-sized eager backend's."""
    model, params = smoke
    monkeypatch.setattr(backends, "_card_spec", lambda d: H100_SXM)
    be = tserving.ModelBackend(model, params, n_slots=8, max_len=160,
                               device="cpu", graphs=RerunCapturer())
    p = be._prefill
    rows = backends.SETUP_PREFILL_ROWS
    assert (p.budget, p.max_rows, p.padded(3, 5)) == (8192, 8192, (4, 16))
    keys = {k for k in be.graphs.entries if k[0] == "chunk"}
    assert {k[1] for k in keys} == set(p.shapes(160, rows))
    assert set(p.shapes(160, rows)) == {
        s for s in p.shapes(160) if s[0] * s[1] <= rows}
    assert max(tp for _, tp in p.shapes(160)) == 256
    assert be.kv.k_pages.abs().sum() == 0 == be.kv.v_pages.abs().sum()
    assert (be.decode_dispatches, be.prefill_dispatches,
            be.host_transfer_bytes, be.device_dispatches,
            be.collective_bytes, be.prefill_padded_tokens,
            be.graphs.replays) == (0,) * 7
    assert be.prefill_tokens_history == []
    assert be.telemetry_counters()["prefill_tick_tokens"] == 0
    reqs = lambda: _requests(12, seed=9, vocab=SDAR["vocab_size"])  # noqa
    out, plans, _ = _serve(be, (tserving, tcore.FixedScheduler(8)), reqs(),
                           max_batch=6)
    assert {k for k in be.graphs.entries if k[0] == "chunk"} == keys
    assert be.graphs.replays > 0
    assert max(sum(n for _, _, n in p) for p in plans) > 32
    monkeypatch.undo()
    _, want, _ = _fixed_run(smoke, reqs())
    assert len(out) == 12 and out == want
    # six prompts of 100-119 tokens at once: one [8, 128] plan, 1,024
    # rows, captured on its first use
    big = _requests(6, seed=3, vocab=SDAR["vocab_size"], lo=100)
    for r in big:
        r.rid += 100
        be.admit(r)
    be._prefill_tick()
    later = {k for k in be.graphs.entries if k[0] == "chunk"} - keys
    assert [k[1] for k in later] == [(8, 128)] and (8, 128) in p.shapes(160)


def test_prepare_takes_the_warm_runs_counts_back_out():
    """``DispatchGraphs.prepare`` captures a key before its first call;
    the wrappers' counters and the collective record read as before, and
    the key's first call replays, counting its launches then."""

    def bump(t):
        cpa.LAUNCHES += 2
        collectives.record_collective("all-reduce", 100)
        return (t["x"] * 2,)

    g = DispatchGraphs("cpu", lambda: (), capturer=RerunCapturer())
    before = (cpa.LAUNCHES, collectives.record_snapshot())
    g.prepare(("k", (3,)), bump, {"x": np.zeros(3, np.float32)})
    assert (cpa.LAUNCHES, collectives.record_snapshot()) == before
    assert list(g.entries) == [("k", (3,))] and g.replays == 0
    g.prepare(("k", (3,)), bump, {"x": np.zeros(3, np.float32)})
    assert len(g.entries) == 1
    (out,) = g.dispatch(("k", (3,)), bump, {"x": np.ones(3, np.float32)})
    assert out.tolist() == [2.0] * 3 and g.replays == 1
    assert cpa.LAUNCHES >= before[0] + 2
