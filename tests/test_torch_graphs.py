"""The captured paged dispatches (``repro_torch.serving.graphs``).

On the CPU the cache runs with its stand-in capturer (``RerunCapturer``:
nothing captured, a replay re-runs the dispatch on the static inputs), so
everything but the CUDA graph itself is held here: one entry per key, the
static inputs reused and wholly rewritten every call, the trace-time
counters counting replays, a failed capture or a moved pool raising, and
SDAR-8B SMOKE in fp32 committing the JAX package's tokens through the
cache in elastic, AR and wave modes and at two shards.  The ``cuda``
cases hold the captured dispatches against the eager ones, bit for bit,
on the card.  The JAX package is imported by the cases that use it only,
so the ``cuda`` cases run where it is not installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_graphs.py
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

import repro_torch.core as tcore
import repro_torch.serving as tserving
from repro_torch.analysis import check, inventory, rules
from repro_torch.configs import get_smoke_config
from repro_torch.core.latency_model import CPU_HOST as T_CPU_HOST
from repro_torch.distributed import collectives
from repro_torch.kernels import block_diffusion_attn as bda
from repro_torch.kernels import chunked_paged_attn as cpa
from repro_torch.launch.mesh import make_kv_mesh
from repro_torch.models import ArchConfig, build_model, moe, params_from_jax
from repro_torch.serving.graphs import DispatchGraphs, RerunCapturer

SDAR = dataclasses.asdict(get_smoke_config("sdar-8b"))


# ---------------------------------------------------------------------------
# the cache alone
# ---------------------------------------------------------------------------

class TraceCapturer(RerunCapturer):
    """Runs the dispatch's Python once at capture, as the card's capture
    does (the trace-time counters move), and replays without it."""

    def capture(self, fn, like):
        out = fn()
        return (lambda: None), out


def _bump(t):
    cpa.LAUNCHES += 2
    cpa.MERGE_LAUNCHES += 1
    bda.LAUNCHES += 1
    moe.GROUPED_CALLS += 3
    collectives.record_collective("all-reduce", 100)
    return (t["x"] * 2, t["y"] + 1)


def _host(i):
    return {"x": np.arange(4, dtype=np.int64) + i,
            "y": np.full((2, 3), i, np.int32)}


def test_one_entry_per_key_static_buffers_reused():
    g = DispatchGraphs("cpu", lambda: (), capturer=RerunCapturer())
    first = g.dispatch("a", _bump, _host(0))
    e = g.entries["a"]
    ptrs = {k: t.data_ptr() for k, t in e.static.items()}
    for i in (1, 2):
        out = g.dispatch("a", _bump, _host(i))
        assert out is e.outputs
        assert {k: t.data_ptr() for k, t in e.static.items()} == ptrs
        assert out[0].tolist() == (np.arange(4) + i).__mul__(2).tolist()
        assert e.static["y"].dtype == torch.int32
    assert first[0].tolist() == [0, 2, 4, 6]
    g.dispatch("b", _bump, {"x": np.zeros(8, np.int64),
                            "y": np.zeros((1, 1), np.int32)})
    assert sorted(g.entries) == ["a", "b"] and g.replays == 2
    with pytest.raises(ValueError, match="shape"):
        g.dispatch("a", _bump, {"x": np.zeros(5, np.int64),
                                "y": np.zeros((2, 3), np.int32)})


def test_counters_count_replays_not_captures():
    """Captured with the counters' Python running once, replayed without
    it: every counter still grows by one call's worth a call."""
    keep = (cpa.LAUNCHES, cpa.MERGE_LAUNCHES, bda.LAUNCHES,
            moe.GROUPED_CALLS)
    rec0 = collectives.record_snapshot()
    try:
        cpa.LAUNCHES = cpa.MERGE_LAUNCHES = bda.LAUNCHES = 0
        moe.GROUPED_CALLS = 0
        g = DispatchGraphs("cpu", lambda: (), capturer=TraceCapturer())
        for i in range(5):
            g.dispatch("k", _bump, _host(i))
        assert (cpa.LAUNCHES, cpa.MERGE_LAUNCHES, bda.LAUNCHES,
                moe.GROUPED_CALLS) == (10, 5, 5, 15)
        rec = collectives.record_snapshot()["all-reduce"]
        assert (rec["bytes"] - rec0["all-reduce"]["bytes"],
                rec["count"] - rec0["all-reduce"]["count"]) == (500, 5)
    finally:
        (cpa.LAUNCHES, cpa.MERGE_LAUNCHES, bda.LAUNCHES,
         moe.GROUPED_CALLS) = keep


class FailingCapturer(RerunCapturer):
    def capture(self, fn, like):
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")


def test_failed_capture_raises_with_no_eager_fallback():
    g = DispatchGraphs("cpu", lambda: (), capturer=FailingCapturer())
    for i in range(2):
        with pytest.raises(RuntimeError, match="capturing"):
            g.dispatch("k", _bump, _host(i))
    assert not g.entries


def test_moved_pool_raises():
    where = [(1, 2)]
    g = DispatchGraphs("cpu", lambda: where[0], capturer=RerunCapturer())
    g.dispatch("k", _bump, _host(0))
    g.dispatch("k", _bump, _host(1))
    where[0] = (1, 3)
    with pytest.raises(RuntimeError, match="moved"):
        g.dispatch("k", _bump, _host(2))


# ---------------------------------------------------------------------------
# the backend through the cache, against the JAX package
# ---------------------------------------------------------------------------

def _jax():
    """The JAX package's modules these cases compare against."""
    return {name: importlib.import_module(name) for name in (
        "jax", "repro.core", "repro.serving", "repro.models",
        "repro.models.common", "repro.core.latency_model")}


@pytest.fixture(scope="module")
def weights():
    J = _jax()
    jax = J["jax"]
    jm = J["repro.models"].build_model(
        J["repro.models.common"].ArchConfig(**SDAR))
    jparams = jm.init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    return jm, jparams, build_model(ArchConfig(**SDAR)), tparams


def _requests(serving, n, seed=0):
    rng = np.random.default_rng(seed)
    reqs = list(serving.PoissonWorkload(serving.DATASETS["sharegpt"], 50.0,
                                        n, seed=seed))
    for r in reqs:
        r.prompt_len = int(rng.integers(6, 40))
        r.max_new_tokens = int(rng.integers(8, 20))
        r.prompt_tokens = rng.integers(4, SDAR["vocab_size"],
                                       r.prompt_len).tolist()
    return reqs


def _serve(side, w, mode, **kw):
    jm, jparams, tm, tparams = w
    if side == "jax":
        J = _jax()
        core, serving = J["repro.core"], J["repro.serving"]
        host = J["repro.core.latency_model"].CPU_HOST
    else:
        core, serving, host = tcore, tserving, T_CPU_HOST
    kw = dict(n_slots=8, max_len=64,
              decode_mode="ar" if mode == "ar" else "elastic",
              prefill_mode="wave" if mode == "wave" else "chunked", **kw)
    if side == "jax":
        be = serving.ModelBackend(jm, jparams, attn_impl="ref", **kw)
    else:
        be = serving.ModelBackend(tm, tparams, device="cpu", **kw)
    if mode == "ar":
        sched = core.FixedScheduler(1)
    else:
        sched = core.ElasticScheduler.from_analytic(
            core.AnalyticDeviceModel(be.cfg, host),
            prior_tokens_per_step=serving.DATASETS["sharegpt"]
            .tokens_per_step_bd32, batches=(1, 2, 4, 8), ctx=128.0)
    outs, release = {}, be.release

    def spy(rid):
        outs[rid] = list(be.state(rid).output_tokens)
        release(rid)

    be.release = spy
    serving.ServingEngine(be, sched, max_batch=4).run(
        _requests(serving, 6, seed=3))
    return outs, be


def _counters(be):
    return (be.decode_dispatches, be.prefill_dispatches,
            be.host_transfer_bytes, be.kv.free_pages)


@pytest.mark.parametrize("mode, S", [("elastic", 1), ("ar", 1), ("wave", 1),
                                     ("elastic", 2)])
def test_captured_backend_commits_reference_tokens(weights, mode, S):
    """SDAR-8B SMOKE in fp32 through the graph cache (the stand-in
    capturer) commits the JAX package's tokens — its unsharded run's at
    two shards too — with the reference's dispatch and host-byte counts,
    one graph a bucket, and every other call a replay.  At two shards the
    collective record and ``collective_bytes`` grow as the eager run's."""
    want, jbe = _serve("jax", weights, mode)
    kw = {} if S == 1 else {"kv_shards": S,
                            "kv_mesh": make_kv_mesh(S, devices=["cpu"] * S)}
    rec0 = collectives.record_snapshot()["all-reduce"]
    eager, ebe = _serve("torch", weights, mode, graphs=False, **kw)
    rec1 = collectives.record_snapshot()["all-reduce"]
    got, be = _serve("torch", weights, mode, graphs=RerunCapturer(), **kw)
    rec2 = collectives.record_snapshot()["all-reduce"]
    assert got == eager == want
    assert _counters(be) == _counters(ebe)
    if S == 1:
        assert _counters(be)[:3] == _counters(jbe)[:3]
    else:
        assert be.collective_bytes == ebe.collective_bytes > 0
        assert rec2["bytes"] - rec1["bytes"] == rec1["bytes"] - rec0["bytes"]
        assert rec2["count"] - rec1["count"] == rec1["count"] - rec0["count"]
    keys = list(be.graphs.entries)
    n = be.decode_dispatches + be.prefill_dispatches
    assert len(keys) == len(set(keys)) and 0 < len(keys) < n
    assert be.graphs.replays == n - len(keys)
    for kind, shape, impl, shards in keys:
        assert shape[0] == be._bucket(shape[0]) and shards == S
        assert kind in ({"decode", "wave"} if mode == "wave"
                        else {"decode", "chunk"})
    assert be.kv.free_pages == be.kv.n_pages


def test_shard_offsets_are_a_static_input(weights):
    """The rows' stripe offsets, built on the host every call, enter a
    sharded dispatch as a static input rewritten each call (never a
    tensor the dispatch builds)."""
    _, _, tm, tparams = weights
    be = tserving.ModelBackend(tm, tparams, device="cpu", n_slots=8,
                               max_len=64, kv_shards=2,
                               kv_mesh=make_kv_mesh(2, devices=["cpu"] * 2),
                               graphs=RerunCapturer())
    rids = [0, 1, 2]
    for r in rids:
        be.kv.allocate(r, 20)
    seen = []
    for sub in ([0, 1], [1, 2]):
        z = np.zeros(2, np.int64)
        be._dispatch_window(sub, np.zeros((2, 4), np.int64), z,
                            np.full(2, 4, np.int64), z)
        (e,) = be.graphs.entries.values()
        seen.append(e.static["shard_offs"].tolist())
        assert seen[-1] == list(be.kv.stripe_offsets(sub))
    assert len(be.graphs.entries) == 1


def test_stale_padded_rows_never_reach_the_pool(weights):
    """A batch of 4 then of 3 in the same bucket of 4: the padded fourth
    row is table 0, ctx 0, valid 0 again (not the earlier call's row), so
    the captured run commits the JAX package's tokens."""
    jm, jparams, tm, tparams = weights

    def drive(be):
        rng = np.random.default_rng(5)
        for rid, new in enumerate((8, 24, 24, 24)):
            pl = int(rng.integers(8, 30))
            be.admit(tserving.Request(
                rid=rid, arrival_time=0.0, prompt_len=pl,
                max_new_tokens=new,
                prompt_tokens=list(map(int, rng.integers(5, 500, pl)))))
        rids = list(range(4))
        for _ in range(200):
            live = [r for r in rids if not be.state(r).done]
            if not live and not be._prefill.queue:
                break
            be.decode_step(live, 8)
        return {r: list(be.state(r).output_tokens) for r in rids}

    want = drive(_jax()["repro.serving"].ModelBackend(
        jm, jparams, attn_impl="ref", n_slots=8, max_len=64))
    be = tserving.ModelBackend(tm, tparams, device="cpu", n_slots=8,
                               max_len=64, graphs=RerunCapturer())
    rows = []
    window = be._dispatch_window

    def spy(rids, *a):
        rows.append(len(rids))
        out = window(rids, *a)
        if len(rids) == 3:
            # the padded row as the backend pads it, not the earlier call's
            t = be.graphs.entries[("decode", (4, 8), "kernel", 1)].static
            assert (t["toks"][3] == tm.cfg.mask_token_id).all()
            assert all(int(t[k][3]) == 0 for k in ("start", "valid",
                                                     "n_adv"))
            assert not t["tables"][3].any()
        return out

    be._dispatch_window = spy
    got = drive(be)
    assert got == want
    assert 4 in rows and 3 in rows[rows.index(4):]
    assert ("decode", (4, 8), "kernel", 1) in be.graphs.entries


def test_cpu_backend_captures_nothing(weights):
    _, _, tm, tparams = weights
    be = tserving.ModelBackend(tm, tparams, device="cpu", n_slots=8,
                               max_len=64)
    assert be.graphs is None
    with pytest.raises(ValueError, match="CUDA device"):
        tserving.ModelBackend(tm, tparams, device="cpu", n_slots=8,
                              max_len=64, graphs=True)


# ---------------------------------------------------------------------------
# the analyzer's rules over the cache
# ---------------------------------------------------------------------------

def test_hlo005_counts_graphs(monkeypatch):
    """At most 3 graphs over raw decode batches 1..4 (buckets 1, 2, 4),
    with every replay in place and within its host budget; with the
    bucketing removed, 4 graphs and an HLO005 finding."""
    st = {}
    assert check.audit_graphs(1, "cpu", stats=st) == []
    # the churn's 3 decode buckets (batch 2 among them), then a chunk
    # and a wave graph, and the audited page moves' copy and swap-in
    # graphs (one block)
    assert st["graphs"] == 5 + 2
    monkeypatch.setattr(tserving.ModelBackend, "_bucket",
                        staticmethod(lambda n: n))
    fs = check.audit_graphs(1, "cpu")
    assert [f.rule for f in fs] == ["HLO005"]
    assert "captured 4 graphs" in fs[0].message


def test_hlo006_covers_the_capture_sites(monkeypatch):
    assert inventory.audit_registration() == []
    sites = inventory.scan_dispatch_sites()
    assert ("src/repro_torch/serving/graphs.py", "CudaCapturer.capture",
            "torch.cuda.CUDAGraph") in {s[:3] for s in sites}
    for gone in (("src/repro_torch/serving/graphs.py",
                  "CudaCapturer.capture", "torch.cuda.CUDAGraph"),
                 ("src/repro_torch/serving/backends.py",
                  "ModelBackend._dispatch", "self.graphs.dispatch")):
        monkeypatch.setattr(inventory, "KNOWN_DISPATCH_SITES",
                            inventory.KNOWN_DISPATCH_SITES - {gone})
        fs = inventory.audit_registration()
        assert [f.rule for f in fs] == ["HLO006"]
        assert fs[0].target.startswith(gone[0])
        monkeypatch.undo()


# ---------------------------------------------------------------------------
# on the card: captured against eager, bit for bit
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs have no CPU mode)")
    return torch.device("cuda")


# the audit model at head dim 128 (the hand kernels' SDAR-8B width), the
# sorted MoE path (16 experts: ``torch._grouped_mm``) and Qwen2-VL SMOKE
# (M-RoPE), each in bf16
CUDA_CFGS = {
    "audit": {**inventory.AUDIT_ARCH, "d_model": 256, "n_heads": 2,
              "n_kv_heads": 1},
    "moe16": {**inventory.AUDIT_ARCH, "family": "moe", "d_ff": 64,
              "moe_d_ff": 48, "n_experts": 16, "top_k": 2},
    "qwen2_vl_smoke": dataclasses.asdict(get_smoke_config("qwen2-vl-2b")),
}


@pytest.mark.cuda
@pytest.mark.parametrize("which, S", [("audit", 1), ("audit", 2),
                                      ("moe16", 1), ("qwen2_vl_smoke", 1)])
def test_captured_dispatches_bit_equal_eager(cuda, which, S):
    """Each dispatch kind in bf16, through a captured backend and an eager
    twin on the same host arrays, twice (capture, then replay): conf and
    tok bit-equal, the pools bit-equal and in place, launches = layers a
    call either way."""
    cfg = ArchConfig(**{**CUDA_CFGS[which], "param_dtype": "bfloat16",
                        "compute_dtype": "bfloat16"})
    model = build_model(cfg)
    params = model.init_params(device=cuda)
    kw = dict(n_slots=8, max_len=64, device=cuda,
              cache_dtype=torch.bfloat16, kv_shards=S,
              kv_mesh=make_kv_mesh(S, devices=[cuda] * S) if S > 1 else None)
    sides = [tserving.ModelBackend(model, params, graphs=g, **kw)
             for g in (True, False)]
    B, c, T = 4, 8, 16
    rng = np.random.default_rng(0)
    for be in sides:
        for r in range(B):
            be.kv.allocate(r, 2 * T)
    ptrs = rules.pool_ptrs(sides[0].kv)
    tables = np.asarray(sides[0].kv.batch_tables(list(range(B)),
                                                 sides[0]._table_width),
                        np.int32)
    so = sides[0]._shard_offs(list(range(B)), B)
    toks = rng.integers(4, cfg.vocab_size, (B, T)).astype(np.int64)
    kinds = [
        ("wave", "_wave", dict(toks=toks, lens=np.full(B, T, np.int32),
                               tables=tables)),
        ("chunk", "_chunk", dict(toks=toks, offs=np.full(B, T, np.int64),
                                 valid=np.full(B, T, np.int64),
                                 tables=tables, **so)),
        ("decode", "_decode", dict(toks=toks[:, :c],
                                   start=np.full(B, 2 * T - c, np.int64),
                                   valid=np.full(B, c, np.int64),
                                   tables=tables,
                                   n_adv=np.full(B, c // 2, np.int64),
                                   **so)),
    ]
    for kind, fn, host in kinds:
        for _ in range(2):
            n0 = cpa.LAUNCHES + bda.LAUNCHES
            got = [tuple(t.cpu() for t in be._dispatch(
                kind, getattr(be, fn), **host)) for be in sides]
            assert cpa.LAUNCHES + bda.LAUNCHES - n0 == 2 * S ** (
                kind != "wave") * cfg.n_layers
            for a, b in zip(*got):
                assert torch.equal(a, b), kind
            for a, b in zip(rules.pool_tensors(sides[0].kv),
                            rules.pool_tensors(sides[1].kv)):
                assert torch.equal(a, b), kind
    assert sides[0].graphs.replays == 3
    assert rules.check_pool_donation(sides[0].kv, ptrs) == []
