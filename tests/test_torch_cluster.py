"""The port's cluster layer against the JAX package's: the same scenarios
through each package's ``build_sim_cluster`` give equal ``ClusterReport``
fields (compared with ``==``); two paged model replicas per package, with
bridged fp32 weights, commit the same tokens behind the same routing; a
request migrated between two of the port's model replicas resumes the
uninterrupted trajectory of both packages; and the launchers print the
same lines for the same arguments, ``trace_view`` included."""

import dataclasses
import inspect
import sys
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import repro.cluster as jcluster
import repro.common.faults as jfaults
import repro.core as jcore
import repro.core.latency_model as jlm
import repro.serving as jserving
from repro.launch import serve as jserve
from repro.launch import serve_cluster as jserve_cluster
from repro.launch import trace_view as jtrace_view
from repro.models import build_model as jax_build
from repro.models.common import ArchConfig as JaxArchConfig
import repro_torch.cluster as tcluster
import repro_torch.common.faults as tfaults
import repro_torch.core as tcore
import repro_torch.core.latency_model as tlm
import repro_torch.serving as tserving
from repro_torch.analysis import rules
from repro_torch.launch import serve as tserve
from repro_torch.launch import serve_cluster as tserve_cluster
from repro_torch.launch import trace_view as ttrace_view
from repro_torch.models import ArchConfig, build_model, params_from_jax

SIDES = {
    "jax": SimpleNamespace(cluster=jcluster, faults=jfaults, core=jcore,
                           lm=jlm, serving=jserving, ArchConfig=JaxArchConfig),
    "torch": SimpleNamespace(cluster=tcluster, faults=tfaults, core=tcore,
                             lm=tlm, serving=tserving, ArchConfig=ArchConfig),
}
# tests/test_cluster.py's and tests/test_fault_tolerance.py's sim model
SIM = dict(name="sim8b", family="dense", n_layers=36, d_model=4096,
           n_heads=32, n_kv_heads=8, d_ff=12288, vocab_size=151936,
           block_size=32)
# tests/test_paged_backend.py's tiny model
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
# sim clusters: exact report equality
# ---------------------------------------------------------------------------

def _poisson(n, rate, seed, **kw):
    def make(s):
        return list(s.serving.PoissonWorkload(
            s.serving.DATASETS["sharegpt"], rate=rate, n_requests=n,
            seed=seed, **kw))
    return make


def _fault_reqs(n=8, prompt=64, out=48, gap=0.01):
    def make(s):
        return [s.serving.Request(rid=i, prompt_len=prompt,
                                  max_new_tokens=out, arrival_time=gap * i)
                for i in range(n)]
    return make


def _prioritised(make):
    def wrapped(s):
        reqs = make(s)
        for r in reqs:
            r.priority = 1 if r.rid % 3 == 0 else 0
        return reqs
    return wrapped


def _oversized(make):
    def wrapped(s):
        reqs = make(s)
        reqs[3].prompt_len = 10_000        # a 96-page pool holds 1536 tokens
        return reqs
    return wrapped


def _with_deadline(make, after):
    def wrapped(s):
        reqs = make(s)
        for r in reqs:
            r.deadline = r.arrival_time + after
            r.slo_class = "deadline"
        return reqs
    return wrapped


def _plan(spec):
    return lambda s: s.faults.FaultPlan.parse(spec)


def _random_plan(seed):
    return lambda s: s.faults.FaultPlan.random(
        2, horizon_s=0.6, seed=seed, crash_rate=2.0, stall_rate=2.0,
        oom_rate=3.0, duration_s=0.2, warn_s=0.03)


# tests/test_fault_tolerance.py's harness: fixed chunk 8, chunked prefill,
# a host tier to migrate through
FAULT = dict(mode="bd8", max_batch=8, prefill_mode="chunked", seed=9,
             kv_pages=4096, host_kv_pages=8192)
CRASH = "crash@0.08:r0:down=0.5:warn=0.03"

# name: (replicas, router, requests, build_sim_cluster options (a callable
# value is called with the side), what the scenario must exercise)
SCENARIOS = {
    "round_robin": (3, "round_robin", _poisson(60, 16.0, 9), {"seed": 9},
                    lambda r: all(n > 0 for n in r.route_counts)),
    "jsq": (3, "jsq", _poisson(60, 16.0, 9), {"seed": 9},
            lambda r: all(n > 0 for n in r.route_counts)),
    "saturation": (3, "saturation", _poisson(60, 16.0, 9), {"seed": 9},
                   lambda r: all(n > 0 for n in r.route_counts)),
    "spill_back": (2, "saturation", _poisson(30, 64.0, 13, max_prompt=256,
                                             max_output=256),
                   {"seed": 13, "kv_pages": 128}, lambda r: r.spills > 0),
    "preemption": (2, "saturation",
                   _prioritised(_poisson(30, 64.0, 13, max_prompt=256,
                                         max_output=256)),
                   {"seed": 13, "kv_pages": 128, "preemption": True},
                   lambda r: r.preemptions > 0),
    "oversized": (2, "jsq", _oversized(_poisson(10, 8.0, 17, max_prompt=256,
                                                max_output=128)),
                  {"seed": 17, "kv_pages": 96}, lambda r: r.rejected == [3]),
    "chunked_prefill": (2, "saturation", _poisson(40, 16.0, 5),
                        {"seed": 5, "prefill_mode": "chunked"},
                        lambda r: len(r.metrics) == 40),
    "deadline_shed": (2, "saturation",
                      _with_deadline(_poisson(40, 64.0, 3), 0.4),
                      {"seed": 3, "kv_pages": 256},
                      lambda r: r.reject_reasons().get("deadline", 0) > 0),
    "warned_crash": (2, "health:jsq", _fault_reqs(),
                     {**FAULT, "fault_plan": _plan(CRASH)},
                     lambda r: r.migrations > 0 and r.lost_tokens == 0),
    "naive_crash": (2, "jsq", _fault_reqs(),
                    {**FAULT, "fault_plan": _plan(CRASH), "health": False,
                     "recovery": lambda s: s.cluster.RecoveryPolicy(
                         migrate=False)},
                    lambda r: r.resubmissions > 0 and r.lost_tokens > 0),
    "unwarned_crash": (2, "health:jsq", _fault_reqs(),
                       {**FAULT, "fault_plan":
                        _plan("crash@0.08:r0:down=0.4")},
                       lambda r: r.resubmissions > 0
                       and r.lost_computed_tokens > 0),
    "recover_rewarm": (2, "health:jsq", _fault_reqs(24, out=32, gap=0.02),
                       {**FAULT, "fault_plan":
                        _plan("crash@0.05:r0:down=0.1:warn=0.02")},
                       lambda r: any(f["op"] == "recover" for f in r.faults)
                       and r.migrations > 0),
    "stall": (1, "rr", _fault_reqs(4, gap=0.0),
              {**FAULT, "fault_plan": _plan("stall@0.0:r0:dur=100:slow=4")},
              lambda r: any(f["op"] == "stall" for f in r.faults)),
    "oom_storm": (2, "health:jsq", _fault_reqs(12, out=32, gap=0.005),
                  {**FAULT, "kv_pages": 128,
                   "fault_plan": _plan("oom@0.02:r0:frac=0.9:dur=0.2;"
                                       "oom@0.04:r1:frac=0.8:dur=0.1")},
                  lambda r: sum(f["op"] == "oom" for f in r.faults) == 2),
    "random_plan": (2, "health:jsq", _fault_reqs(6, out=24),
                    {**FAULT, "fault_plan": _random_plan(1),
                     "max_spill_retries": 8},
                    lambda r: len(r.faults) > 0),
}


def _report(rep) -> dict:
    """Every field of a ``ClusterReport``, and each replica's history."""
    return {
        "metrics": [dataclasses.astuple(m) for m in rep.metrics],
        "route_counts": rep.route_counts, "spills": rep.spills,
        "preemptions": rep.preemptions, "rejected": rep.rejected,
        "rejections": rep.rejections, "faults": rep.faults,
        "migrations": rep.migrations,
        "migrations_failed": rep.migrations_failed,
        "resubmissions": rep.resubmissions, "lost_tokens": rep.lost_tokens,
        "lost_computed_tokens": rep.lost_computed_tokens,
        "wiped": rep.wiped, "token_utilization": rep.token_utilization,
        "replicas": [(r.chunk_history, r.batch_history, r.total_time,
                      r.decode_time, r.total_tokens, r.computed_tokens)
                     for r in rep.replica_reports],
    }


def _run_sim(side, scenario):
    s = SIDES[side]
    n, router, reqs, opts, _ = SCENARIOS[scenario]
    kw = {k: v(s) if callable(v) else v for k, v in opts.items()}
    cluster = s.cluster.build_sim_cluster(
        s.ArchConfig(**SIM), s.serving.DATASETS["sharegpt"], n, router,
        device=s.lm.A100_80G, **kw)
    return cluster.run(reqs(s))


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_sim_cluster_report_equals_reference(scenario):
    rep_j = _run_sim("jax", scenario)
    rep_t = _run_sim("torch", scenario)
    assert SCENARIOS[scenario][4](rep_t), "the scenario missed its path"
    want, got = _report(rep_j), _report(rep_t)
    for field in want:
        assert got[field] == want[field], field


# ---------------------------------------------------------------------------
# model clusters: bridged weights, identical tokens and routing
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def weights():
    # the reference runs its jnp oracle; the port its default path (the
    # kernels' plain versions on CPU tensors)
    jm = jax_build(JaxArchConfig(**CFG, paged_attn_impl="ref"))
    jparams = jm.init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    return jm, jparams, build_model(ArchConfig(**CFG)), tparams


def _requests(s, n, seed=0, prompt=12, out=16):
    """tests/test_paged_backend.py's requests, all arriving at t = 0."""
    rng = np.random.default_rng(seed)
    reqs = list(s.serving.PoissonWorkload(s.serving.DATASETS["sharegpt"],
                                          50.0, n, seed=seed))
    for r in reqs:
        r.prompt_len, r.max_new_tokens = prompt, out
        r.prompt_tokens = rng.integers(4, CFG["vocab_size"], prompt).tolist()
        r.arrival_time = 0.0
    return reqs


def _spy(cores) -> dict:
    outs = {}
    for core in cores:
        be = core.backend

        def make(release, be):
            def spy(rid):
                outs[rid] = list(be.state(rid).output_tokens)
                release(rid)
            return spy

        be.release = make(be.release, be)
    return outs


def _serve_model_cluster(side, weights, router, mode, prefill_mode):
    jm, jparams, tm, tparams = weights
    s = SIDES[side]
    kw = dict(profile=s.serving.DATASETS["sharegpt"], mode=mode, max_len=64,
              max_batch=4, prefill_mode=prefill_mode)
    if side == "torch":
        kw["device"] = "cpu"
    model, params = (jm, jparams) if side == "jax" else (tm, tparams)
    cluster = s.cluster.build_model_cluster(model, params, 2, router, **kw)
    outs = _spy(cluster.replicas)
    rep = cluster.run(_requests(s, 6))
    return cluster, rep, outs


@pytest.mark.parametrize("router,mode,prefill_mode", [
    ("round_robin", "bd8", "chunked"),       # tests/test_paged_backend.py
    ("saturation", "elastic", "wave"),       # the router reads the models
])
def test_model_cluster_commits_reference_tokens(weights, router, mode,
                                                prefill_mode):
    _, rep_j, out_j = _serve_model_cluster("jax", weights, router, mode,
                                           prefill_mode)
    cluster, rep_t, out_t = _serve_model_cluster("torch", weights, router,
                                                 mode, prefill_mode)
    assert len(rep_t.metrics) == 6 and not rep_t.rejected
    assert all(len(v) == 16 for v in out_t.values())
    assert out_t == out_j
    assert rep_t.route_counts == rep_j.route_counts
    assert all(n > 0 for n in rep_t.route_counts)
    params = weights[3]
    for core in cluster.replicas:
        kv = core.backend.kv
        assert kv.free_pages == kv.n_pages and not kv._spilled
        assert core.backend.params is params
        assert all(core.backend.params[n].data_ptr() == t.data_ptr()
                   for n, t in params.items())


# ---------------------------------------------------------------------------
# migration on the port's ModelBackend
# ---------------------------------------------------------------------------

def _migration_core(side, weights, outs):
    """tests/test_fault_tolerance.py's replica: chunked prefill in 16-token
    chunks, a host tier, fixed chunk 8."""
    jm, jparams, tm, tparams = weights
    s = SIDES[side]
    kw = dict(n_slots=8, max_len=96, decode_mode="elastic",
              prefill_mode="chunked", prefill_token_budget=16,
              host_kv_pages=512)
    if side == "jax":
        be = s.serving.ModelBackend(jm, jparams, **kw)
    else:
        be = s.serving.ModelBackend(tm, tparams, device="cpu", **kw)
    core = s.serving.EngineCore(be, s.core.FixedScheduler(8), max_batch=8)
    release = be.release

    def spy(rid):
        outs[rid] = tuple(be.state(rid).output_tokens)
        release(rid)

    be.release = spy
    return core


def _migration_request(s):
    rng = np.random.default_rng(3)
    r = s.serving.Request(rid=0, prompt_len=40, max_new_tokens=24,
                          arrival_time=0.0)
    r.prompt_tokens = rng.integers(4, 248, 40).tolist()
    return r


def _drain(core, req=None):
    if req is not None:
        core.submit(req)
    while not core.idle:
        core.tick()


def test_migrated_trajectory_equals_uninterrupted(weights):
    s = SIDES["torch"]
    base = {}
    for side in ("jax", "torch"):
        outs = {}
        _drain(_migration_core(side, weights, outs),
               _migration_request(SIDES[side]))
        base[side] = outs[0]
    assert len(base["torch"]) == 24
    assert base["torch"] == base["jax"]

    src = _migration_core("torch", weights, {})
    src.submit(_migration_request(s))
    while not src.idle:
        st = src.backend._states.get(0)
        if st is not None and st.n_committed >= 8 \
                and not src.backend._prefill.pending(0):
            break
        src.tick()
    kv = src.backend.kv
    table = kv.block_table(0)
    before = (kv.k_pages[:, table].clone(), kv.v_pages[:, table].clone())
    assert src.backend._states[0].n_committed >= 8
    assert src.preempt(0, reason="drain", force_spill=True)
    (moved,) = src.take_pending()
    ticket = src.backend.migrate_out(0)
    assert ticket is not None and not kv._spilled
    assert ticket["payload"]["k"].equal(before[0])
    assert ticket["payload"]["v"].equal(before[1])

    outs = {}
    dst = _migration_core("torch", weights, outs)
    ptr = rules.pool_ptrs(dst.backend.kv)
    assert dst.backend.migrate_in(moved, ticket)
    dst.note_failover(moved.rid)
    _drain(dst, moved)
    assert outs[0] == base["torch"] == base["jax"]
    assert rules.check_pool_donation(dst.backend.kv, ptr) == []
    assert dst.backend.kv.free_pages == dst.backend.kv.n_pages


# ---------------------------------------------------------------------------
# launchers
# ---------------------------------------------------------------------------

def _main_lines(main, argv, capsys, monkeypatch, paths=()):
    """Run a launcher's ``main`` in process; its printed lines, with the
    given paths replaced by their names."""
    monkeypatch.setattr(sys, "argv", argv)
    capsys.readouterr()
    main()
    out = capsys.readouterr().out
    for p in paths:
        out = out.replace(str(p), "<trace>")
    return out.splitlines()


CLUSTER_ARGV = ["--device", "a100-80g", "--replicas", "2", "--requests",
                "24", "--rate", "16", "--host-kv-pages", "4096",
                "--faults", "crash@0.6:r0:down=0.5:warn=0.1;"
                "stall@0.2:r1:dur=0.3:slow=3"]


def test_serve_cluster_prints_reference_lines(tmp_path, capsys,
                                              monkeypatch):
    lines, traces = {}, {}
    for side, mod in (("jax", jserve_cluster), ("torch", tserve_cluster)):
        trace = tmp_path / f"{side}.jsonl"
        perfetto = tmp_path / f"{side}.perfetto.json"
        traces[side] = (trace, perfetto)
        lines[side] = _main_lines(
            mod.main, ["serve_cluster", *CLUSTER_ARGV, "--trace", str(trace)],
            capsys, monkeypatch, (trace, perfetto))
    assert lines["torch"] == lines["jax"]
    assert any(line.startswith("faults applied: crash=1 stall=1")
               for line in lines["torch"])

    views = {}
    for side, mod in (("jax", jtrace_view), ("torch", ttrace_view)):
        trace, perfetto = traces[side]
        capsys.readouterr()
        assert mod.main([str(trace), "--replay"]) == 0
        assert mod.main(["--validate-perfetto", str(perfetto)]) == 0
        out = capsys.readouterr().out
        views[side] = out.replace(str(trace), "<trace>") \
            .replace(str(perfetto), "<perfetto>").splitlines()
    assert views["torch"] == views["jax"]
    assert any(line.startswith("decision replay:")
               for line in views["torch"])


def test_serve_single_replica_faults_prints_reference_lines(capsys,
                                                            monkeypatch):
    argv = ["serve", "--device", "a100-80g", "--requests", "12", "--rate",
            "8", "--faults", "stall@0.2:r0:dur=0.5:slow=4"]
    want = _main_lines(jserve.main, argv, capsys, monkeypatch)
    got = _main_lines(tserve.main, argv, capsys, monkeypatch)
    assert got == want
    assert "faults applied: stall=1" in got


# ---------------------------------------------------------------------------
# the H100 spec is the port's default
# ---------------------------------------------------------------------------

def test_h100_spec_is_the_launchers_default(monkeypatch):
    h100 = tlm.DEVICES["h100-sxm"]
    assert h100 is tlm.H100_SXM
    assert (h100.peak_flops, h100.hbm_bw, h100.hbm_bytes) == \
        (989e12, 3.35e12, 80 * 2**30)
    assert "h100-sxm" not in jlm.DEVICES       # the reference is unchanged
    sig = inspect.signature(tcluster.build_sim_cluster).parameters
    assert sig["device"].default is h100
    model_sig = inspect.signature(tcluster.build_model_cluster).parameters
    assert model_sig["device"].default == "cuda"

    seen = {}

    class Seen(Exception):
        pass

    def capture(name):
        def stub(*a, **k):
            seen[name] = k.get("device", a[1] if len(a) > 1 else None)
            raise Seen
        return stub

    monkeypatch.setattr(tserve_cluster, "build_sim_cluster",
                        capture("serve_cluster"))
    monkeypatch.setattr(tserve, "SimBackend", capture("serve"))
    for name, mod in (("serve_cluster", tserve_cluster), ("serve", tserve)):
        monkeypatch.setattr(sys, "argv", [name])
        with pytest.raises(Seen):
            mod.main()
    assert seen == {"serve_cluster": h100, "serve": h100}
