"""The port's static analyzer (``repro_torch.analysis``), itself
mutation-tested as the reference's is (``tests/test_analysis.py``):

* zero active findings on the port's own tree — Pass 2 at default scope
  (modulo the allowlisted WallClock adapter) and Pass 1 over the
  ``kv_shards`` 1 and 2 inventories on the CPU;
* every rule fires on its seeded violation in
  ``repro_torch.analysis.fixtures`` and names the offending op or line, and
  Pass 2 and HLO006 fire on a scratch copy of the tree with one violation
  added;
* the op trace's byte accounting equals the reference's jaxpr walker
  (``repro.analysis.jaxpr.byte_traffic``) on single ops of the same shapes
  and dtypes (hypothesis property);
* the hand kernels are one op each in the trace, with their cost
  function's FLOPs, and take a shape-only route on ``meta`` tensors;
* the collective record, and the sync-free page scatter;
* the page moves and the train step registered (HLO006), HLO005 counted
  per kind with the pool's own bound, and the graph audit replaying each
  page move;
* allowlist parsing and the CLI's red/green exit.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.analysis import (check, fixtures, hlo, inventory, lint,
                                  optrace, rules)
from repro_torch.analysis.check import DEFAULT_ALLOWLIST, main, run_pass1
from repro_torch.analysis.findings import (Finding, apply_allowlist,
                                           load_allowlist, parse_allowlist)

REPO = Path(__file__).resolve().parents[1]
FIX = ("src/repro_torch/analysis/fixtures.py",)


def _msgs(fs):
    return [f"{f.rule} {f.target}: {f.message}" for f in fs]


# ---------------------------------------------------------------------------
# zero findings on the port's tree
# ---------------------------------------------------------------------------

def test_lint_zero_active_findings_on_port():
    """Pass 2 at default scope: the only findings are the allowlisted
    WallClock lines in the port's serving/clock.py."""
    active, waived = apply_allowlist(lint.run_all(),
                                     load_allowlist(DEFAULT_ALLOWLIST))
    assert active == [], _msgs(active)
    assert waived and all(f.rule == "AST103" and
                          f.target.startswith("src/repro_torch/serving/"
                                              "clock.py:") for f in waived)


@pytest.mark.parametrize("kv_shards", [1, 2])
def test_pass1_zero_findings_on_cpu(kv_shards):
    """The dispatch audit over the inventory — pool in place, vocab
    escape, host budget, collectives, churn, registration — green on the
    CPU at one shard and at two shards of one device."""
    findings = run_pass1([kv_shards], device="cpu")
    assert findings == [], _msgs(findings)


def test_registration_audit_green_and_sites():
    assert inventory.audit_registration() == []
    sites = {(rel, desc) for rel, _, desc, _ in
             inventory.scan_dispatch_sites()}
    assert ("src/repro_torch/serving/backends.py",
            "self.model.decode_step_paged") in sites
    assert ("src/repro_torch/serving/kv_pool.py", "copy_pages") in sites
    assert len(sites) == len(inventory.KNOWN_DISPATCH_SITES)


def test_pool_moves_and_train_step_registered():
    """The page moves' and the train step's replays through a graph cache
    are registered sites (HLO006), beside the moves' bodies."""
    sites = {(rel, qual, desc) for rel, qual, desc, _ in
             inventory.scan_dispatch_sites()}
    for site in (("src/repro_torch/serving/kv_pool.py",
                  "PagedKVAllocator._pool_dispatch", "self.graphs.dispatch"),
                 ("src/repro_torch/serving/kv_pool.py",
                  "PagedKVAllocator._device_copy", "copy_pages"),
                 ("src/repro_torch/serving/kv_pool.py",
                  "PagedKVAllocator._swap_in_device", "write_pages"),
                 ("src/repro_torch/training/train_loop.py",
                  "Trainer.train_step", "self.graphs.dispatch")):
        assert site in sites and site in inventory.KNOWN_DISPATCH_SITES


def test_graph_audit_replays_the_pool_kinds_on_cpu():
    """``audit_graphs`` at two shards: one replay of each paged kind and of
    each page move (a COW copy and a swap-in into both blocks), 0
    findings; 5 paged graphs and one a block of each move."""
    stats = {}
    assert check.audit_graphs(2, "cpu", stats=stats) == []
    assert sorted(stats["replays"]) == ["chunk", "copy", "decode",
                                        "swap_in", "wave"]
    assert stats["graphs"] == 5 + 2 * 2


class _Graphs:
    def __init__(self, keys):
        self.entries = dict.fromkeys(keys)


def test_hlo005_counts_paged_graphs_per_kind():
    """The captured half of HLO005 counts the paged kinds only (page moves
    captured meanwhile do not count against its bound of 3); the pool
    bound is per kind: blocks x (ceil(log2 P) + 1)."""
    g = _Graphs([])
    moves = iter([("copy", 0, 1), ("swap_in", 0, 2), ("copy", 0, 4),
                  ("copy", 0, 8)])

    def drive(b):
        g.entries[("decode", (min(b, 3), 4), "kernel", 1)] = None
        g.entries[next(moves)] = None
    assert rules.check_graph_churn(g, drive, (1, 2, 3, 4),
                                   declared_buckets=3) == []
    g = _Graphs([])
    fs = rules.check_graph_churn(
        g, lambda b: g.entries.__setitem__(("chunk", (b, 4)), None),
        (1, 2, 3, 4), declared_buckets=3)
    assert [f.rule for f in fs] == ["HLO005"]
    from repro_torch.serving.kv_pool import PagedKVAllocator
    kv = PagedKVAllocator(8, 4, kv_shards=2)
    kv.init_storage(1, 1, 4, device="cpu", shard=_two_shards())
    ok = [(kind, b, n) for kind in ("copy", "swap_in") for b in (0, 1)
          for n in (1, 2, 4)]
    assert rules.check_pool_graph_churn(_Graphs(ok), kv) == []
    fs = rules.check_pool_graph_churn(_Graphs(ok + [("swap_in", 1, 8)]), kv)
    assert [(f.rule, f.target) for f in fs] == [("HLO005",
                                                 "graphs@pool:swap_in")]


def _two_shards():
    from repro_torch.distributed.collectives import KVShardSpec
    from repro_torch.launch.mesh import make_kv_mesh
    return KVShardSpec(make_kv_mesh(2, devices=["cpu"] * 2), 2)


def test_inventory_entries_on_cpu():
    for S, names in ((1, ["decode_step_paged", "prefill_paged",
                          "prefill_chunk_paged", "copy_pages",
                          "write_pages"]),
                     (2, ["decode_step_paged", "prefill_paged",
                          "prefill_chunk_paged"])):
        es = inventory.build_entries(S, device="cpu")
        assert [e.name for e in es] == names
        assert all(e.target.endswith(f"@kv{S}") for e in es)
    dec = inventory.build_entries(2, device="cpu")[0]
    # n_attn · B·c·H·(D+2)·4 per device: 2 · 2·4·4·18·4
    assert dec.expected_collectives == {"all-reduce": 2 * 2 * 4 * 4 * 18 * 4}


# ---------------------------------------------------------------------------
# mutation fixtures: every rule fires and names the offending op/line
# ---------------------------------------------------------------------------

def test_ast101_raise_before_mutate_fires():
    fs = lint.check_raise_before_mutate(scope=FIX)
    assert [f.rule for f in fs] == ["AST101"]
    assert "BadAllocator.allocate" in fs[0].message
    assert fs[0].target.endswith(":24")          # the seeded raise line


def test_ast102_reserve_before_commit_fires():
    fs = lint.check_reserve_before_commit(scope=FIX)
    assert [f.rule for f in fs] == ["AST102"]
    assert "commit" in fs[0].message and "_reserve_step" in fs[0].message
    assert fs[0].target.endswith(":33")


def test_ast103_wallclock_fires():
    fs = lint.check_wallclock(scope=FIX)
    assert {f.rule for f in fs} == {"AST103"}
    msgs = " ".join(f.message for f in fs)
    assert "time.perf_counter" in msgs and "time.time" in msgs
    assert {f.target.rsplit(":", 1)[1] for f in fs} == {"44", "45"}


def test_ast104_tracer_guard_fires():
    fs = lint.check_tracer_guards(scope=FIX)
    assert [f.rule for f in fs] == ["AST104"]
    assert "NULL_TRACER" in fs[0].message
    assert fs[0].target.endswith(":52")


def test_ast105_host_commit_purity_fires_on_torch():
    fs = lint.check_host_commit_purity(scope=FIX)
    assert {f.rule for f in fs} == {"AST105"}
    seeded = {f.target.rsplit(":", 1)[1]: f.message for f in fs}
    assert "torch" in seeded["59"]               # the seeded import torch
    assert "torch" in seeded["60"]               # ... and torch.as_tensor


def test_hlo001_pool_copy_fires():
    fn, (cache, x) = fixtures.undonated_pool_step()
    ptrs = rules.pool_ptrs(cache)
    out, tr = optrace.trace(fn, cache, x)
    fs = rules.check_pool_donation(out, ptrs, tr, target="fixture")
    assert {f.rule for f in fs} == {"HLO001"}
    msgs = " ".join(f.message for f in fs)
    assert "moved" in msgs and "op clone allocates [4, 8, 2, 4]" in msgs \
        and "a pool tensor's shape" in msgs
    # the same step in place passes
    def inplace(cache, x):
        cache["k_pages"][0] += x
        cache["v_pages"][0] += x
        return cache
    out, tr = optrace.trace(inplace, cache, x)
    assert rules.check_pool_donation(out, ptrs, tr, target="fixture") == []


def test_hlo002_vocab_escape_fires():
    fn, args = fixtures.vocab_escaping_step()
    _, tr = optrace.trace(fn, *args)
    fs = rules.check_vocab_escape(tr.outputs,
                                  vocab_size=fixtures.FIXTURE_VOCAB,
                                  target="fixture")
    assert [f.rule for f in fs] == ["HLO002"]
    assert "[2, 4, 307]" in fs[0].message and "V=307" in fs[0].message
    census = rules.census_vocab_intermediates(
        tr, vocab_size=fixtures.FIXTURE_VOCAB)
    assert census and all(307 in shape for _, shape in census)


def test_hlo003_host_budget_fires():
    fn, args = fixtures.vocab_escaping_step()
    _, tr = optrace.trace(fn, *args)
    budget = 8 * fixtures.FIXTURE_B * fixtures.FIXTURE_C
    fs = rules.check_host_budget(tr.outputs, budget_bytes=budget,
                                 target="fixture")
    assert [f.rule for f in fs] == ["HLO003"]
    assert str(budget) in fs[0].message          # names the budget…
    assert "9824" in fs[0].message               # …and the actual bytes
    # a sync is a finding of its own
    fs = rules.check_host_budget([], budget_bytes=budget, syncs=2,
                                 target="fixture")
    assert [f.rule for f in fs] == ["HLO003"] and "2 time" in fs[0].message
    assert rules.count_syncs(lambda: 7, "cpu") == (None, 7)


def test_hlo004_collective_audit_fires():
    fn, args, expected = fixtures.missing_collective_step()
    _, tr = hlo.traced(fn, *args)
    fs = rules.check_collectives(tr.collectives, expected=expected,
                                 target="fixture")
    assert [f.rule for f in fs] == ["HLO004"]
    assert "missing collective all-reduce" in fs[0].message
    # the reverse direction: nothing reduced, nothing declared
    assert rules.check_collectives(tr.collectives, expected={},
                                   target="fixture") == []
    # and an undeclared reduction is a finding too
    fs = rules.check_collectives(
        {"all-reduce": {"bytes": 64, "count": 1}}, expected={},
        target="fixture")
    assert [f.rule for f in fs] == ["HLO004"] and "unexpected" in \
        fs[0].message


def test_hlo005_shape_churn_fires():
    fn, makers = fixtures.unbucketed_grid_step()
    fs = rules.check_recompile_churn(fn, makers, declared_buckets=3,
                                     target="fixture")
    assert [f.rule for f in fs] == ["HLO005"]
    assert "4 distinct input signatures" in fs[0].message

    def bucket(n):
        b = 1
        while b < n:
            b <<= 1
        return b

    makers2 = [(lambda b=b: ((torch.zeros((bucket(b), 4)),), {}))
               for b in (1, 2, 3, 4)]
    assert rules.check_recompile_churn(fn, makers2, declared_buckets=3,
                                       target="fixture") == []


def test_hlo006_registration_fires_when_unregistered(monkeypatch):
    monkeypatch.setattr(inventory, "KNOWN_DISPATCH_SITES", frozenset())
    fs = inventory.audit_registration()
    assert fs and all(f.rule == "HLO006" for f in fs)
    assert any("self.model.decode_step_paged" in f.message
               and "backends.py" in f.target for f in fs)


def test_pass2_and_hlo006_fire_on_a_scratch_copy(tmp_path):
    """A copy of the port's tree with one unregistered dispatch site, one
    graph capture and one wall-clock read added: HLO006 names both new
    sites and AST103 the new line; the copy is otherwise clean."""
    shutil.copytree(REPO / "src" / "repro_torch", tmp_path / "src" /
                    "repro_torch", ignore=shutil.ignore_patterns(
                        "__pycache__"))
    be = tmp_path / "src/repro_torch/serving/backends.py"
    n = len(be.read_text().splitlines())
    be.write_text(be.read_text() + (
        "\n\ndef _extra_dispatch(self, *a):\n"
        "    return self.model.decode_step_paged(*a)\n"
        "\n\ndef _captured(fn):\n"
        "    return torch.compile(fn)\n"))
    eng = tmp_path / "src/repro_torch/serving/engine.py"
    m = len(eng.read_text().splitlines())
    eng.write_text(eng.read_text() + "\n\ndef _now():\n"
                   "    import time\n    return time.monotonic()\n")
    fs = inventory.audit_registration(root=str(tmp_path))
    assert sorted(f.target for f in fs) == [
        f"src/repro_torch/serving/backends.py:{n + 4}",
        f"src/repro_torch/serving/backends.py:{n + 8}"]
    assert {f.rule for f in fs} == {"HLO006"}
    assert "torch.compile" in " ".join(f.message for f in fs)
    active, _ = apply_allowlist(lint.run_all(root=str(tmp_path)),
                                load_allowlist(DEFAULT_ALLOWLIST))
    assert [(f.rule, f.target) for f in active] == [
        ("AST103", f"src/repro_torch/serving/engine.py:{m + 5}")]


# ---------------------------------------------------------------------------
# op-trace byte accounting vs the reference's jaxpr walker
# ---------------------------------------------------------------------------

@pytest.fixture
def jaxpr_walker(monkeypatch):
    """The reference's walker, with the jaxpr classes it names from
    ``jax.core`` taken from ``jax.extend.core``, where this jax keeps them
    (its own tests of the walker fail on that name, ROADMAP queue 3)."""
    import jax.extend.core
    from repro.analysis import jaxpr
    monkeypatch.setattr(jaxpr, "jax_core", jax.extend.core)
    return jaxpr.byte_traffic


def _jax_bytes(walker, fn, *arrays) -> tuple:
    """(walker's bytes, equation count) of ``fn``'s jaxpr."""
    import jax
    closed = jax.make_jaxpr(fn)(*arrays)
    return walker(closed), len(closed.jaxpr.eqns)


def _torch_bytes(fn, *tensors) -> tuple:
    """(op trace's bytes, op count) of ``fn``."""
    _, tr = optrace.trace(fn, *tensors)
    return optrace.byte_traffic(tr), len(tr.ops)


def _sum1(x):
    """``jnp.sum(x, axis=1)``'s program in torch: a bfloat16 sum
    accumulates in float32 between two converts there (three equations),
    a float32 one is one reduction."""
    if x.dtype == torch.bfloat16:
        return torch.sum(x.float(), dim=1).to(x.dtype)
    return torch.sum(x, dim=1)


def _pair(op: str):
    """(jnp function, torch function, shapes of the operands) of one op
    over dims (m, k, n)."""
    import jax.numpy as jnp
    return {
        "add": (jnp.add, torch.add, lambda m, k, n: [(m, k), (m, k)]),
        "mul": (jnp.multiply, torch.mul, lambda m, k, n: [(m, k), (m, k)]),
        "exp": (jnp.exp, torch.exp, lambda m, k, n: [(m, k)]),
        "matmul": (jnp.matmul, torch.matmul,
                   lambda m, k, n: [(m, k), (k, n)]),
        "sum": (lambda x: jnp.sum(x, axis=1), _sum1,
                lambda m, k, n: [(m, k, n)]),
        "transpose": (lambda x: jnp.transpose(x), lambda x: x.t(),
                      lambda m, k, n: [(m, k)]),
        "concatenate": (lambda a, b: jnp.concatenate([a, b], axis=0),
                        lambda a, b: torch.cat([a, b], dim=0),
                        lambda m, k, n: [(m, k), (n, k)]),
    }[op]


def _check_op(walker, op, m, k, n, dtype):
    import jax.numpy as jnp
    jf, tf, shapes = _pair(op)
    rng = np.random.default_rng(m * 100 + k * 10 + n)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes(m, k,
                                                                       n)]
    jt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    want = _jax_bytes(walker, jf, *[jnp.asarray(a, dtype=jt) for a in arrs])
    got = _torch_bytes(tf, *[torch.as_tensor(a).to(tt) for a in arrs])
    assert got == want, (op, m, k, n, dtype, got, want)
    assert got[1] == (3 if (op, dtype) == ("sum", "bfloat16") else 1)


OPS = ["add", "mul", "exp", "matmul", "sum", "transpose", "concatenate"]


@pytest.mark.parametrize("op", OPS)
def test_byte_traffic_matches_jaxpr_walker(op, jaxpr_walker):
    for dtype in ("float32", "bfloat16"):
        _check_op(jaxpr_walker, op, 3, 5, 2, dtype)


def test_byte_traffic_matches_jaxpr_walker_hypothesis(jaxpr_walker):
    from hypothesis import given, settings
    from hypothesis import strategies as st

    dims = st.integers(min_value=1, max_value=9)

    @settings(max_examples=40, deadline=None)
    @given(m=dims, k=dims, n=dims, op=st.sampled_from(OPS),
           dtype=st.sampled_from(["float32", "bfloat16"]))
    def prop(m, k, n, op, dtype):
        _check_op(jaxpr_walker, op, m, k, n, dtype)

    prop()


# ---------------------------------------------------------------------------
# the hand kernels in the trace: one op, their cost, a meta route
# ---------------------------------------------------------------------------

def _paged_args(device, dtype=torch.float32):
    B, c, H, KVH, D, ps, P, W = 2, 4, 8, 2, 16, 16, 6, 3
    g = torch.Generator().manual_seed(0)
    mk = lambda *s: torch.randn(s, generator=g).to(dtype)  # noqa: E731
    args = (mk(B, c, H, D), mk(P, ps, KVH, D), mk(P, ps, KVH, D),
            torch.tensor([[0, 1, 2], [3, 4, 5]], dtype=torch.int32),
            torch.tensor([40, 7], dtype=torch.int32))
    return tuple(a.to(device) for a in args), (B, c, H, KVH, D, ps, W)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_paged_kernel_is_one_op_with_its_cost(device):
    from repro_torch.kernels import chunked_paged_attn as cpa
    from repro_torch.kernels.ops import paged_chunk_attention
    args, (B, c, H, KVH, D, ps, W) = _paged_args(device)
    before = cpa.LAUNCHES
    out, tr = optrace.trace(paged_chunk_attention, *args)
    assert cpa.LAUNCHES == before                 # no launch on either
    assert [op.name for op in tr.ops] == ["paged_chunk_attention"]
    flops, nbytes = cpa.cost(B, c, H, KVH, D, ps, 4, n_slots=W)
    assert tr.ops[0].flops == flops == 4.0 * B * W * ps * c * H * D
    assert optrace.byte_traffic(tr) == nbytes
    assert hlo.analyze(tr)["flops"] == flops
    assert [(tuple(t.shape), t.dtype, t.device.type) for t in out] == [
        ((B, c, H, D), torch.float32, device),
        ((B, c, H), torch.float32, device),
        ((B, c, H), torch.float32, device)]
    if device == "cpu":                           # the plain version's values
        from repro_torch.kernels.ref import paged_chunk_ref
        for a, b in zip(out, paged_chunk_ref(*args)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_block_diffusion_kernel_is_one_op_with_its_cost(device):
    from repro_torch.kernels import block_diffusion_attn as bda
    from repro_torch.kernels.ops import block_diffusion_attention
    B, T, H, KVH, D, bs = 2, 24, 4, 2, 8, 8
    g = torch.Generator().manual_seed(1)
    q = torch.randn(B, T, H, D, generator=g).to(torch.bfloat16)
    k = torch.randn(B, T, KVH, D, generator=g).to(torch.bfloat16)
    v = torch.randn(B, T, KVH, D, generator=g).to(torch.bfloat16)
    ln = torch.tensor([24, 5], dtype=torch.int32)
    args = tuple(t.to(device) for t in (q, k, v, ln))
    before = bda.LAUNCHES
    out, tr = optrace.trace(block_diffusion_attention, *args,
                            block_size=bs)
    assert bda.LAUNCHES == before
    assert [op.name for op in tr.ops] == ["block_diffusion_attention"]
    flops, nbytes = bda.cost(B, T, H, KVH, D, bs, 2)
    # every row at full length: Σ_t (t // 8 + 1)·8 = 8·(8+16+24) a row
    assert flops == 4.0 * D * H * B * 8 * (8 + 16 + 24)
    assert tr.ops[0].flops == flops and optrace.byte_traffic(tr) == nbytes
    assert (tuple(out.shape), out.dtype, out.device.type) == (
        (B, T, H, D), torch.bfloat16, device)
    # this call's data: row 1 sees min(5, ·) keys
    f_data, _ = bda.cost(B, T, H, KVH, D, bs, 2, lengths=[24, 5])
    assert f_data == 4.0 * D * H * (8 * (8 + 16 + 24) + 24 * 5)


def test_meta_dispatch_traces_without_values():
    """A whole decode dispatch on meta tensors: the kernels' meta routes,
    the meta scatter, one kernel op a layer, nothing computed."""
    from repro_torch.models import ArchConfig, build_model
    cfg = ArchConfig(**inventory.AUDIT_ARCH)
    model = build_model(cfg)
    params = model.init_params(device="meta")
    pool = model.init_paged_cache(16, 16, device="meta")
    z = lambda *s, dt=torch.int64: torch.empty(s, dtype=dt,  # noqa: E731
                                                device="meta")
    (conf, tok, _), tr = optrace.trace(
        model.decode_step_paged, params, pool, z(2, 4), z(2), z(2),
        z(2, 4, dt=torch.int32), z(2), z(2))
    assert conf.is_meta and tuple(tok.shape) == (2, 4)
    assert hlo.analyze(tr)["kernels"] == {"paged_chunk_attention": 2}


# ---------------------------------------------------------------------------
# the collective record and the sync-free page scatter
# ---------------------------------------------------------------------------

def test_collective_record_counts_split_kv_merges():
    from repro_torch.distributed.collectives import (KVShardSpec, psum,
                                                     record_snapshot,
                                                     shard_pages,
                                                     split_kv_paged_partial)
    from repro_torch.launch.mesh import Mesh, make_kv_mesh
    args, (B, c, H, KVH, D, ps, W) = _paged_args("cpu")
    q, kp, vp, tables, ctx = args
    ks = KVShardSpec(make_kv_mesh(2, devices=["cpu", "cpu"]), 2)
    before = record_snapshot()["all-reduce"]
    split_kv_paged_partial(q, shard_pages(kp, ks, dim=0),
                           shard_pages(vp, ks, dim=0), tables, ctx,
                           torch.zeros(B, dtype=torch.int32), ks)
    after = record_snapshot()["all-reduce"]
    assert after["bytes"] - before["bytes"] == B * c * H * (D + 2) * 4
    assert after["count"] - before["count"] == 3      # pmax + 2 psum
    mesh = Mesh(("data", "model"), (1, 2), ("cpu", "cpu"))
    psum([torch.ones(5), torch.ones(5)], mesh, "model")
    assert record_snapshot()["all-reduce"]["bytes"] - after["bytes"] == 20
    psum([torch.ones(5), torch.ones(5)], mesh, "data")  # groups of one
    assert record_snapshot()["all-reduce"]["bytes"] - after["bytes"] == 20


def test_scatter_pages_drops_sentinels_without_a_host_read():
    """The page scatter writes every live entry and drops every sentinel
    one (the reference's ``mode="drop"``) with no data-dependent shape —
    against a per-entry loop, at every live share, on the CPU and shape
    only on meta."""
    from repro_torch.models.transformer import _scatter_pages
    g = torch.Generator().manual_seed(0)
    L, P, ps, KVH, hd, B, T = 2, 5, 4, 2, 3, 3, 4
    for trial in range(60):
        pages = torch.randn(L, P, ps, KVH, hd, generator=g)
        want = pages.clone()
        new = torch.randn(L, B, T, KVH, hd, generator=g)
        dest = torch.randperm(P * ps, generator=g)[:B * T].reshape(B, T)
        keep = torch.rand(B, T, generator=g) < (trial % 3) / 2
        dest = torch.where(keep, dest, P * ps)
        flat = want.view(L, P * ps, KVH, hd)
        for b in range(B):
            for t in range(T):
                if keep[b, t]:
                    flat[:, dest[b, t]] = new[:, b, t]
        ptr = pages.data_ptr()
        out, tr = optrace.trace(_scatter_pages, pages, new, dest)
        assert torch.equal(pages, want) and out.data_ptr() == ptr
        assert "nonzero" not in [op.name for op in tr.ops]
    m = torch.empty(L, P, ps, KVH, hd, device="meta")
    _scatter_pages(m, new.to("meta"), dest.to("meta"))


# ---------------------------------------------------------------------------
# allowlist + CLI
# ---------------------------------------------------------------------------

def test_allowlist_parse_and_match():
    entries = parse_allowlist(
        "# comment\n"
        "AST103:src/repro_torch/serving/clock.py:*  # wall-clock adapter\n")
    assert len(entries) == 1
    hit = Finding("AST103", "src/repro_torch/serving/clock.py:28", "m")
    miss = Finding("AST103", "src/repro_torch/serving/engine.py:10", "m")
    active, waived = apply_allowlist([hit, miss], entries)
    assert waived == [hit] and active == [miss]
    with pytest.raises(ValueError, match="reason"):
        parse_allowlist("AST103:foo.py:*\n")     # waiver without a reason
    with pytest.raises(ValueError, match="RULE:target"):
        parse_allowlist("not-a-rule  # why\n")
    assert [e.pattern for e in load_allowlist(DEFAULT_ALLOWLIST)] == [
        "AST103:src/repro_torch/serving/clock.py:*"]


def test_cli_green_on_cpu(tmp_path):
    """`python -m repro_torch.analysis.check --device cpu --kv-shards 1,2
    --json …` exits 0 with jax and the JAX package blocked, and writes the
    structured findings."""
    out_json = tmp_path / "findings.json"
    code = ("import sys, runpy\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "sys.argv = ['check', '--device', 'cpu', '--kv-shards', '1,2',"
            f" '--json', {str(out_json)!r}]\n"
            "runpy.run_module('repro_torch.analysis.check', "
            "run_name='__main__')\n")
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=REPO, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "0 active finding(s), 3 waived" in r.stdout
    rec = json.loads(out_json.read_text())
    assert rec["active"] == []
    assert {f["rule"] for f in rec["waived"]} == {"AST103"}


def test_cli_device_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--only", "hlo", "--kv-shards", "1"])
    assert main(["--only", "lint"]) == 0
