"""The port's mesh, sharding rules, collectives and sharded page pool, held
to the JAX package on the same inputs (numpy seeds, bridged weights).

The reference runs its shard bodies under ``shard_map`` on a multi-device
host; here its module-level bodies (``_local_slots``, ``_split_kv_body``,
``merge_flash_partials(axis_name=)``, ``compressed_psum``) run in this
process under ``jax.vmap(..., axis_name=...)`` over a stacked shard axis,
and the port's meshes repeat the CPU device (``make_kv_mesh(S,
devices=["cpu"] * S)``).  Tolerances: rules, specs and local slots exact;
partials and ``split_kv_attention`` within 1e-5 in fp32; committed tokens
identical to the reference's unsharded run.
"""

import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.distributed.collectives as jcoll
import repro.distributed.sharding as jsh
import repro.launch.mesh as jmesh
import repro.serving as jserving
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import build_model as jax_build
from repro.models.common import ArchConfig as JaxArchConfig
from repro.models.transformer import _scatter_pages as j_scatter_pages
from repro.serving.backends import _split_kv_collective_bytes
from repro.training.fault_tolerance import \
    elastic_shardings as j_elastic_shardings
import repro_torch.core as tcore
import repro_torch.distributed.collectives as tcoll
import repro_torch.distributed.sharding as tsh
import repro_torch.launch.mesh as tmesh
import repro_torch.serving as tserving
from repro_torch.analysis import rules
from repro_torch.kernels.ref import paged_chunk_ref
from repro_torch.models import ArchConfig, build_model, params_from_jax
from repro_torch.serving.kv_pool import PagedKVAllocator
from repro_torch.training.fault_tolerance import elastic_shardings

# tests/test_split_kv.py's serving config
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


def _mesh(S, axis="kv"):
    return tmesh.make_kv_mesh(S, axis=axis, devices=["cpu"] * S)


def _ks(S):
    return tcoll.KVShardSpec(_mesh(S), S)


def _t(a):
    return torch.as_tensor(np.array(a))


# ---------------------------------------------------------------------------
# rules and specs
# ---------------------------------------------------------------------------

PRESETS = {
    "training": lambda m: m.training_rules(),
    "training_no_fsdp": lambda m: m.training_rules(fsdp=False),
    "training_pod_data": lambda m: m.training_rules(("pod", "data"), "model"),
    "serving": lambda m: m.serving_rules(),
    "serving_no_seq_kv": lambda m: m.serving_rules(seq_shard_kv=False),
    "serving_moe_2d": lambda m: m.serving_rules(moe_2d=True),
    "serving_pod_data": lambda m: m.serving_rules(("pod", "data")),
    "long_context": lambda m: m.long_context_rules(),
    "kv_shard": lambda m: m.kv_shard_rules(),
    "kv_shard_custom": lambda m: m.kv_shard_rules("kvx", ("pod", "data"),
                                                  "tp"),
    "overrides": lambda m: m.training_rules().with_overrides(
        heads=None, batch=("data", "model")),
    "conflicting": lambda m: m.Rules({"a": "model", "b": "model",
                                      "c": ("data", "model")}),
}
NAMES = ["a", "b", "c", "batch", "heads", "mlp", "kv_pages", "kv_seq",
         "embed_p", "expert_mlp", None]


def _logical_tree():
    """The reference MoE model's logical-axis tree (dicts of tuples)."""
    m = jax_build(JaxArchConfig(**{**CFG, "family": "moe", "n_experts": 4,
                                   "top_k": 2, "moe_d_ff": 32}))
    return m.logical_axes()


def _as_tuples(tree):
    return jax.tree.map(tuple, tree,
                        is_leaf=lambda x: isinstance(x, jax.sharding
                                                     .PartitionSpec))


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_rules_match_reference(preset):
    """Every spec of every preset, for each name alone and every ordered
    pair and triple (conflicting axes included), equals the reference's;
    so do ``param_specs`` and ``elastic_shardings`` over a model's logical
    tree."""
    mine, ref = PRESETS[preset](tsh), PRESETS[preset](jsh)
    assert dict(mine.table) == dict(ref.table)
    names = sorted(mine.table) + NAMES
    for n in (1, 2, 3):
        for combo in itertools.permutations(NAMES if n > 1 else names, n):
            assert mine.spec(*combo) == tuple(ref.spec(*combo)), combo
    tree = _logical_tree()
    want = _as_tuples(j_elastic_shardings(tree, ref))
    assert elastic_shardings(tree, mine) == want
    with tsh.use_rules(mine):
        assert tsh.param_specs(tree) == want
        assert tsh.logical_spec("batch", "kv_pages") == \
            mine.spec("batch", "kv_pages")


def test_use_rules_nesting_and_empty_specs():
    tree = _logical_tree()
    assert tsh.current_rules() is None and tsh.current_mesh() is None
    assert tsh.logical_spec("batch") == tuple(jsh.logical_spec("batch")) \
        == ()
    assert tsh.param_specs(tree) == _as_tuples(jsh.param_specs(tree))
    outer, inner, mesh = tsh.training_rules(), tsh.kv_shard_rules(), _mesh(2)
    with tsh.use_rules(outer):
        with tsh.use_rules(inner, mesh):
            assert tsh.current_rules() is inner
            assert tsh.current_mesh() is mesh
            assert tsh.logical_spec("kv_pages") == ("kv",)
        assert tsh.current_rules() is outer and tsh.current_mesh() is None
    assert tsh.current_rules() is None
    x = torch.ones(2)
    assert tsh.shard(x, "batch") is x


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------

def _ref_production(**kw):
    """The reference's mesh shape and axes (``jax.make_mesh`` captured:
    this host has one device, not 256)."""
    real = jmesh.jax.make_mesh
    jmesh.jax.make_mesh = lambda shape, axes, **_: (tuple(shape),
                                                    tuple(axes))
    try:
        return jmesh.make_production_mesh(**kw)
    finally:
        jmesh.jax.make_mesh = real


@pytest.mark.parametrize("kw", [{}, {"multi_pod": True}, {"kv_shards": 2},
                                {"kv_shards": 4}, {"kv_shards": 16}],
                         ids=["pod", "multi_pod", "kv2", "kv4", "kv16"])
def test_production_mesh_matches_reference(kw):
    shape, axes = _ref_production(**kw)
    n = int(np.prod(shape))
    m = tmesh.make_production_mesh(devices=["cpu"] * n, **kw)
    assert (m.shape, m.axis_names) == (shape, axes)
    assert len(m.devices) == n
    for a in axes:
        assert m.size(a) == dict(zip(axes, shape))[a]
        assert len(m.axis_devices(a)) == m.size(a)
    fake = type("M", (), {"axis_names": axes})()
    assert tmesh.data_axes_of(m) == jmesh.data_axes_of(fake)
    with pytest.raises(ValueError):
        tmesh.make_production_mesh(devices=["cpu"] * (n - 1), **kw)


def test_kv_mesh_devices():
    with pytest.raises(ValueError, match="devices visible"):
        tmesh.make_kv_mesh(torch.cuda.device_count() + 1)
    with pytest.raises(ValueError, match="devices given"):
        tmesh.make_kv_mesh(4, devices=["cpu"] * 3)
    m = tmesh.make_kv_mesh(4, devices=["cpu"] * 4)
    assert (m.axis_names, m.shape, m.size("kv")) == (("kv",), (4,), 4)
    assert m.axis_devices("kv") == (torch.device("cpu"),) * 4
    with pytest.raises(ValueError):
        tcoll.KVShardSpec(m, 2)
    with pytest.raises(AssertionError):
        jmesh.make_kv_mesh(len(jax.devices()) + 1)
    with pytest.raises(ValueError, match="multi-pod"):
        tmesh.make_production_mesh(multi_pod=True, kv_shards=2)


# ---------------------------------------------------------------------------
# shard-local slots and partials
# ---------------------------------------------------------------------------

def _striped_state(S, W, ps, seed, n_req=6):
    """A random striped allocator state: requests of random lengths up to
    the table width ``W`` pages (stripe offsets vary as the shards fill),
    one grown to ``W`` pages, one trimmed to one token, one freed, and the
    last row's context set to 0."""
    rng = np.random.default_rng(seed)
    kv = PagedKVAllocator(S * W * (n_req + 2), ps, kv_shards=S)
    lens = {}
    for rid in range(n_req + 2):
        n = int(rng.integers(1, W * ps + 1))
        kv.allocate(rid, n)
        lens[rid] = n
    kv.free(n_req)                               # moves the offsets around
    kv.extend(0, W * ps)
    lens[0] = W * ps
    kv.trim(1, 1)
    lens[1] = 1
    rids = [r for r in lens if r != n_req]
    tables = np.array(kv.batch_tables(rids, width=W))
    ctx = np.array([lens[r] for r in rids], np.int32)
    ctx[-1] = 0                                   # a ctx-0 row
    return kv, rids, tables, ctx, kv.stripe_offsets(rids)


@pytest.mark.parametrize("S, W, ps, seed", [(2, 5, 4, 0), (2, 8, 4, 1),
                                            (4, 7, 4, 2), (4, 9, 2, 3),
                                            (4, 3, 4, 4)])
def test_local_slots_match_reference(S, W, ps, seed):
    kv, rids, tables, ctx, offs = _striped_state(S, W, ps, seed)
    P_loc = kv.pages_per_shard
    for rid in rids:                     # strict striping holds
        o = kv.stripe_offset(rid)
        assert all(kv.shard_of(p) == (o + j) % S
                   for j, p in enumerate(kv.block_table(rid)))
    for s in range(S):
        lt_j, lc_j = jcoll._local_slots(
            jnp.asarray(tables), jnp.asarray(ctx), jnp.asarray(offs), s,
            n_shards=S, pages_local=P_loc, page_size=ps)
        lt, lc = tcoll._local_slots(_t(tables), _t(ctx), _t(offs), s,
                                    n_shards=S, pages_local=P_loc,
                                    page_size=ps)
        assert lt.dtype == lc.dtype == torch.int32
        np.testing.assert_array_equal(lt.numpy(), np.asarray(lt_j))
        np.testing.assert_array_equal(lc.numpy(), np.asarray(lc_j))
    # the shards' local contexts add up to each row's context
    total = sum(tcoll._local_slots(_t(tables), _t(ctx), _t(offs), s,
                                   n_shards=S, pages_local=P_loc,
                                   page_size=ps)[1] for s in range(S))
    np.testing.assert_array_equal(total.numpy(), ctx)
    # a dispatch's once-for-all-layers views are the same, shard by shard
    views = tcoll.shard_local_slots(_t(tables), _t(ctx), _t(offs), _ks(S),
                                    pages_local=P_loc, page_size=ps)
    assert len(views) == S
    for s, (lt, lc) in enumerate(views):
        want = tcoll._local_slots(_t(tables), _t(ctx), _t(offs), s,
                                  n_shards=S, pages_local=P_loc,
                                  page_size=ps)
        assert torch.equal(lt, want[0]) and torch.equal(lc, want[1])


def _ref_body_vmapped(q, kp, vp, tables, ctx, offs, S):
    """The reference's split-KV body (its module-level pieces) under
    ``vmap`` over the stacked shard blocks, axis "kv"."""
    P_loc, ps = kp.shape[1], kp.shape[2]

    def body(kp_, vp_):
        shard = jax.lax.axis_index("kv")
        lt, lc = jcoll._local_slots(tables, ctx, offs, shard, n_shards=S,
                                    pages_local=P_loc, page_size=ps)
        part = jref.paged_chunk_ref(q, kp_, vp_, lt, lc)
        return jops.merge_flash_partials([part], axis_name="kv")

    out = jax.vmap(body, axis_name="kv")(kp, vp)
    return [np.asarray(t[0]) for t in out]


@pytest.mark.parametrize("impl", ["ref", "kernel"])
@pytest.mark.parametrize("S", [2, 4])
def test_split_kv_partial_matches_reference(S, impl):
    """The port's split-KV partial equals the reference's unsharded
    ``paged_chunk_ref`` and its split-KV body under vmap (1e-5); a ctx-0
    row is the exact empty partial, and a row whose every token sits on
    one shard is exactly that shard's partial (the empty shards merge to a
    no-op)."""
    W, ps = 6, 4
    kv, rids, tables, ctx, offs = _striped_state(S, W, ps, 10 + S)
    rng = np.random.default_rng(S)
    B, c, H, KVH, D = len(rids), 3, 4, 2, 8
    q = rng.standard_normal((B, c, H, D)).astype(np.float32)
    kp = rng.standard_normal((kv.n_pages, ps, KVH, D)).astype(np.float32)
    vp = rng.standard_normal((kv.n_pages, ps, KVH, D)).astype(np.float32)
    ks = _ks(S)
    got = tcoll.split_kv_paged_partial(
        _t(q), tcoll.shard_pages(_t(kp), ks, dim=0),
        tcoll.shard_pages(_t(vp), ks, dim=0), _t(tables), _t(ctx), _t(offs),
        ks, impl=impl)
    want = jref.paged_chunk_ref(jnp.asarray(q), jnp.asarray(kp),
                                jnp.asarray(vp), jnp.asarray(tables),
                                jnp.asarray(ctx))
    body = _ref_body_vmapped(
        jnp.asarray(q), jnp.asarray(kp.reshape(S, -1, ps, KVH, D)),
        jnp.asarray(vp.reshape(S, -1, ps, KVH, D)), jnp.asarray(tables),
        jnp.asarray(ctx), jnp.asarray(offs), S)
    live = ctx > 0
    for g, w, b in zip(got, want, body):
        g = g.numpy()
        np.testing.assert_allclose(g[live], np.asarray(w)[live], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(g[live], b[live], rtol=1e-5, atol=1e-5)
    acc, m, l = got
    empty = ~live
    assert (acc[empty] == 0).all() and (l[empty] == 0).all() \
        and (m[empty] == -1e30).all()
    one = [i for i, r in enumerate(rids)
           if 0 < ctx[i] <= ps]                   # one page: one shard
    assert one
    for i in one:
        s = kv.shard_of(int(tables[i, 0]))
        blk = slice(s * kv.pages_per_shard, (s + 1) * kv.pages_per_shard)
        lt, lc = tcoll._local_slots(_t(tables), _t(ctx), _t(offs), s,
                                    n_shards=S,
                                    pages_local=kv.pages_per_shard,
                                    page_size=ps)
        alone = paged_chunk_ref(_t(q), _t(kp[blk]), _t(vp[blk]), lt, lc)
        for g, a in zip(got, alone):
            assert torch.equal(g[i], a[i])


@pytest.mark.parametrize("S", [2, 4])
def test_scatter_pages_sharded_matches_reference(S):
    """The shard-local scatter leaves the logical pool byte-equal to the
    reference's ``_scatter_pages``, out-of-shard and sentinel entries
    dropped, every block written in place."""
    rng = np.random.default_rng(S)
    L, P, ps, KVH, hd, B, T = 2, 8 * S, 4, 2, 8, 3, 10
    pages = rng.standard_normal((L, P, ps, KVH, hd)).astype(np.float32)
    new = rng.standard_normal((L, B, T, KVH, hd)).astype(np.float32)
    dest = rng.permutation(P * ps)[:B * T].reshape(B, T)
    dest[0, :3] = P * ps                          # the sentinel
    ks = _ks(S)
    blocks = tcoll.shard_pages(_t(pages), ks)
    ptrs = rules.pool_ptrs(blocks)
    tcoll.scatter_pages_sharded(blocks, _t(new), _t(dest), ks)
    want = j_scatter_pages(jnp.asarray(pages), jnp.asarray(new),
                           jnp.asarray(dest))
    assert rules.check_pool_donation(blocks, ptrs) == []
    assert np.array_equal(tcoll.unshard_pages(blocks).numpy(),
                          np.asarray(want))


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def test_quantize_sr_and_compressed_psum_match_reference():
    """Given the reference's own draws, ``_quantize_sr`` equals the
    reference's exactly, and ``compressed_psum`` over 4 participants its
    vmapped ``compressed_psum``."""
    rng = np.random.default_rng(0)
    n, block, S = 1000, 256, 4
    key = jax.random.PRNGKey(7)
    xs = (rng.standard_normal((S, n)) * 0.01).astype(np.float32)
    u = np.asarray(jax.random.uniform(key, (-(-n // block), block)))
    q_j, s_j = jcoll._quantize_sr(jnp.asarray(xs[0]), key, block)
    q, s = tcoll._quantize_sr(_t(xs[0]), _t(u), block)
    assert np.array_equal(q.numpy(), np.asarray(q_j))
    assert np.array_equal(s.numpy(), np.asarray(s_j))
    assert np.array_equal(tcoll._dequantize(q, s, n, block).numpy(),
                          np.asarray(jcoll._dequantize(q_j, s_j, n, block)))
    want = jax.vmap(functools.partial(jcoll.compressed_psum, axis_name="p",
                                      rng=key, block=block),
                    axis_name="p")(jnp.asarray(xs))
    got = tcoll.compressed_psum([_t(x) for x in xs], block=block,
                                draws=[_t(u)] * S)
    for g, w in zip(got, np.asarray(want)):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-9)


def test_compressed_collectives_with_the_ports_generator():
    """tests/test_ssm_and_collectives.py's properties with a
    ``torch.Generator``: quantization unbiased over 64 draws, 8 replicated
    participants summed within 2% relative error, and the tree form."""
    rng = np.random.default_rng(0)
    g = torch.Generator().manual_seed(1)
    x = _t((rng.normal(size=(1000,)) * 0.01).astype(np.float32))
    outs = []
    for _ in range(64):
        q, s = tcoll._quantize_sr(x, tcoll.uniform_draws(g, 1000))
        outs.append(tcoll._dequantize(q, s, 1000))
    bias = float((torch.stack(outs).mean(0) - x).abs().max())
    assert bias < 0.05 * float(x.abs().max())
    x = torch.randn(4096, generator=g) * 1e-3
    got = tcoll.compressed_psum([x] * 8, g)
    assert len(got) == 8 and all(torch.equal(got[0], o) for o in got)
    rel = float(torch.linalg.norm(got[0] - 8 * x) / torch.linalg.norm(8 * x))
    assert rel < 0.02, rel
    mesh = tmesh.make_production_mesh(devices=["cpu"] * 256)
    trees = [{"w": x[:300] * (i + 1), "b": [x[:5], x[5:9]]}
             for i in range(16)]
    summed = tcoll.compressed_grad_sync(trees, mesh, ("data",), g)
    assert len(summed) == 16 and list(summed[0]) == ["w", "b"]
    for got, want in ((summed[3]["w"], x[:300] * 136),
                      (summed[0]["b"][1], 16 * x[5:9])):
        rel = float(torch.linalg.norm(got - want) / torch.linalg.norm(want))
        assert rel < 0.02, rel


@pytest.mark.parametrize("S", [2, 4])
def test_split_kv_attention_matches_reference(S):
    """The port's dense split-KV attention equals the reference's
    ``_split_kv_body`` under vmap (every shard's combined output) within
    1e-5."""
    rng = np.random.default_rng(S)
    B, c, H, KVH, D, T = 2, 4, 4, 2, 32, 64
    q = rng.standard_normal((B, c, H, D)).astype(np.float32)
    k = rng.standard_normal((B, T, KVH, D)).astype(np.float32)
    v = rng.standard_normal((B, T, KVH, D)).astype(np.float32)
    lens = np.array([60, 33], np.int32)
    stack = lambda a: jnp.asarray(  # noqa: E731
        a.reshape(B, S, T // S, KVH, D).transpose(1, 0, 2, 3, 4))
    want = jax.vmap(functools.partial(jcoll._split_kv_body,
                                      axis_name="model",
                                      scale=1.0 / np.sqrt(D)),
                    in_axes=(None, 0, 0, None), axis_name="model")(
        jnp.asarray(q), stack(k), stack(v), jnp.asarray(lens))
    got = tcoll.split_kv_attention(_t(q), _t(k), _t(v), _t(lens),
                                   _mesh(S, "model"))
    for w in np.asarray(want):
        np.testing.assert_allclose(got.numpy(), w, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the sharded pool's page operations
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [1, 2, 4])
def test_pool_blocks_follow_the_shard_spec(S):
    """``init_storage`` puts one block a shard on the spec's devices
    (an unsharded pool: its one tensor), ``pool_blocks`` yields them with
    the pages a block, and a spec of another shard count is refused."""
    ps, L, KVH, hd = 4, 2, 2, 8
    kv = PagedKVAllocator(8 * S, ps, kv_shards=S)
    spec = _ks(S) if S > 1 else None
    kv.init_storage(L, KVH, hd, device="cpu", shard=spec)
    ks, vs, per = kv.pool_blocks()
    assert per == 8 and len(ks) == len(vs) == S
    assert ks == ([kv.k_pages] if S == 1 else kv.k_pages)
    assert vs == ([kv.v_pages] if S == 1 else kv.v_pages)
    for b in ks + vs:
        assert b.shape == (L, per, ps, KVH, hd) and b.is_contiguous()
    assert kv.page_bytes == 2 * L * ps * KVH * hd * 4
    other = PagedKVAllocator(8 * S, ps, kv_shards=S)
    with pytest.raises(ValueError, match="mesh shards"):
        other.init_storage(L, KVH, hd, device="cpu",
                           shard=_ks(2 if S == 4 else 4))


def test_sharded_storage_routes_every_page_operation():
    """A pool sharded over a mesh and the same allocator with one global
    tensor, driven through the same COW, spill (prefix eviction and whole
    request) and swap-in: the logical pool and the host tier stay
    byte-equal, every COW destination stays on its source's shard, and no
    block moves."""
    S, ps, L, KVH, hd = 2, 4, 2, 2, 8
    sides = {}
    for name, mesh in (("sharded", _mesh(S)), ("flat", None)):
        kv = PagedKVAllocator(16, ps, kv_shards=S)
        kv.init_storage(L, KVH, hd, device="cpu",
                        shard=tcoll.KVShardSpec(mesh, S) if mesh else None)
        kv.attach_host(32)
        sides[name] = kv
    blocks = sides["sharded"].k_pages
    assert isinstance(blocks, list) and len(blocks) == S
    assert blocks[0].shape == (L, 8, ps, KVH, hd) and blocks[0].is_contiguous()
    ptrs = rules.pool_ptrs(sides["sharded"])
    g = torch.Generator().manual_seed(0)
    pool = torch.randn((L, 16, ps, KVH, hd), generator=g)
    for b, x in zip(blocks, torch.chunk(pool, S, dim=1)):
        b.copy_(x)
    sides["flat"].k_pages.copy_(pool)
    prompt = list(range(5, 5 + 3 * ps))
    pairs = {}
    for name, kv in sides.items():
        kv.allocate(0, len(prompt))
        kv.register_prefix(0, prompt)
        m = kv.lookup_prefix(prompt + [1], len(prompt) + 1)
        kv.allocate_prefix(1, len(prompt) + 1, m)
        pairs[name] = kv.ensure_private(1, 0, len(prompt) + 1)   # COW
        kv.spill_request(1)
        kv.free(0)
        kv.seize_pages(kv.free_pages - 2)        # evict parked pages
        kv.release_seized()
        kv.allocate(2, 6 * ps)                   # parked prefix → host
        kv.free(2)
        kv.swap_in_request(1)
    assert pairs["sharded"] == pairs["flat"] and pairs["sharded"]
    kvs = sides["sharded"]
    assert all(kvs.shard_of(a) == kvs.shard_of(b)
               for a, b in pairs["sharded"])
    assert kvs.stats == sides["flat"].stats
    assert kvs.stats["swap_out_pages"] > len(pairs["sharded"])
    for name in ("k_pages", "v_pages"):
        assert torch.equal(tcoll.unshard_pages(getattr(kvs, name)),
                           getattr(sides["flat"], name))
    assert torch.equal(kvs.host.k_host, sides["flat"].host.k_host)
    assert rules.check_pool_donation(kvs, ptrs) == []
    assert kvs.page_bytes == sides["flat"].page_bytes


# ---------------------------------------------------------------------------
# serving: the sharded ModelBackend against the reference's unsharded one
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
    return {True: bridged(True)}


def _drive(be, mode):
    """tests/test_split_kv.py's loop: three requests admitted at once,
    decode steps until every one is done."""
    rng = np.random.default_rng(0)
    rids = []
    for rid in range(3):
        pl = int(rng.integers(5, 30))
        be.admit(jserving.Request(
            rid=rid, arrival_time=0.0, prompt_len=pl, max_new_tokens=16,
            prompt_tokens=list(map(int, rng.integers(5, 250, pl)))))
        rids.append(rid)
    for _ in range(64):
        if all(be.state(r).done for r in rids) and not be._prefill.queue:
            break
        be.decode_step(rids, 1 if mode == "ar" else 8)
    return {r: list(be.state(r).committed[:be.state(r).frozen])
            for r in rids}


def _recorded(model, shapes):
    """Record each paged dispatch's (kind, batch, tokens) on the model."""
    def rec(kind, name):
        fn = getattr(type(model), name).__get__(model)

        def wrapped(params, cache, tokens, *a, **k):
            shapes.append((kind, *tokens.shape))
            return fn(params, cache, tokens, *a, **k)
        setattr(model, name, wrapped)
    rec("decode", "decode_step_paged")
    rec("chunked", "prefill_chunk_paged")
    rec("wave", "prefill_paged")


MODES = [("elastic", False), ("elastic", True), ("ar", False)]


@pytest.mark.parametrize("prefill", ["chunked", "wave"])
@pytest.mark.parametrize("mode, obs", MODES, ids=["slide", "obs", "ar"])
def test_sharded_backend_commits_reference_tokens(weights, mode, obs,
                                                  prefill):
    """``ModelBackend(kv_shards=S)`` for S in {2, 4} commits the reference's
    ``kv_shards=1`` tokens; ``device_dispatches`` and ``collective_bytes``
    follow the reference's formula over the dispatches made; every shard
    block keeps its ``data_ptr`` and the pool drains."""
    jm, jparams, tm, tparams = weights[True]
    kw = dict(n_slots=8, max_len=128, decode_mode=mode, obs=obs,
              prefill_mode=prefill)
    want = _drive(jserving.ModelBackend(jm, jparams, attn_impl="ref", **kw),
                  mode)
    assert any(want.values())
    for S in (2, 4):
        be = tserving.ModelBackend(tm, tparams, device="cpu", kv_shards=S,
                                   kv_mesh=_mesh(S), **kw)
        blocks = be.kv.k_pages + be.kv.v_pages
        assert len(blocks) == 2 * S
        ptrs = rules.pool_ptrs(be.kv)
        shapes = []
        _recorded(tm, shapes)
        try:
            got = _drive(be, mode)
        finally:
            for name in ("decode_step_paged", "prefill_chunk_paged",
                         "prefill_paged"):
                delattr(tm, name)
        assert got == want, S
        n_logical = be.decode_dispatches + be.prefill_dispatches
        assert len(shapes) == n_logical
        assert be.device_dispatches == S * n_logical
        assert be.collective_bytes == sum(
            _split_kv_collective_bytes(S, tm.paged_kv_dims()[0],
                                       tm.cfg.n_heads, tm.cfg.hd, B, T)
            for kind, B, T in shapes if kind != "wave")
        assert be.collective_bytes > 0
        assert rules.check_pool_donation(be.kv, ptrs) == []
        for r in list(got):
            be.release(r)
        assert be.kv.free_pages == be.kv.n_pages


def _pressured(side, w, S, pages, host):
    """A tight pool with a host tier and the prefix cache on: requests that
    share a 16-token head grow past the pool, so the engine preempts and
    spills, and re-admission swaps the exact KV back."""
    jm, jparams, tm, tparams = w
    core, serving = (jcore, jserving) if side == "jax" else \
        (tcore, tserving)
    kw = dict(max_len=64, kv_pages=pages, page_size=16, host_kv_pages=host,
              prefix_cache=True)
    if side == "jax":
        be = serving.ModelBackend(jm, jparams, attn_impl="ref", **kw)
    else:
        be = serving.ModelBackend(tm, tparams, device="cpu", kv_shards=S,
                                  kv_mesh=_mesh(S) if S > 1 else None, **kw)
    rng = np.random.default_rng(2)
    head = rng.integers(4, CFG["vocab_size"], 16).tolist()
    reqs = list(serving.PoissonWorkload(serving.DATASETS["sharegpt"], 50.0,
                                        6, seed=2))
    for r in reqs:
        r.arrival_time = 0.0
        r.prompt_len, r.max_new_tokens = 32, 32
        r.prompt_tokens = head + rng.integers(4, CFG["vocab_size"],
                                              16).tolist()
    outs = {}
    release = be.release

    def spy(rid):
        outs[rid] = list(be.state(rid).output_tokens)
        release(rid)

    be.release = spy
    rep = serving.ServingEngine(be, core.FixedScheduler(8),
                                max_batch=8).run(reqs)
    assert be.kv.free_pages == be.kv.n_pages
    return rep, outs, be


def test_sharded_backend_under_preemption_with_spill_and_prefix_cache(
        weights):
    """At S = 2 a tight pool preempts, spills to the host tier and swaps
    back, with the prefix cache on, and commits the tokens of the
    unpressured sharded run and of the reference's unpressured run."""
    w = weights[True]
    _, want, _ = _pressured("jax", w, 1, 64, 0)
    _, roomy, _ = _pressured("torch", w, 2, 64, 0)
    rep, tight, be = _pressured("torch", w, 2, 8, 64)
    assert rep.preemptions > 0
    assert be.kv.stats["swap_in_pages"] > 0
    assert be.prefix_hits > 0
    assert all(len(v) == 32 for v in tight.values())
    assert tight == roomy == want
