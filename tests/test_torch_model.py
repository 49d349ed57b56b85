"""The port's paged transformer against the JAX package's, per dispatch,
under teacher forcing: the same bridged weights and the same window tokens
go through ``prefill_chunk_paged`` and ``decode_step_paged`` on both sides,
and the same admission wave through ``prefill_paged``, for the dense, moe
(the Llama-4 Scout and Kimi K2 SMOKE configs, which take the dense MoE
oracle, and a 16-expert config that takes the sorted path) and vlm
(Qwen2-VL SMOKE: M-RoPE, multimodal embeds) families.

Tolerances (fp32 on the CPU): conf, logits and written pages within 1e-5
absolute — the two frameworks sum matmuls in another order; tokens
must be equal.  The port's pool must be updated in place
(``data_ptr`` unchanged).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import build_model as jax_build
from repro.models.common import ArchConfig as JaxArchConfig
from repro.models.layers import apply_mrope as jax_apply_mrope
from repro_torch.analysis import rules
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import (ArchConfig, EncDecLM, TransformerLM,
                                build_model, params_from_jax)
from repro_torch.models.layers import apply_mrope, rope_for

# tests/test_paged_backend.py's config
PAGED_CFG = dict(name="t", family="dense", n_layers=2, d_model=64, n_heads=4,
                 n_kv_heads=2, d_ff=128, vocab_size=256, block_size=8,
                 confidence_threshold=0.6)
# more than 8 experts: moe_block takes the sorted path (grouped products)
MOE16_CFG = dict(name="moe16", family="moe", n_layers=2, d_model=64,
                 n_heads=4, n_kv_heads=2, d_ff=64, moe_d_ff=48, n_experts=16,
                 top_k=2, vocab_size=256, block_size=8,
                 confidence_threshold=0.6)


def _smoke(name):
    return (lambda: jax_smoke(name), lambda: get_smoke_config(name))


CONFIGS = {
    "sdar8b_smoke": _smoke("sdar-8b"),
    "paged_backend": (lambda: JaxArchConfig(**PAGED_CFG),
                      lambda: ArchConfig(**PAGED_CFG)),
    "llama4_scout_smoke": _smoke("llama4-scout-17b-a16e"),
    "kimi_k2_smoke": _smoke("kimi-k2-1t-a32b"),
    "qwen2_vl_smoke": _smoke("qwen2-vl-2b"),
    "moe16": (lambda: JaxArchConfig(**MOE16_CFG),
              lambda: ArchConfig(**MOE16_CFG)),
}
# tests/test_prefill_interleave.py's AR config (causal prefill)
AR_CFG = {**PAGED_CFG, "name": "tar", "diffusion": False}
# tests/test_chunked_equivalence.py's 8-layer hybrid: two periods of 4
HYBRID8_CFG = dict(name="h", family="hybrid", n_layers=8, d_model=64,
                   n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256,
                   attn_period=4, attn_offset=1, block_size=8)
# the recurrent families on the dense-slot path
RECURRENT_CONFIGS = {
    "rwkv6_smoke": _smoke("rwkv6-1.6b"),
    "jamba_smoke": _smoke("jamba-1.5-large-398b"),
    "hybrid8": (lambda: JaxArchConfig(**HYBRID8_CFG),
                lambda: ArchConfig(**HYBRID8_CFG)),
}
WAVE_CONFIGS = {**CONFIGS, "paged_backend_ar": (
    lambda: JaxArchConfig(**AR_CFG), lambda: ArchConfig(**AR_CFG))}


def _pages_close(cache_t, cache_j):
    for name in ("k_pages", "v_pages"):
        np.testing.assert_allclose(cache_t[name].numpy(),
                                   np.asarray(cache_j[name]), rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("which", sorted(CONFIGS))
def test_paged_dispatches_match_jax(which):
    jcfg, tcfg = CONFIGS[which][0](), CONFIGS[which][1]()
    assert tcfg == ArchConfig(**{f.name: getattr(jcfg, f.name)
                                 for f in jcfg.__dataclass_fields__.values()})
    jm, tm = jax_build(jcfg), build_model(tcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    assert sum(t.numel() for t in tparams.values()) == tcfg.param_count()

    rng = np.random.default_rng(0)
    B, ps, P, W, c = 2, 8, 24, 8, 8
    prompts = [20, 13]
    toks = [rng.integers(4, tcfg.vocab_size, n) for n in prompts]
    tables = np.zeros((B, W), np.int32)
    tables[0, :4] = [5, 0, 17, 9]
    tables[1, :3] = [2, 11, 23]

    jcache = jm.init_paged_cache(P, ps, dtype=jnp.float32)
    tcache = tm.init_paged_cache(P, ps, dtype=torch.float32, device="cpu")
    ptr = rules.pool_ptrs(tcache)
    jpre = jax.jit(functools.partial(jm.prefill_chunk_paged, impl="kernel",
                                     interpret=True))
    jdec = jax.jit(functools.partial(jm.decode_step_paged, impl="kernel",
                                     interpret=True))
    i32 = functools.partial(np.asarray, dtype=np.int32)

    def both_prefill(chunk_toks, offs, valid):
        a = [i32(chunk_toks), i32(offs), i32(valid), tables]
        cj, tj, new = jpre(jparams, jcache, *map(jnp.asarray, a))
        ct, tt, same = tm.prefill_chunk_paged(
            tparams, tcache, *(torch.from_numpy(x) for x in a))
        assert same is tcache
        np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=0,
                                   atol=1e-5)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
        _pages_close(tcache, new)
        return new

    # two block-aligned prefill chunks per row (the second reads the first
    # through the pages), then the remainder
    T = 16
    ch = np.zeros((B, T), np.int64)
    for i in range(B):
        ch[i, :8] = toks[i][:8]
    jcache = both_prefill(ch, [0, 0], [8, 8])
    ch = np.zeros((B, T), np.int64)
    for i in range(B):
        rest = toks[i][8:]
        ch[i, :len(rest)] = rest
    jcache = both_prefill(ch, [8, 8], [prompts[0] - 8, prompts[1] - 8])

    # two teacher-forced decode windows: same window tokens both sides
    start = np.asarray(prompts)
    for step, n_adv in enumerate(([3, 0], [1, 2])):
        win = np.full((B, c), tcfg.mask_token_id, np.int64)
        win[:, :n_adv[0]] = rng.integers(4, tcfg.vocab_size, n_adv[0])
        valid = np.asarray([c, c - 3 * step])
        a = [i32(win), i32(start), i32(valid), tables, i32(start),
             i32(n_adv)]
        cj, tj, jcache = jdec(jparams, jcache, *map(jnp.asarray, a))
        ct, tt, _ = tm.decode_step_paged(tparams, tcache,
                                         *(torch.from_numpy(x) for x in a))
        assert ct.shape == (B, c) and tt.dtype == torch.int32
        np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=0,
                                   atol=1e-5)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
        _pages_close(tcache, jcache)
        start = start + np.asarray(n_adv)
    assert rules.check_pool_donation(tcache, ptr) == []


@pytest.mark.parametrize("head_mode", ["sample", "logits"])
@pytest.mark.parametrize("which", sorted(WAVE_CONFIGS))
def test_prefill_paged_matches_jax(which, head_mode):
    """One wave-prefill dispatch on both sides: a batch padded to a power of
    two with a ``lengths = 0`` row, a prompt shorter than the block, and
    rows sharing no pages.  The head output and every page of the pool must
    agree, and the port's pool is written in place."""
    jcfg, tcfg = WAVE_CONFIGS[which][0](), WAVE_CONFIGS[which][1]()
    jm, tm = jax_build(jcfg), build_model(tcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    rng = np.random.default_rng(4)
    ps, P, W = 8, 24, 4
    lens = np.asarray([29, 5, 0, 16], np.int32)     # 5 < block, 0 = padding
    B, T = len(lens), 32
    toks = np.zeros((B, T), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(4, tcfg.vocab_size, n)
    tables = np.zeros((B, W), np.int32)
    tables[0] = [5, 0, 17, 9]
    tables[1, :1] = [2]
    tables[3, :2] = [11, 23]

    jcache = jm.init_paged_cache(P, ps, dtype=jnp.float32)
    tcache = tm.init_paged_cache(P, ps, dtype=torch.float32, device="cpu")
    ptr = rules.pool_ptrs(tcache)
    jpre = jax.jit(functools.partial(jm.prefill_paged, head_mode=head_mode))
    jout, jcache = jpre(jparams, jcache, jnp.asarray(toks),
                        jnp.asarray(lens), jnp.asarray(tables))
    tout, same = tm.prefill_paged(
        tparams, tcache, torch.from_numpy(toks), torch.from_numpy(lens),
        torch.from_numpy(tables), head_mode=head_mode)
    assert same is tcache
    if head_mode == "sample":
        (cj, tj), (ct, tt) = jout, tout
        assert ct.shape == (B,) and tt.dtype == torch.int32
        np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=0,
                                   atol=1e-5)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
    else:
        assert tout.shape == (B, tcfg.vocab_size)
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=0,
                                   atol=1e-5)
    assert torch.isfinite(tcache["k_pages"]).all()
    _pages_close(tcache, jcache)
    # written: exactly the live positions' slots (pool was zero)
    assert int((tcache["k_pages"][0].abs().sum((-1, -2)) > 0).sum()) == \
        int(lens.sum())
    assert rules.check_pool_donation(tcache, ptr) == []


def test_param_layout_and_count_match_jax():
    """The port's own init has the bridged layout (names, shapes, dtypes)
    for a dense, an ssm and a hybrid config, and the meta-device count
    equals the JAX abstract count for every ported family."""
    for smoke in ("sdar-8b", "rwkv6-1.6b", "jamba-1.5-large-398b"):
        jparams = jax_build(jax_smoke(smoke)).init(jax.random.PRNGKey(0))
        bridged = params_from_jax(jax.tree.map(np.asarray, jparams),
                                  device="cpu")
        tm = build_model(get_smoke_config(smoke))
        own = tm.init_params(torch.Generator().manual_seed(0), device="cpu")
        assert {k: (tuple(v.shape), v.dtype) for k, v in own.items()} == \
            {k: (tuple(v.shape), v.dtype) for k, v in bridged.items()}
    for name in ("sdar-8b", "smollm-135m", "llama3.2-1b",
                 "llama4-scout-17b-a16e", "kimi-k2-1t-a32b", "qwen2-vl-2b",
                 "rwkv6-1.6b", "jamba-1.5-large-398b"):
        from repro.configs import get_config as jget
        from repro_torch.configs import get_config as tget
        assert tget(name).param_count() == jget(name).param_count()


def test_bridge_bfloat16_bits():
    """bf16 arrays come across bit-exactly through their 16-bit pattern."""
    x = jnp.asarray(np.random.default_rng(2).normal(size=(3, 5)),
                    jnp.bfloat16)
    t = params_from_jax({"a": {"b": np.asarray(x)}}, device="cpu")["a/b"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(x.astype(jnp.float32)))


def test_apply_mrope_matches_jax():
    """M-RoPE with [B, 3, T] positions (t, h and w ids differ) against the
    JAX package's, and a [B, T] array broadcast to t = h = w."""
    rng = np.random.default_rng(5)
    B, T, H, D, sections = 2, 7, 3, 16, (2, 3, 3)
    x = rng.normal(size=(B, T, H, D)).astype(np.float32)
    pos3 = rng.integers(0, 300, (B, 3, T)).astype(np.int32)
    want = jax_apply_mrope(jnp.asarray(x), jnp.asarray(pos3), 1e6, sections)
    got = apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3), 1e6,
                      sections)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    cfg = get_smoke_config("qwen2-vl-2b")
    pos = torch.from_numpy(pos3[:, 0].astype(np.int64))
    x = torch.from_numpy(x)
    assert torch.equal(rope_for(cfg, x, pos),
                       apply_mrope(x, pos[:, None].expand(B, 3, T),
                                   cfg.rope_theta, cfg.mrope_sections))


def _vl_models():
    """The Qwen2-VL SMOKE model on both sides, with the same weights."""
    jcfg, tcfg = jax_smoke("qwen2-vl-2b"), get_smoke_config("qwen2-vl-2b")
    jm, tm = jax_build(jcfg), build_model(tcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    return jm, tm, jparams, tparams


def test_prefill_paged_mm_embeds_matches_jax():
    """Qwen2-VL SMOKE: a wave prefill whose prompts carry precomputed
    multimodal embeddings at some positions (``mm_embeds`` where
    ``mm_mask``) gives the reference's logits and pages."""
    jm, tm, jparams, tparams = _vl_models()
    tcfg = tm.cfg
    rng = np.random.default_rng(6)
    ps, P, W = 8, 12, 3
    lens = np.asarray([20, 11], np.int32)
    B, T = 2, 24
    toks = rng.integers(4, tcfg.vocab_size, (B, T)).astype(np.int32)
    mm = rng.normal(size=(B, T, tcfg.d_model)).astype(np.float32)
    mask = np.zeros((B, T), bool)
    mask[0, 2:9] = mask[1, 0:4] = True
    tables = np.asarray([[3, 7, 1], [5, 0, 0]], np.int32)
    jcache = jm.init_paged_cache(P, ps, dtype=jnp.float32)
    tcache = tm.init_paged_cache(P, ps, dtype=torch.float32, device="cpu")
    jout, jcache = jm.prefill_paged(jparams, jcache, jnp.asarray(toks),
                                    jnp.asarray(lens), jnp.asarray(tables),
                                    jnp.asarray(mm), jnp.asarray(mask))
    tout, _ = tm.prefill_paged(tparams, tcache, torch.from_numpy(toks),
                               torch.from_numpy(lens),
                               torch.from_numpy(tables),
                               torch.from_numpy(mm), torch.from_numpy(mask))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=0,
                               atol=1e-5)
    _pages_close(tcache, jcache)
    plain, _ = tm.prefill_paged(tparams, tm.init_paged_cache(
        P, ps, dtype=torch.float32, device="cpu"), torch.from_numpy(toks),
        torch.from_numpy(lens), torch.from_numpy(tables))
    assert not torch.allclose(plain, tout, atol=1e-3)   # the embeds count


@pytest.mark.parametrize("entry", ["prefill_chunk_paged",
                                   "chunk_forward_paged",
                                   "decode_step_paged"])
def test_paged_dispatch_mm_embeds_matches_jax(entry):
    """Qwen2-VL SMOKE: the chunked-prefill and decode entry points take
    ``mm_embeds`` where ``mm_mask`` as ``prefill_paged`` does — on a pool
    both sides prefilled alike, one dispatch with embeddings at some
    positions gives the reference's outputs (conf and tok, or logits and
    the window's K/V) and pages."""
    jm, tm, jparams, tparams = _vl_models()
    tcfg = tm.cfg
    rng = np.random.default_rng(7)
    ps, P, B, c = 8, 12, 2, 8
    tables = np.asarray([[3, 7, 1, 9], [5, 0, 2, 0]], np.int32)
    lens = np.asarray([16, 8], np.int32)
    pre = rng.integers(4, tcfg.vocab_size, (B, 16)).astype(np.int32)
    jcache = jm.init_paged_cache(P, ps, dtype=jnp.float32)
    tcache = tm.init_paged_cache(P, ps, dtype=torch.float32, device="cpu")
    _, jcache = jm.prefill_paged(jparams, jcache, jnp.asarray(pre),
                                 jnp.asarray(lens), jnp.asarray(tables))
    tm.prefill_paged(tparams, tcache, torch.from_numpy(pre),
                     torch.from_numpy(lens), torch.from_numpy(tables))
    _pages_close(tcache, jcache)

    toks = rng.integers(4, tcfg.vocab_size, (B, c)).astype(np.int32)
    mm = rng.normal(size=(B, c, tcfg.d_model)).astype(np.float32)
    mask = np.zeros((B, c), bool)
    mask[0, 1:5] = mask[1, 0:3] = True
    valid = np.asarray([c, 6], np.int32)
    if entry == "prefill_chunk_paged":
        args = [toks, lens, valid, tables]
    else:
        args = [toks, lens, valid, tables, lens]
        if entry == "decode_step_paged":
            args.append(np.asarray([3, 2], np.int32))
    jfn = functools.partial(getattr(jm, entry), impl="kernel",
                            interpret=True)
    jout = jfn(jparams, jcache, *map(jnp.asarray, args),
               mm_embeds=jnp.asarray(mm), mm_mask=jnp.asarray(mask))
    plain_cache = {k: v.clone() for k, v in tcache.items()}
    targs = [torch.from_numpy(a) for a in args]
    tout = getattr(tm, entry)(tparams, tcache, *targs,
                              mm_embeds=torch.from_numpy(mm),
                              mm_mask=torch.from_numpy(mask))
    if entry == "chunk_forward_paged":
        (tl, tkv), (jl, jkv) = tout, jout
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=1e-5)
        for name in ("k", "v"):
            np.testing.assert_allclose(tkv[name].numpy(),
                                       np.asarray(jkv[name]), rtol=0,
                                       atol=1e-5)
        first = tl
    else:
        np.testing.assert_allclose(tout[0].numpy(), np.asarray(jout[0]),
                                   rtol=0, atol=1e-5)
        np.testing.assert_array_equal(tout[1].numpy(), np.asarray(jout[1]))
        _pages_close(tcache, jout[2])
        first = tout[0]
    plain = getattr(tm, entry)(tparams, plain_cache, *targs)[0]
    assert not torch.allclose(plain, first, atol=1e-3)  # the embeds count


@pytest.mark.parametrize("name", ["seamless-m4t-large-v2"])
def test_unported_families_raise(name):
    """encdec, the last family, is ported: ``build_model`` builds it as
    ``EncDecLM`` (at the full config too, on the meta device), and only
    ``TransformerLM`` refuses it."""
    cfg = get_smoke_config(name)
    assert cfg.family == "encdec"
    assert isinstance(build_model(cfg), EncDecLM)
    assert isinstance(build_model(get_config(name)), EncDecLM)
    assert get_config(name).param_count() > 1e9
    with pytest.raises(ValueError, match=cfg.family):
        TransformerLM(cfg)
    assert isinstance(build_model(get_config("llama4-scout-17b-a16e")),
                      TransformerLM)


# ---------------------------------------------------------------------------
# the recurrent families: the dense-slot entry points
# ---------------------------------------------------------------------------

# The recurrent SMOKE models amplify fp32 rounding: RWKV6's per-head group
# norm over 16 dims and Jamba's Mamba layers turn ulp-level differences of
# exp/tanh/rsqrt into logit differences far above them.  Each package's
# fp32 logits sit 7e-6 to 1.02e-4 from an fp64 evaluation of the same
# weights and tokens (test_recurrent_fp32_spread below, on the CPU), so a
# 1e-5 limit would hold the port to noise the reference itself carries.
# Logits, states and KV of these families are held at twice the largest
# spread measured.
RECURRENT_ATOL = 2e-4


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=RECURRENT_ATOL)


def _states_close(tstates, jstates):
    assert sorted(tstates) == sorted(jstates)
    for key, st in jstates.items():
        assert sorted(tstates[key]) == sorted(st)
        for name, v in st.items():
            _close(tstates[key][name], v)


def _slot_close(tcache, jcache):
    """Slot KV, len and states of both caches."""
    for name in ("k", "v"):
        assert (name in tcache) == (name in jcache)
        if name in jcache:
            _close(tcache[name], jcache[name])
    np.testing.assert_array_equal(tcache["len"].numpy(),
                                  np.asarray(jcache["len"]))
    _states_close(tcache["states"], jcache["states"])


def _prefilled(which):
    """Both models on the same weights, each with a slot cache (B 2, S 48)
    prefilled with a padded prompt batch of lengths 20 and 13."""
    jcfg, tcfg = (f() for f in RECURRENT_CONFIGS[which])
    jm, tm = jax_build(jcfg), build_model(tcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    rng = np.random.default_rng(11)
    lens = np.asarray([20, 13], np.int32)
    toks = rng.integers(4, tcfg.vocab_size, (2, 24)).astype(np.int32)
    jcache = jm.init_cache(2, 48, dtype=jnp.float32)
    tcache = tm.init_cache(2, 48, dtype=torch.float32, device="cpu")
    jl, jcache = jm.prefill(jparams, jnp.asarray(toks), jnp.asarray(lens),
                            jcache)
    tl, tnew = tm.prefill(tparams, torch.from_numpy(toks),
                          torch.from_numpy(lens), tcache)
    return (jm, tm, jparams, tparams, tcfg, rng, (jl, jcache),
            (tl, tcache, tnew))


@pytest.mark.parametrize("entry", ["prefill", "chunk_forward",
                                   "advance_states", "freeze", "apply"])
@pytest.mark.parametrize("which", sorted(RECURRENT_CONFIGS))
def test_dense_slot_dispatches_match_jax(which, entry):
    """Each dense-slot entry point on both sides from the same prefilled
    state (the port's own, held to the reference's first): prefill's
    logits, states, KV and len; a window's logits and KV; an advance's
    logits, states, KV and len; a freeze's KV and len; a full forward's
    logits.  The port writes its slot cache in place."""
    (jm, tm, jparams, tparams, tcfg, rng, (jl, jcache),
     (tl, tcache, tnew)) = _prefilled(which)
    ptrs = [t.data_ptr() for t in (tcache.get("k"), tcache["len"]) if
            t is not None]
    if entry == "prefill":
        _close(tl, jl)
        assert tnew["states"].keys() == tcache["states"].keys()
        _states_close(tnew["states"], jcache["states"])
        _slot_close(tcache, jcache)
        return
    _slot_close(tcache, jcache)
    B, c = 2, 8
    i32 = functools.partial(np.asarray, dtype=np.int32)
    toks = rng.integers(4, tcfg.vocab_size, (B, c)).astype(np.int32)
    start = np.asarray(tcache["len"].numpy())
    if entry in ("chunk_forward", "freeze"):
        valid = i32([c, 5])
        jl2, jkv = jm.chunk_forward(jparams, jcache, jnp.asarray(toks),
                                    jnp.asarray(start), jnp.asarray(valid))
        tl2, tkv = tm.chunk_forward(tparams, tcache, torch.from_numpy(toks),
                                    torch.from_numpy(start),
                                    torch.from_numpy(valid))
        _close(tl2, jl2)
        assert (tkv is None) == (jkv is None)
        for name in ("k", "v") if jkv is not None else ():
            _close(tkv[name], jkv[name])
        if entry == "freeze":
            n_adv = i32([3, 0])
            jcache = jm.freeze(jcache, jkv, jnp.asarray(start),
                               jnp.asarray(n_adv))
            same = tm.freeze(tcache, tkv, torch.from_numpy(start),
                             torch.from_numpy(n_adv))
            assert same is tcache
            _slot_close(tcache, jcache)
    elif entry == "advance_states":
        lens = i32([c, 3])
        jl2, jnew = jm.advance_states(jparams, jcache, jnp.asarray(toks),
                                      jnp.asarray(lens))
        tl2, tnew = tm.advance_states(tparams, tcache, torch.from_numpy(toks),
                                      torch.from_numpy(lens))
        _close(tl2, jl2)
        _states_close(tnew["states"], jnew["states"])
        tcache = {**tcache, "states": tnew["states"]}
        _slot_close(tcache, jnew)
    else:
        T = 24
        seq = rng.integers(4, tcfg.vocab_size, (B, T)).astype(np.int32)
        mode = "block_causal" if tcfg.diffusion else "causal"
        lens = i32([T, T - 5])
        jl2 = jm.apply(jparams, jnp.asarray(seq), mask_mode=mode,
                       lengths=jnp.asarray(lens))
        tl2 = tm.apply(tparams, torch.from_numpy(seq), mask_mode=mode,
                       lengths=torch.from_numpy(lens))
        _close(tl2, jl2)
    assert [t.data_ptr() for t in (tcache.get("k"), tcache["len"]) if
            t is not None] == ptrs


@pytest.mark.parametrize("mode", ["causal", "block_causal", "bidirectional"])
def test_apply_mask_modes_match_jax(mode):
    """The hybrid's full forward under each mask mode (block 1, the model's
    block, a block of T in the block-diffusion call) with a short row."""
    jcfg, tcfg = (f() for f in RECURRENT_CONFIGS["hybrid8"])
    jm, tm = jax_build(jcfg), build_model(tcfg)
    jparams = jm.init(jax.random.PRNGKey(1))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    seq = np.random.default_rng(12).integers(4, 256, (2, 20)).astype(np.int32)
    lens = np.asarray([20, 9], np.int32)
    want = jm.apply(jparams, jnp.asarray(seq), mask_mode=mode,
                    lengths=jnp.asarray(lens))
    got = tm.apply(tparams, torch.from_numpy(seq), mask_mode=mode,
                   lengths=torch.from_numpy(lens))
    _close(got, want)
    # explicit aligned positions are the default ones (the [B, 3, T] M-RoPE
    # positions of the vlm family: tests/test_torch_training.py)
    pos = torch.arange(20, dtype=torch.int64)[None].expand(2, 20)
    torch.testing.assert_close(tm.apply(
        tparams, torch.from_numpy(seq), positions=pos, mask_mode=mode,
        lengths=torch.from_numpy(lens)), got, rtol=0, atol=0)


@pytest.mark.parametrize("T,c", [(16, 8), (8, 16), (24, 8)])
def test_window_logits_equal_full_forward_hybrid(T, c):
    """tests/test_chunked_equivalence.py:42 for the hybrid on the port: a
    window against the block-aligned prefilled cache and states gives the
    full block-causal forward's logits (the reference's tolerance)."""
    cfg = ArchConfig(**HYBRID8_CFG)
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0),
                               device="cpu")
    B = 2
    tokens = torch.randint(4, cfg.vocab_size, (B, T + c),
                           generator=torch.Generator().manual_seed(1))
    full = model.apply(params, tokens, mask_mode="block_causal")
    cache = model.init_cache(B, 64, dtype=torch.float32, device="cpu")
    model.prefill(params, tokens[:, :T], torch.full((B,), T), cache)
    lg, _ = model.chunk_forward(params, cache, tokens[:, T:], cache["len"],
                                torch.full((B,), c))
    torch.testing.assert_close(lg, full[:, T:], rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("which", ["rwkv6_smoke", "jamba_smoke"])
def test_recurrent_fp32_spread(which, monkeypatch):
    """RECURRENT_ATOL's measurement: the reference's and the port's fp32
    logits of one full forward (B 2, T 24) against the port's fp64
    evaluation of the same weights and tokens (every ``.float()`` of the
    port made fp64 for this run).  Both sit within the limit; the spread
    is what it is, whichever package is nearer the fp64 result."""
    jcfg, tcfg = (f() for f in RECURRENT_CONFIGS[which])
    jm, tm = jax_build(jcfg), build_model(tcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    toks = np.random.default_rng(11).integers(
        4, tcfg.vocab_size, (2, 24)).astype(np.int32)
    mode = "block_causal" if tcfg.diffusion else "causal"
    ref = np.asarray(jm.apply(jparams, jnp.asarray(toks), mask_mode=mode))
    port = tm.apply(tparams, torch.from_numpy(toks), mask_mode=mode).numpy()
    with monkeypatch.context() as mp:
        mp.setattr(torch.Tensor, "float", lambda self: self.double())
        m64 = build_model(tcfg.replace(param_dtype="float64",
                                       compute_dtype="float64"))
        exact = m64.apply({k: v.double() for k, v in tparams.items()},
                          torch.from_numpy(toks), mask_mode=mode)
    assert exact.dtype == torch.float64
    exact = exact.numpy()
    ref_err, port_err = (float(np.abs(a - exact).max()) for a in (ref, port))
    print(f"{which}: fp32 vs fp64 logits, reference {ref_err:.3e}, port "
          f"{port_err:.3e}")
    assert ref_err < RECURRENT_ATOL and port_err < RECURRENT_ATOL
