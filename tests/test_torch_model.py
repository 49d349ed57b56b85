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
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import (ArchConfig, TransformerLM, build_model,
                                params_from_jax)
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
    ptr = tcache["k_pages"].data_ptr(), tcache["v_pages"].data_ptr()
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
    assert (tcache["k_pages"].data_ptr(),
            tcache["v_pages"].data_ptr()) == ptr


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
    ptr = tcache["k_pages"].data_ptr(), tcache["v_pages"].data_ptr()
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
    assert (tcache["k_pages"].data_ptr(),
            tcache["v_pages"].data_ptr()) == ptr


def test_param_layout_and_count_match_jax():
    """The port's own init has the bridged layout (names, shapes, dtypes),
    and the meta-device count equals the JAX abstract count."""
    jcfg = jax_smoke("sdar-8b")
    jparams = jax_build(jcfg).init(jax.random.PRNGKey(0))
    bridged = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    tm = build_model(get_smoke_config("sdar-8b"))
    own = tm.init_params(torch.Generator().manual_seed(0), device="cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in own.items()} == \
        {k: (tuple(v.shape), v.dtype) for k, v in bridged.items()}
    for name in ("sdar-8b", "smollm-135m", "llama3.2-1b",
                 "llama4-scout-17b-a16e", "kimi-k2-1t-a32b", "qwen2-vl-2b"):
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


@pytest.mark.parametrize("name", ["rwkv6-1.6b", "jamba-1.5-large-398b",
                                  "seamless-m4t-large-v2"])
def test_unported_families_raise(name):
    """ssm, hybrid and encdec are not ported: building them raises."""
    cfg = get_smoke_config(name)
    assert cfg.family in ("ssm", "hybrid", "encdec")
    with pytest.raises(NotImplementedError, match=cfg.family):
        build_model(cfg)
    with pytest.raises(NotImplementedError, match=cfg.family):
        TransformerLM(cfg)
    assert isinstance(build_model(get_config("llama4-scout-17b-a16e")),
                      TransformerLM)
