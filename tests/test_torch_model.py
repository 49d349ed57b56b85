"""The port's paged transformer against the JAX package's, per dispatch,
under teacher forcing: the same bridged weights and the same window tokens
go through ``prefill_chunk_paged`` and ``decode_step_paged`` on both sides,
and the same admission wave through ``prefill_paged``.

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
from repro_torch.configs import get_smoke_config
from repro_torch.models import ArchConfig, build_model, params_from_jax

# tests/test_paged_backend.py's config
PAGED_CFG = dict(name="t", family="dense", n_layers=2, d_model=64, n_heads=4,
                 n_kv_heads=2, d_ff=128, vocab_size=256, block_size=8,
                 confidence_threshold=0.6)
CONFIGS = {
    "sdar8b_smoke": (lambda: jax_smoke("sdar-8b"),
                     lambda: get_smoke_config("sdar-8b")),
    "paged_backend": (lambda: JaxArchConfig(**PAGED_CFG),
                      lambda: ArchConfig(**PAGED_CFG)),
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
    for name in ("sdar-8b", "smollm-135m", "llama3.2-1b"):
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
