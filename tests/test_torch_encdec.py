"""The port's encoder–decoder model (``models/encdec.py``) against the JAX
package's ``EncDecLM`` on the SeamlessM4T SMOKE config, with the weights
carried across by ``params_from_jax``: ``encode``; ``admit`` →
``chunk_forward`` → ``freeze`` (the sequence of tests/test_arch_smoke.py's
decode step) for 3 teacher-forced windows; ``apply`` with block-causal and
causal masks.  Each under both routes on the CPU (``impl="kernel"`` runs
the kernels' plain versions there, ``impl="ref"`` the reference's
``flash_partial``), within 1e-5 absolute in fp32.  A source mask that is
not a prefix raises under the kernel route and matches under ``ref``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import build_model as jax_build
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import EncDecLM, build_model, params_from_jax

ARCH = "seamless-m4t-large-v2"
ATOL = 1e-5
B, S_SRC, MAX_LEN, C = 2, 16, 64, 8
SRC_LENS = [16, 7]


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=ATOL)


@pytest.fixture(scope="module")
def models():
    jm, tm = jax_build(jax_smoke(ARCH)), build_model(get_smoke_config(ARCH))
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def _src(d_model, lens=SRC_LENS, seed=0):
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(B, S_SRC, d_model)).astype(np.float32)
    mask = np.arange(S_SRC)[None, :] < np.asarray(lens)[:, None]
    return emb, mask


def test_builds_and_counts_like_the_reference(models):
    jm, jp, tm, tp = models
    assert isinstance(tm, EncDecLM)
    assert sorted(tp) == sorted(
        "/".join(str(k.key) for k in path)
        for path, _ in jax.tree_util.tree_flatten_with_path(jp)[0])
    assert sum(t.numel() for t in tp.values()) == tm.cfg.param_count()
    full = get_config(ARCH)
    assert isinstance(build_model(full), EncDecLM)
    assert full.param_count() == 1_632_131_072


@pytest.mark.parametrize("impl", ["kernel", "ref"])
def test_encode_matches_jax(models, impl):
    jm, jp, tm, tp = models
    emb, mask = _src(tm.cfg.d_model)
    want = jm.encode(jp, jnp.asarray(emb), jnp.asarray(mask))
    got = tm.encode(tp, torch.from_numpy(emb), torch.from_numpy(mask),
                    impl=impl)
    _close(got, want)


def _windows(jm, jp, tm, tp, emb, mask, impl):
    """admit, then 3 teacher-forced windows of chunk_forward + freeze on
    both sides; compares every output and the caches."""
    cfg = tm.cfg
    jcache = jm.init_cache(B, MAX_LEN, S_SRC, dtype=jnp.float32)
    jcache = jm.admit(jp, jcache, jnp.asarray(emb), jnp.asarray(mask))
    tcache = tm.init_cache(B, MAX_LEN, S_SRC, dtype=torch.float32,
                           device="cpu")
    ptrs = [tcache[n].data_ptr() for n in ("k", "v", "cross_k", "cross_v")]
    assert tm.admit(tp, tcache, torch.from_numpy(emb),
                    torch.from_numpy(mask), impl=impl) is tcache
    for name in ("cross_k", "cross_v"):
        _close(tcache[name], jcache[name])
    rng = np.random.default_rng(1)
    for n_adv, valid in (([8, 3], [8, 8]), ([2, 8], [8, 6]), ([5, 1],
                                                              [7, 8])):
        win = np.full((B, C), cfg.mask_token_id, np.int32)
        win[:, :2] = rng.integers(4, cfg.vocab_size, (B, 2))
        start = np.array(jcache["len"])
        a = [win, start, np.asarray(valid, np.int32)]
        jl, jkv = jm.chunk_forward(jp, jcache, *map(jnp.asarray, a))
        tl, tkv = tm.chunk_forward(tp, tcache, *(torch.from_numpy(
            np.asarray(x)).long() for x in a), impl=impl)
        _close(tl, jl)
        for name in ("k", "v"):
            _close(tkv[name], jkv[name])
        n = np.asarray(n_adv, np.int32)
        jcache = jm.freeze(jcache, jkv, jnp.asarray(start), jnp.asarray(n))
        tm.freeze(tcache, tkv, torch.from_numpy(start), torch.from_numpy(n))
        np.testing.assert_array_equal(tcache["len"].numpy(),
                                      np.asarray(jcache["len"]))
        for name in ("k", "v"):
            _close(tcache[name], jcache[name])
    assert ptrs == [tcache[n].data_ptr()
                    for n in ("k", "v", "cross_k", "cross_v")]


@pytest.mark.parametrize("impl", ["kernel", "ref"])
def test_serving_windows_match_jax(models, impl):
    jm, jp, tm, tp = models
    _windows(jm, jp, tm, tp, *_src(tm.cfg.d_model), impl)


@pytest.mark.parametrize("mask_mode", ["block_causal", "causal"])
def test_apply_matches_jax(models, mask_mode):
    jm, jp, tm, tp = models
    emb, mask = _src(tm.cfg.d_model, seed=2)
    T = 20
    tgt = np.random.default_rng(3).integers(
        4, tm.cfg.vocab_size, (B, T)).astype(np.int32)
    lens = np.asarray([20, 13], np.int32)
    want = jm.apply(jp, jnp.asarray(emb), jnp.asarray(mask), jnp.asarray(tgt),
                    mask_mode=mask_mode, tgt_lengths=jnp.asarray(lens))
    got = tm.apply(tp, torch.from_numpy(emb), torch.from_numpy(mask),
                   torch.from_numpy(tgt), mask_mode=mask_mode,
                   tgt_lengths=torch.from_numpy(lens))
    _close(got, want)


def test_non_prefix_src_mask(models):
    """A source mask with holes: the kernel route reads keys < length, so
    admission refuses it; the ref route runs the reference's flash over
    the mask and matches it window by window."""
    jm, jp, tm, tp = models
    emb, mask = _src(tm.cfg.d_model, seed=4)
    mask[1, 2] = False
    cache = tm.init_cache(B, MAX_LEN, S_SRC, dtype=torch.float32,
                          device="cpu")
    with pytest.raises(ValueError, match="prefix"):
        tm.admit(tp, cache, torch.from_numpy(emb), torch.from_numpy(mask),
                 impl="kernel")
    tm.admit(tp, cache, torch.from_numpy(emb), torch.from_numpy(mask),
             impl="ref")
    win = torch.full((B, C), tm.cfg.mask_token_id)
    with pytest.raises(ValueError, match="prefix"):
        tm.chunk_forward(tp, cache, win, cache["len"].long(),
                         torch.full((B,), C), impl="kernel")
    _windows(jm, jp, tm, tp, emb, mask, "ref")
