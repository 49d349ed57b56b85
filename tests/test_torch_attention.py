"""The port's differentiable attention paths against the JAX package's, on
the same inputs (numpy, seeded) in fp32: ``sdpa``, ``flash_partial`` (kinds
all, causal and block_causal; ragged ``k_valid``; T and S not multiples of
their chunks), ``flash_partial_aligned`` (aligned, and its fallback to
``flash_partial`` when T is not a multiple of the chunk) and
``attention_block``; and the gradients of the flash scans (each step under
``torch.utils.checkpoint``) against ``jax.grad``.

Tolerance: 2e-5, relative and absolute (tests/test_kernels.py:13), for
values and gradients — the two frameworks sum in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import layers as jl
from repro.models.common import KeyGen
from repro_torch.configs import get_smoke_config
from repro_torch.models import layers as tl
from repro_torch.models import params_from_jax

TOL = dict(rtol=2e-5, atol=2e-5)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def _qkv(B, T, S, H, KVH, D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, T, H, D)).astype(np.float32),
            rng.normal(size=(B, S, KVH, D)).astype(np.float32),
            rng.normal(size=(B, S, KVH, D)).astype(np.float32))


def _t(*arrs):
    return [torch.from_numpy(np.asarray(a)) for a in arrs]


def test_sdpa_matches_jax():
    B, T, S, H, KVH, D = 2, 12, 20, 4, 2, 16
    q, k, v = _qkv(B, T, S, H, KVH, D)
    rng = np.random.default_rng(1)
    mask = rng.random((B, 1, T, S)) < 0.7
    mask[:, :, :, 0] = True
    want = jl.sdpa(*map(jnp.asarray, (q, k, v, mask)))
    _close(tl.sdpa(*_t(q, k, v, mask)), want)


FLASH_CASES = {
    # kind, B, T, S, H, KVH, D, q_chunk, kv_chunk, block
    "all_ragged": ("all", 2, 20, 37, 4, 2, 8, 8, 16, 0),
    "causal": ("causal", 2, 24, 24, 4, 1, 16, 16, 8, 0),
    "block_causal": ("block_causal", 3, 30, 30, 6, 2, 8, 16, 16, 8),
    "one_chunk": ("block_causal", 1, 16, 16, 2, 2, 8, 512, 1024, 4),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_partial_matches_jax(case):
    kind, B, T, S, H, KVH, D, qc, kc, bs = FLASH_CASES[case]
    q, k, v = _qkv(B, T, S, H, KVH, D, seed=2)
    rng = np.random.default_rng(3)
    q_pos = np.broadcast_to(np.arange(T), (B, T)).astype(np.int32)
    k_pos = np.broadcast_to(np.arange(S), (B, S)).astype(np.int32)
    k_valid = rng.random((B, S)) < 0.8
    k_valid[0] = np.arange(S) < 5                      # a short prefix row
    kw = dict(kind=kind, block_size=bs, q_chunk=qc, kv_chunk=kc)
    want = jl.flash_partial(*map(jnp.asarray, (q, k, v)),
                            q_pos=jnp.asarray(q_pos), k_pos=jnp.asarray(k_pos),
                            k_valid=jnp.asarray(k_valid), **kw)
    tq_pos, tk_pos, tk_valid = _t(q_pos, k_pos, k_valid)
    got = tl.flash_partial(*_t(q, k, v), q_pos=tq_pos.long(),
                           k_pos=tk_pos.long(), k_valid=tk_valid, **kw)
    for g, w in zip(got, want):
        _close(g, w)


ALIGNED_CASES = {
    # kind, B, T, H, KVH, D, block, chunk, lengths
    "block_causal": ("block_causal", 2, 48, 4, 2, 8, 8, 16, [48, 21]),
    "causal": ("causal", 2, 32, 4, 4, 16, 0, 8, [32, 1]),
    "chunk_cut_to_block": ("block_causal", 1, 36, 2, 1, 8, 12, 16, [30]),
    "fallback_ragged_T": ("block_causal", 2, 44, 4, 2, 8, 8, 16, [44, 9]),
}


@pytest.mark.parametrize("case", sorted(ALIGNED_CASES))
def test_flash_partial_aligned_matches_jax(case):
    kind, B, T, H, KVH, D, bs, chunk, lens = ALIGNED_CASES[case]
    q, k, v = _qkv(B, T, T, H, KVH, D, seed=4)
    lens = np.asarray(lens, np.int32)
    kw = dict(kind=kind, block_size=bs, chunk=chunk)
    want = jl.flash_partial_aligned(*map(jnp.asarray, (q, k, v)),
                                    lengths=jnp.asarray(lens), **kw)
    got = tl.flash_partial_aligned(*_t(q, k, v),
                                   lengths=torch.from_numpy(lens), **kw)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("fn", ["flash_partial", "flash_partial_aligned"])
def test_flash_gradients_match_jax(fn):
    """Gradients through the checkpointed online-softmax steps (several q
    and KV chunks) against ``jax.grad`` of the same function."""
    B, T, H, KVH, D, bs = 2, 24, 4, 2, 8, 4
    q, k, v = _qkv(B, T, T, H, KVH, D, seed=5)
    w = np.random.default_rng(6).normal(size=(B, T, H, D)).astype(np.float32)
    lens = np.asarray([24, 10], np.int32)
    pos = np.broadcast_to(np.arange(T), (B, T))

    def loss(mod, q, k, v, w, ln, pos, xp):
        if fn == "flash_partial":
            part = mod.flash_partial(q, k, v, q_pos=pos, k_pos=pos,
                                     k_valid=pos < ln[:, None],
                                     kind="block_causal", block_size=bs,
                                     q_chunk=8, kv_chunk=8)
        else:
            part = mod.flash_partial_aligned(q, k, v, lengths=ln,
                                             kind="block_causal",
                                             block_size=bs, chunk=8)
        out = mod.combine_partials([part], q.dtype)
        return xp.sum(out * w)

    want = jax.grad(lambda *a: loss(jl, *a, jnp.asarray(lens),
                                    jnp.asarray(pos), jnp), argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v, w)))
    tq, tk, tv, tw = _t(q, k, v, w)
    for t in (tq, tk, tv):
        t.requires_grad_()
    got = torch.autograd.grad(
        loss(tl, tq, tk, tv, tw, torch.from_numpy(lens),
             torch.from_numpy(np.ascontiguousarray(pos)).long(), torch),
        (tq, tk, tv))
    for g, wnt in zip(got, want):
        _close(g, wnt)


def test_attention_block_matches_jax():
    jcfg, tcfg = jax_smoke("sdar-8b"), get_smoke_config("sdar-8b")
    jp = jl.init_attention(KeyGen(jax.random.PRNGKey(0)), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    B, T = 2, 10
    rng = np.random.default_rng(7)
    x = rng.normal(size=(B, T, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(T), (B, T)).astype(np.int32)
    mask = np.array(jl.block_causal_mask(jnp.asarray(pos),
                                         jnp.asarray(pos), 4))[:, None]
    jy, (jk, jv) = jl.attention_block(jp, jcfg, jnp.asarray(x),
                                      jnp.asarray(pos), jnp.asarray(mask))
    ty, (tk, tv) = tl.attention_block(tp, tcfg, *_t(x), torch.from_numpy(
        np.ascontiguousarray(pos)).long(), torch.from_numpy(mask))
    for g, w in ((ty, jy), (tk, jk), (tv, jv)):
        _close(g, w)
