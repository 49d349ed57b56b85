"""The port's kernel module against the JAX package: the plain
chunked-paged-attention path (what a CPU tensor runs) vs the Pallas kernel
in interpret mode and its jnp oracle, plus the partial merge and the
device sampling op.

Tolerances: fp32 as tests/test_kernels.py (m within rtol 1e-5 / atol 1e-4,
acc max relative error < 2e-5, l rtol 2e-5) — the two sides sum in another
order; bf16 3e-2 relative (the kernel rounds the probabilities to bf16
before PV, the oracle does not).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import chunked_paged_attn as cpa
from repro_torch.kernels import ops as tops

PAGED_SHAPES = [
    # B, c, H, KVH, D, page_size, n_slots  (tests/test_kernels.py)
    (1, 2, 2, 1, 64, 16, 4),
    (2, 8, 4, 2, 64, 16, 8),
    (2, 16, 8, 2, 128, 16, 4),
    (3, 32, 6, 3, 64, 8, 16),
    (2, 1, 4, 4, 128, 32, 2),
]


def _tol(dtype):
    return 2e-5 if dtype == "float32" else 3e-2


def _inputs(shape, seed, lens=None):
    B, c, H, KVH, D, ps, n_slots = shape
    rng = np.random.default_rng(seed)
    P = B * n_slots + 3
    q = rng.normal(size=(B, c, H, D)).astype(np.float32)
    kp = rng.normal(size=(P, ps, KVH, D)).astype(np.float32)
    vp = rng.normal(size=(P, ps, KVH, D)).astype(np.float32)
    tables = rng.permutation(P)[:B * n_slots].reshape(B, n_slots) \
        .astype(np.int32)
    if lens is None:
        lens = rng.integers(1, ps * n_slots, B)
    return q, kp, vp, tables, np.asarray(lens, np.int32)


def _torch(*arrs, dtype=torch.float32):
    out = []
    for a in arrs:
        t = torch.from_numpy(a)
        out.append(t.to(dtype) if t.is_floating_point() else t)
    return out


def _compare(got, want, dtype):
    acc, m, l = (np.asarray(x, np.float32) for x in got)
    acc_r, m_r, l_r = (np.asarray(x, np.float32) for x in want)
    np.testing.assert_allclose(m, m_r, rtol=1e-5, atol=1e-4)
    rel = float(np.max(np.abs(acc - acc_r))) / \
        (float(np.max(np.abs(acc_r))) + 1e-9)
    assert rel < _tol(dtype), rel
    np.testing.assert_allclose(l, l_r, rtol=_tol(dtype), atol=1e-5)


@pytest.mark.parametrize("shape", PAGED_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_chunk_attention_matches_pallas(shape, dtype):
    q, kp, vp, tables, lens = _inputs(shape, seed=11)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    jargs = [jnp.asarray(a, jd) for a in (q, kp, vp)] + \
        [jnp.asarray(tables), jnp.asarray(lens)]
    want_kernel = jops.paged_chunk_attention(*jargs, interpret=True)
    want_ref = jref.paged_chunk_ref(*jargs)
    got = cpa.paged_chunk_attention(*_torch(q, kp, vp, tables, lens,
                                            dtype=td))
    assert all(t.dtype == torch.float32 for t in got)
    _compare(got, want_kernel, dtype)
    _compare(got, want_ref, dtype)


def test_paged_chunk_attention_empty_rows_and_small_head_dim():
    """ctx 0 rows emit the empty partial (acc 0, m -1e30, l 0) exactly as
    the Pallas init values; D = 8 is the sdar-8b SMOKE head_dim."""
    shape = (3, 4, 4, 2, 8, 16, 3)
    q, kp, vp, tables, lens = _inputs(shape, seed=5, lens=[0, 17, 48])
    jargs = [jnp.asarray(a) for a in (q, kp, vp, tables, lens)]
    want = jops.paged_chunk_attention(*jargs, interpret=True)
    acc, m, l = cpa.paged_chunk_attention(*_torch(q, kp, vp, tables, lens))
    _compare((acc, m, l), want, "float32")
    assert torch.all(acc[0] == 0) and torch.all(l[0] == 0)
    assert torch.all(m[0] == -1e30)
    assert cpa.LAUNCHES == 0          # CPU tensors never launch the kernel


def test_paged_chunk_attention_cuda_path_refuses_cpu_input():
    """The kernel entry point takes CUDA tensors only — it raises rather
    than running anything else."""
    q, kp, vp, tables, lens = _torch(*_inputs(PAGED_SHAPES[0], seed=1))
    with pytest.raises(ValueError, match="CUDA"):
        cpa.paged_chunk_attention_kernel(q, kp, vp, tables, lens)


def test_combine_flash_partials_with_empty_partial():
    """An empty paged partial (ctx 0) merged with a live in-window partial
    gives the in-window result, with no NaN — the finite -1e30 sentinel."""
    rng = np.random.default_rng(3)
    B, c, H, D = 2, 4, 4, 8
    acc_w = rng.normal(size=(B, c, H, D)).astype(np.float32)
    m_w = rng.normal(size=(B, c, H)).astype(np.float32)
    l_w = rng.uniform(0.5, 2.0, size=(B, c, H)).astype(np.float32)
    empty = (np.zeros((B, c, H, D), np.float32),
             np.full((B, c, H), -1e30, np.float32),
             np.zeros((B, c, H), np.float32))
    parts = [empty, (acc_w, m_w, l_w)]
    want = jops.combine_flash_partials(
        [tuple(jnp.asarray(x) for x in p) for p in parts])
    got = tops.combine_flash_partials(
        [tuple(torch.from_numpy(x) for x in p) for p in parts])
    assert not torch.isnan(got).any()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(got.numpy(), acc_w / l_w[..., None],
                               rtol=1e-6, atol=1e-6)
    # both partials empty (a padded row with no window either): finite 0
    both = tops.combine_flash_partials(
        [tuple(torch.from_numpy(x) for x in empty)] * 2)
    assert torch.all(both == 0)


def test_softmax_confidence_device_ties_and_values():
    """Exact ties break at the first maximal index on both sides; conf is
    fp32 within 1e-6 and tok int32."""
    rng = np.random.default_rng(7)
    logits = rng.normal(size=(3, 5, 64)).astype(np.float32)
    logits[0, 0, [4, 9, 30]] = 10.0          # three-way tie
    logits[1, 2, [0, 63]] = 7.5               # tie at both ends
    logits[2, 4, :] = 1.0                     # all equal
    cj, tj = jops.softmax_confidence_device(jnp.asarray(logits))
    ct, tt = tops.softmax_confidence_device(torch.from_numpy(logits))
    assert ct.dtype == torch.float32 and tt.dtype == torch.int32
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
    assert tt[0, 0] == 4 and tt[1, 2] == 0 and tt[2, 4] == 0
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("ctx, bound_us", [
    ([2048] * 8, 21.93),                          # every key live
    ([0, 1, 15, 16, 17, 2048, 700, 1333], 6.95),  # live keys only
])
def test_chip_smoke_bound_counts_live_bytes(ctx, bound_us):
    """chip_smoke.py's least time for the SDAR-8B decode shape (B 8, c 32,
    H 32, KVH 8, D 128, page 16, bf16): the bytes of q, the live K/V rows,
    the live table entries and the fp32 outputs over 3.35 TB/s, which is
    above 4·Σctx·c·H·D operations over 989 TFLOP/s (8.7 µs at ctx 2048)."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from chip_smoke import bound
    ms, by = bound(8, 32, 32, 8, 128, 16, "bfloat16", ctx)
    assert by == "bytes"
    assert ms * 1e3 == pytest.approx(bound_us, abs=0.01)
    ops_us = 4.0 * sum(ctx) * 32 * 32 * 128 / 989e12 * 1e6
    assert ops_us < ms * 1e3
