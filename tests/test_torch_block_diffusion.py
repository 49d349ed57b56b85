"""The port's block-diffusion attention against the JAX package: the plain
version (what a CPU tensor runs) vs the Pallas kernel in interpret mode on
``BD_SHAPES`` and on the edges wave prefill gives it (causal block 1, T not
a multiple of the block, a ``lengths = 0`` padding row), and vs the
reference's production wave-prefill path (``flash_partial_aligned`` +
``combine_partials``).

Tolerances as tests/test_kernels.py:13-14: 2e-5 (rtol and atol) in fp32,
where the two sides sum in another order; 3e-2 in bf16, where the Pallas
kernel rounds the probabilities to bf16 before PV and the plain version
does not.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.layers import combine_partials, flash_partial_aligned
from repro_torch.kernels import block_diffusion_attn as bda
from repro_torch.kernels import ops as tops

BD_SHAPES = [
    # B, T, H, KVH, D, block, q_tile, kv_tile  (tests/test_kernels.py)
    (1, 64, 2, 1, 64, 8, 32, 32),
    (2, 128, 4, 2, 64, 32, 64, 64),
    (2, 256, 4, 4, 128, 32, 128, 128),
    (1, 96, 3, 1, 64, 32, 32, 32),
]
EDGE_SHAPES = {
    # B, T, H, KVH, D, block, q_tile, kv_tile, lengths
    "causal_block1": (3, 64, 4, 2, 16, 1, 16, 16, [64, 0, 37]),
    "T_not_multiple_of_block": (2, 40, 4, 1, 8, 16, 8, 8, [40, 0]),
    "prompt_under_block": (3, 24, 4, 2, 8, 8, 8, 8, [5, 0, 24]),
}


def _tol(dtype):
    return 2e-5 if dtype == "float32" else 3e-2


def _inputs(B, T, H, KVH, D, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, T, H, D)).astype(np.float32)
    k = rng.normal(size=(B, T, KVH, D)).astype(np.float32)
    v = rng.normal(size=(B, T, KVH, D)).astype(np.float32)
    return q, k, v


def _both(q, k, v, lens, bs, qt, kt, dtype):
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    jargs = [jnp.asarray(a, jd) for a in (q, k, v)] + \
        [jnp.asarray(lens, jnp.int32)]
    want = jops.block_diffusion_attention(*jargs, block_size=bs, q_tile=qt,
                                          kv_tile=kt, interpret=True)
    want_ref = jref.block_diffusion_ref(*jargs, block_size=bs)
    targs = [torch.from_numpy(a).to(td) for a in (q, k, v)] + \
        [torch.as_tensor(lens, dtype=torch.int32)]
    got = tops.block_diffusion_attention(*targs, block_size=bs)
    assert got.dtype == td and tuple(got.shape) == q.shape
    return (got.float().numpy(), np.asarray(want, np.float32),
            np.asarray(want_ref, np.float32))


@pytest.mark.parametrize("shape", BD_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_diffusion_matches_pallas(shape, dtype):
    """Every row, including rows past ``lengths[b]``, which both sides
    compute under the same mask."""
    B, T, H, KVH, D, bs, qt, kt = shape
    q, k, v = _inputs(B, T, H, KVH, D, seed=42)
    lens = np.random.default_rng(1).integers(bs, T + 1, B)
    before = bda.LAUNCHES
    got, want, want_ref = _both(q, k, v, lens, bs, qt, kt, dtype)
    assert bda.LAUNCHES == before        # CPU tensors never launch
    tol = _tol(dtype)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    np.testing.assert_allclose(got, want_ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("case", sorted(EDGE_SHAPES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_diffusion_edges_match_pallas(case, dtype):
    """Causal (block 1), T not a multiple of the block, a prompt shorter
    than the block, and a ``lengths = 0`` row, which gives exactly 0 on
    both sides (never NaN)."""
    B, T, H, KVH, D, bs, qt, kt, lens = EDGE_SHAPES[case]
    q, k, v = _inputs(B, T, H, KVH, D, seed=7)
    got, want, want_ref = _both(q, k, v, np.asarray(lens), bs, qt, kt, dtype)
    assert np.isfinite(got).all()
    tol = _tol(dtype)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    np.testing.assert_allclose(got, want_ref, rtol=tol, atol=tol)
    for b, n in enumerate(lens):
        if n == 0:
            assert (got[b] == 0).all() and (want[b] == 0).all()


@pytest.mark.parametrize("kind, bs, T", [
    ("block_causal", 32, 128),
    ("block_causal", 8, 1024),     # two 512-row chunks in the reference
    ("causal", 1, 96),
])
def test_block_diffusion_matches_reference_wave_path(kind, bs, T):
    """The plain version against what the reference's ``prefill_paged``
    runs per layer: ``flash_partial_aligned`` normalised by
    ``combine_partials``, with a ragged length and a padding row."""
    B, H, KVH, D = 3, 4, 2, 16
    q, k, v = _inputs(B, T, H, KVH, D, seed=3)
    lens = np.asarray([T, T - 17, 0])
    parts = flash_partial_aligned(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        lengths=jnp.asarray(lens, jnp.int32), kind=kind,
        block_size=bs if kind == "block_causal" else 8)
    want = np.asarray(combine_partials([parts], jnp.float32))
    got = bda.block_diffusion_attention(
        *(torch.from_numpy(a) for a in (q, k, v)),
        torch.as_tensor(lens, dtype=torch.int32), block_size=bs).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    assert (got[2] == 0).all()


def test_block_diffusion_kernel_refuses_cpu_input():
    """The kernel entry point takes CUDA tensors only — it raises rather
    than running anything else."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 8, 2, 1, 8, seed=0))
    with pytest.raises(ValueError, match="CUDA"):
        bda.block_diffusion_attention_kernel(
            q, k, v, torch.tensor([8], dtype=torch.int32), block_size=4)


def test_chip_smoke_bd_bound_counts_live_work():
    """chip_smoke.py's least time for the block-diffusion kernel at shape
    (e) (B 8, T 512, H 32/8, D 128, block 32, bf16): q of the 7 rows that
    see a key, the 2,443 live K/V rows, lengths and the whole output over
    3.35 TB/s (21.77 µs), above 4·D·H·Σ visible = 12.98 GFLOP over
    989 TFLOP/s (13.1 µs)."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from chip_smoke import bd_bound, bd_visible
    # every prompt at 512: 16 blocks of 32 rows seeing 32·i keys
    assert bd_visible(512, 32, [512] * 8) == 8 * 32 * 32 * 136
    assert bd_visible(4, 1, [4]) == 1 + 2 + 3 + 4          # causal
    assert bd_visible(3, 8, [2, 0]) == 3 * 2               # prompt < block
    lens = [512, 0, 130, 257, 384, 449, 200, 511]
    ms, by = bd_bound(8, 512, 32, 8, 128, 32, "bfloat16", lens)
    assert by == "bytes"
    assert ms * 1e3 == pytest.approx(21.77, abs=0.01)
    ops_us = 4.0 * 128 * 32 * bd_visible(512, 32, lens) / 989e12 * 1e6
    assert ops_us == pytest.approx(13.12, abs=0.01)
