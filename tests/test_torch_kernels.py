"""The port's kernel module against the JAX package: the plain
chunked-paged-attention path (what a CPU tensor runs) vs the Pallas kernel
in interpret mode and its jnp oracle, the plain split-KV version (the
tensor-core kernel's cut of each row into splits, then the merge), the
wrapper's split choice, the partial merge, the build's cache key and the
device sampling op.

Tolerances: fp32 as tests/test_kernels.py (m within rtol 1e-5 / atol 1e-4,
acc max relative error < 2e-5, l rtol 2e-5) — the two sides sum in another
order; bf16 3e-2 relative (the kernel rounds the probabilities to bf16
before PV, the oracle does not).
"""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import build
from repro_torch.kernels import chunked_paged_attn as cpa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

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


# PAGED_SHAPES, whose tables hold one or two 64-key tiles, and one whose
# table holds ten, so seven splits leave some live and some empty
SPLIT_SHAPES = PAGED_SHAPES + [(2, 4, 8, 2, 64, 16, 40)]


@pytest.mark.parametrize("splits", [1, 2, 7])
@pytest.mark.parametrize("shape", SPLIT_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_chunk_split_ref_matches_pallas(shape, dtype, splits):
    """The plain split-KV version (each row's live keys cut into S equal
    64-key-aligned parts, as the tensor-core kernel cuts them, then merged)
    against the Pallas kernel in interpret mode and against the unsplit
    plain version.  Row 0 has ctx 0 and must be the exact empty partial;
    row 1 is shorter than S tiles (5 keys), so its later splits are empty."""
    B, c, H, KVH, D, ps, n_slots = shape
    rng = np.random.default_rng(29)
    lens = rng.integers(1, ps * n_slots + 1, B)
    lens[0] = 0
    if B > 1:
        lens[1] = 5
    q, kp, vp, tables, lens = _inputs(shape, seed=29, lens=lens)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    jargs = [jnp.asarray(a, jd) for a in (q, kp, vp)] + \
        [jnp.asarray(tables), jnp.asarray(lens)]
    targs = _torch(q, kp, vp, tables, lens, dtype=td)
    got = tref.paged_chunk_split_ref(*targs, splits=splits)
    acc, m, l = got
    assert all(t.dtype == torch.float32 for t in got)
    _compare(got, jops.paged_chunk_attention(*jargs, interpret=True), dtype)
    _compare(got, tref.paged_chunk_ref(*targs), dtype)
    assert torch.all(acc[0] == 0) and torch.all(l[0] == 0)
    assert torch.all(m[0] == -1e30)


def test_paged_chunk_ref_rounds_p_only_when_asked():
    """``p_dtype`` rounds the probabilities before PV as the Pallas body
    does (``e.astype(v.dtype)``): float32 changes nothing, bf16 moves acc by
    at most bf16 rounding of P, and m and l never move."""
    q, kp, vp, tables, lens = _torch(*_inputs(PAGED_SHAPES[2], seed=13))
    acc, m, l = tref.paged_chunk_ref(q, kp, vp, tables, lens)
    same = tref.paged_chunk_ref(q, kp, vp, tables, lens,
                                p_dtype=torch.float32)
    assert all(torch.equal(a, b) for a, b in zip((acc, m, l), same))
    acc_b, m_b, l_b = tref.paged_chunk_ref(q, kp, vp, tables, lens,
                                           p_dtype=torch.bfloat16)
    assert torch.equal(m_b, m) and torch.equal(l_b, l)
    assert not torch.equal(acc_b, acc)
    # |Σ (p - bf16(p)) v| <= 2^-9 Σ p |v| <= 2^-9 l max|v|
    bound = 2 ** -9 * float(vp.abs().max()) * float(l.max())
    assert float((acc_b - acc).abs().max()) <= bound * 1.001


@pytest.mark.parametrize("splits", [1, 2, 3, 7, 16])
def test_split_ranges_cut_tile_aligned_equal_parts(splits):
    """Every row's live keys are covered once, in order, by the splits'
    ranges; each range starts on a 64-key tile and all but the last live
    one hold ceil(tiles / S) tiles."""
    n_keys = 700
    ctx = torch.tensor([0, 1, 64, 65, 300, 640, 700, 5000])
    ranges = tref.split_ranges(ctx, n_keys, splits)
    assert len(ranges) == splits
    for b, n in enumerate(torch.clamp(ctx, max=n_keys).tolist()):
        tiles = -(-n // 64)
        per = -(-tiles // splits)
        covered = []
        for lo, hi in ranges:
            lo_b, hi_b = int(lo[b]), int(hi[b])
            assert lo_b % 64 == 0
            if hi_b > lo_b:
                assert hi_b - lo_b <= per * 64
                covered.extend(range(lo_b, hi_b))
        assert covered == list(range(n))


def test_pick_splits_is_a_function_of_shapes():
    """The tensor-core body's split count comes from shapes alone — plain
    ints in, an int out, no tensor anywhere — and fills the card in whole
    waves: about 2 x 132 blocks at the SDAR-8B decode shape (B 8, KVH 8,
    one 8-warp row tile of G·c = 128 rows, one resident a SM, 2080 table
    keys), twice that in AR (4-warp blocks, two resident), and 1 when the
    table is one tile or the grid is already full."""
    def blocks(B, c, H, KVH, ps, n_slots):
        s = cpa.pick_splits(B, c, H, KVH, ps, n_slots)
        assert type(s) is int and 1 <= s <= cpa.MAX_SPLITS
        return B * KVH * -(-(H // KVH) * c // cpa.ROWS_PER_BLOCK) * s, s

    assert blocks(8, 32, 32, 8, 16, 130) == (256, 4)   # SDAR-8B decode
    assert blocks(8, 1, 32, 8, 16, 130) == (512, 8)    # AR decode
    assert 256 <= 2 * cpa.SMS * cpa.RESIDENT[8] < 256 + 64
    assert blocks(8, 32, 32, 8, 16, 4)[1] == 1         # one 64-key tile
    assert blocks(8, 32, 32, 8, 16, 1)[1] == 1
    assert blocks(8, 1, 32, 8, 16, 8)[1] == 2          # two tiles at most
    assert blocks(64, 32, 32, 8, 16, 130)[1] == 1      # grid already full
    assert blocks(1, 1, 32, 8, 16, 4096)[1] == cpa.MAX_SPLITS
    # a prefill chunk of 256 positions: 8 row tiles of 128 rows
    assert blocks(2, 256, 32, 8, 16, 48) == (256, 2)
    assert blocks(2, 8, 8, 2, 16, 4)[1] == 1


def test_lib_path_follows_the_shared_header(tmp_path):
    """A library's cache key covers every header beside its source, so an
    edit to the shared tile rebuilds both kernels (no nvcc needed)."""
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    sources = sorted(csrc.glob("*.cu"))
    assert sources and (csrc / "attn_tile.cuh").exists()
    before = [build.lib_path(s) for s in sources]
    assert before == [build.lib_path(s) for s in sources]
    header = csrc / "attn_tile.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = [build.lib_path(s) for s in sources]
    assert all(a != b for a, b in zip(before, after))
    assert all(a.name.startswith(s.stem + "-") for a, s in zip(after,
                                                               sources))


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
