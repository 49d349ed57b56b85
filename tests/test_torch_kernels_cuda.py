"""The CUDA kernels on the card against their plain versions (needs a GPU
and nvcc; skipped elsewhere).  Run on the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Each kernel runs under every forced variant of its dtype: the body the
wrapper picks, the CUDA-core body, and (paged, bf16) the tensor-core body
with one split and with eight.  The moe and vlm families' shapes (Llama-4
Scout, Qwen2-VL-2B, Kimi K2: GQA groups 5 and 6, head dim 112; chip_smoke.py
shapes (i)-(n)) run in bf16 under both bodies, the paged ones at the picked
split count and at one split.

Tolerances as tests/test_kernels.py: fp32 2e-5 / bf16 3e-2 relative on acc,
m within rtol 1e-5 / atol 1e-4; the block-diffusion output within 2e-5 /
3e-2 (rtol and atol).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import block_diffusion_attn as bda
from repro_torch.kernels import chunked_paged_attn as cpa

pytestmark = pytest.mark.cuda

SHAPES = [
    # B, c, H, KVH, D, page_size, n_slots, ctx_lens (None: random, row 0
    # empty)  (tests/test_kernels.py + SDAR-8B)
    (1, 2, 2, 1, 64, 16, 4, None),
    (2, 8, 4, 2, 64, 16, 8, None),
    (2, 16, 8, 2, 128, 16, 4, None),
    (3, 32, 6, 3, 64, 8, 16, None),
    (2, 1, 4, 4, 128, 32, 2, None),
    (4, 32, 32, 8, 128, 16, 32, None),
    (2, 300, 32, 8, 128, 16, 8, None),
    (2, 8, 8, 2, 8, 16, 4, None),             # sdar-8b SMOKE head_dim 8
    (8, 32, 32, 8, 128, 16, 130, [0] + [2048] * 7),   # SDAR-8B decode
    (2, 256, 32, 8, 128, 16, 48, [0, 768]),   # SDAR-8B prefill chunk
]

# The forced variants of each dtype.  float32 has only the CUDA-core body
# (its row tilings); bf16 the picked body, the CUDA-core body, and the
# tensor-core body with one split and with eight.
VARIANTS = [
    ("float32", "picked", {}),
    ("float32", "cuda_core_rows_1", {"rows_per_warp": 1}),
    ("float32", "cuda_core_rows_8", {"rows_per_warp": 8}),
    ("bfloat16", "picked", {}),
    ("bfloat16", "cuda_core", {"body": "cuda_core"}),
    ("bfloat16", "tensor_core_s1", {"body": "tensor_core", "splits": 1}),
    ("bfloat16", "tensor_core_s8", {"body": "tensor_core", "splits": 8}),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


RAGGED_CTX = [0, 1, 15, 16, 17, 2048, 700, 1333]
FAMILY_SHAPES = {
    # chip_smoke.py shapes (i)-(k): B 8, c 32, page 16, ragged ctx
    "i_decode_scout": (8, 32, 40, 8, 128, 16, 128, RAGGED_CTX),
    "j_decode_qwen2vl": (8, 32, 12, 2, 128, 16, 128, RAGGED_CTX),
    "k_decode_kimi_k2": (8, 32, 64, 8, 112, 16, 128, RAGGED_CTX),
}
# bf16: the picked body and split count, one split, the CUDA-core body
FAMILY_VARIANTS = [v for v in VARIANTS if v[0] == "bfloat16"
                   and v[1] != "tensor_core_s8"]


@pytest.mark.parametrize("dtype, variant, forced", VARIANTS,
                         ids=[f"{d}-{v}" for d, v, _ in VARIANTS])
@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_matches_plain_version(cuda, shape, dtype, variant, forced):
    _check_paged(cuda, shape, dtype, forced)


@pytest.mark.parametrize("dtype, variant, forced", FAMILY_VARIANTS,
                         ids=[f"{d}-{v}" for d, v, _ in FAMILY_VARIANTS])
@pytest.mark.parametrize("shape", sorted(FAMILY_SHAPES))
def test_kernel_matches_plain_version_families(cuda, shape, dtype, variant,
                                               forced):
    _check_paged(cuda, FAMILY_SHAPES[shape], dtype, forced)


def _check_paged(cuda, shape, dtype, forced):
    B, c, H, KVH, D, ps, n_slots, lens = shape
    dtype = getattr(torch, dtype)
    rng = np.random.default_rng(42)
    P = B * n_slots + 3
    mk = lambda *s: torch.as_tensor(rng.normal(size=s), dtype=torch.float32,
                                    device=cuda).to(dtype)
    q, kp, vp = mk(B, c, H, D), mk(P, ps, KVH, D), mk(P, ps, KVH, D)
    tables = torch.as_tensor(
        rng.permutation(P)[:B * n_slots].reshape(B, n_slots),
        dtype=torch.int32, device=cuda)
    if lens is None:
        lens = rng.integers(1, ps * n_slots, B)
        lens[0] = 0                               # an empty row
    lens = torch.as_tensor(lens, dtype=torch.int32, device=cuda)
    before, merges = cpa.LAUNCHES, cpa.MERGE_LAUNCHES
    if forced:              # a forced body, split count or row tiling
        acc, m, l = cpa.paged_chunk_attention_kernel(q, kp, vp, tables, lens,
                                                     **forced)
    else:                   # the wrapper the model calls
        acc, m, l = cpa.paged_chunk_attention(q, kp, vp, tables, lens)
    torch.cuda.synchronize()
    assert cpa.LAUNCHES == before + 1
    if forced.get("splits", 0) > 1:
        assert cpa.MERGE_LAUNCHES == merges + 1
    if forced.get("splits") == 1 or "rows_per_warp" in forced \
            or forced.get("body") == "cuda_core":
        assert cpa.MERGE_LAUNCHES == merges
    acc_r, m_r, l_r = cpa.paged_chunk_ref(q, kp, vp, tables, lens)
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(m, m_r, rtol=1e-5, atol=1e-4)
    rel = float((acc - acc_r).abs().max()) / \
        (float(acc_r.abs().max()) + 1e-9)
    assert rel < tol, rel
    torch.testing.assert_close(l, l_r, rtol=tol, atol=1e-5)
    assert torch.all(acc[0] == 0) and torch.all(m[0] == -1e30)
    assert torch.all(l[0] == 0)


def test_kernel_rejects_what_it_does_not_take(cuda):
    q = torch.zeros((1, 1, 4, 12), device=cuda)
    kp = torch.zeros((2, 16, 2, 12), device=cuda)
    t = torch.zeros((1, 1), dtype=torch.int32, device=cuda)
    ln = torch.zeros((1,), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        cpa.paged_chunk_attention_kernel(q, kp, kp, t, ln)
    q96 = torch.zeros((1, 1, 4, 96), dtype=torch.bfloat16, device=cuda)
    kp96 = torch.zeros((2, 16, 2, 96), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="head_dim 96"):
        cpa.paged_chunk_attention_kernel(q96, kp96, kp96, t, ln)
    q, kp = q[..., :8].contiguous(), kp[..., :8].contiguous()
    with pytest.raises(ValueError, match="rows_per_warp"):
        cpa.paged_chunk_attention_kernel(q, kp, kp, t, ln, rows_per_warp=4)
    with pytest.raises(ValueError, match="body"):
        cpa.paged_chunk_attention_kernel(q, kp, kp, t, ln, body="wgmma")
    with pytest.raises(ValueError, match="bfloat16 only"):
        cpa.paged_chunk_attention_kernel(q, kp, kp, t, ln,
                                         body="tensor_core")
    with pytest.raises(ValueError, match="splits"):
        cpa.paged_chunk_attention_kernel(q, kp, kp, t, ln, splits=2)
    qb, kb = q.bfloat16(), kp.bfloat16()
    with pytest.raises(ValueError, match="rows_per_warp"):
        cpa.paged_chunk_attention_kernel(qb, kb, kb, t, ln, rows_per_warp=8)
    with pytest.raises(ValueError, match="splits"):
        cpa.paged_chunk_attention_kernel(qb, kb, kb, t, ln, splits=-1)


BD_SHAPES = {
    # B, T, H, KVH, D, block_size, lengths  (chip_smoke.py shapes (e)-(h))
    "e_wave_sdar8b": (8, 512, 32, 8, 128, 32,
                      [512, 0, 1, 31, 33, 200, 511, 384]),
    "f_long": (2, 2048, 32, 8, 128, 32, [2048, 1500]),
    "g_causal": (4, 256, 32, 8, 128, 1, [256, 0, 100, 17]),
    "h_smoke_d8": (3, 48, 8, 2, 8, 8, [48, 0, 5]),
}


# float32 runs the CUDA-core body; bf16 both bodies.
BD_VARIANTS = [
    ("float32", "picked", {}),
    ("bfloat16", "picked", {}),
    ("bfloat16", "cuda_core", {"body": "cuda_core"}),
]


WAVE_LENGTHS = [512, 0, 130, 257, 384, 449, 200, 511]
BD_FAMILY_SHAPES = {
    # chip_smoke.py shapes (l)-(n): the wave of (e) at the families' heads
    "l_wave_scout": (8, 512, 40, 8, 128, 32, WAVE_LENGTHS),
    "m_wave_qwen2vl": (8, 512, 12, 2, 128, 32, WAVE_LENGTHS),
    "n_wave_kimi_k2": (8, 512, 64, 8, 112, 32, WAVE_LENGTHS),
}
BD_FAMILY_VARIANTS = [v for v in BD_VARIANTS if v[0] == "bfloat16"]


@pytest.mark.parametrize("dtype, variant, forced", BD_VARIANTS,
                         ids=[f"{d}-{v}" for d, v, _ in BD_VARIANTS])
@pytest.mark.parametrize("shape", sorted(BD_SHAPES))
def test_block_diffusion_kernel_matches_plain_version(cuda, shape, dtype,
                                                      variant, forced):
    _check_bd(cuda, BD_SHAPES[shape], dtype, forced)


@pytest.mark.parametrize("dtype, variant, forced", BD_FAMILY_VARIANTS,
                         ids=[f"{d}-{v}" for d, v, _ in BD_FAMILY_VARIANTS])
@pytest.mark.parametrize("shape", sorted(BD_FAMILY_SHAPES))
def test_block_diffusion_kernel_matches_plain_version_families(
        cuda, shape, dtype, variant, forced):
    _check_bd(cuda, BD_FAMILY_SHAPES[shape], dtype, forced)


def _check_bd(cuda, shape, dtype, forced):
    B, T, H, KVH, D, bs, lens = shape
    dtype = getattr(torch, dtype)
    rng = np.random.default_rng(42)
    mk = lambda *s: torch.as_tensor(rng.normal(size=s), dtype=torch.float32,
                                    device=cuda).to(dtype)
    q, k, v = mk(B, T, H, D), mk(B, T, KVH, D), mk(B, T, KVH, D)
    lens = torch.as_tensor(lens, dtype=torch.int32, device=cuda)
    before = bda.LAUNCHES
    if forced:
        out = bda.block_diffusion_attention_kernel(q, k, v, lens,
                                                   block_size=bs, **forced)
    else:
        out = bda.block_diffusion_attention(q, k, v, lens, block_size=bs)
    torch.cuda.synchronize()
    assert bda.LAUNCHES == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    want = bda.block_diffusion_ref(q, k, v, lens, block_size=bs)
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)
    for b in range(B):
        if int(lens[b]) == 0:
            assert torch.all(out[b] == 0)


def test_block_diffusion_kernel_rejects_what_it_does_not_take(cuda):
    q = torch.zeros((1, 8, 4, 8), device=cuda)
    k = torch.zeros((1, 8, 2, 8), device=cuda)
    ln = torch.full((1,), 8, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="CUDA"):
        bda.block_diffusion_attention_kernel(q.cpu(), k.cpu(), k.cpu(),
                                             ln.cpu(), block_size=4)
    with pytest.raises(ValueError, match="head_dim"):
        bda.block_diffusion_attention_kernel(
            torch.zeros((1, 8, 4, 12), device=cuda),
            torch.zeros((1, 8, 2, 12), device=cuda),
            torch.zeros((1, 8, 2, 12), device=cuda), ln, block_size=4)
    with pytest.raises(ValueError, match="head_dim 96"):
        bda.block_diffusion_attention_kernel(
            torch.zeros((1, 8, 4, 96), dtype=torch.bfloat16, device=cuda),
            torch.zeros((1, 8, 2, 96), dtype=torch.bfloat16, device=cuda),
            torch.zeros((1, 8, 2, 96), dtype=torch.bfloat16, device=cuda),
            ln, block_size=4)
    with pytest.raises(ValueError, match="dtype"):
        bda.block_diffusion_attention_kernel(q, k.bfloat16(), k, ln,
                                             block_size=4)
    with pytest.raises(ValueError, match="contiguous"):
        bda.block_diffusion_attention_kernel(
            q.transpose(1, 2).contiguous().transpose(1, 2), k, k, ln,
            block_size=4)
    with pytest.raises(ValueError, match="bfloat16 only"):
        bda.block_diffusion_attention_kernel(q, k, k, ln, block_size=4,
                                             body="tensor_core")
    with pytest.raises(ValueError, match="body"):
        bda.block_diffusion_attention_kernel(q, k, k, ln, block_size=4,
                                             body="wgmma")


def test_grouped_matmul_cuda_matches_loop(cuda):
    """The MoE grouped product on the card: ``torch._grouped_mm`` against
    the plain loop (empty groups, rows past the last group 0), without a
    host sync; float32 raises (no quiet fallback)."""
    from repro_torch.models import moe

    rng = np.random.default_rng(7)
    sizes = [5, 0, 17, 1, 0, 9, 0, 0]
    M, K, N = 40, 256, 128
    rows = torch.as_tensor(rng.normal(size=(M, K)), dtype=torch.bfloat16,
                           device=cuda)
    w = torch.as_tensor(rng.normal(size=(len(sizes), K, N)) / 16,
                        dtype=torch.bfloat16, device=cuda)
    gs = torch.as_tensor(sizes, dtype=torch.int32, device=cuda)
    calls = moe.GROUPED_CALLS
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = moe.grouped_matmul(rows, w, gs)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert moe.GROUPED_CALLS == calls + 1
    want = moe.grouped_matmul_loop(rows, w, gs)
    torch.testing.assert_close(got.float(), want.float(), rtol=3e-2,
                               atol=3e-2)
    assert torch.all(got[sum(sizes):] == 0)
    with pytest.raises(ValueError, match="bfloat16"):
        moe.grouped_matmul(rows.float(), w.float(), gs)
