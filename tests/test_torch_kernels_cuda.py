"""The CUDA kernels on the card against their plain versions (needs a GPU
and nvcc; skipped elsewhere).  Run on the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Tolerances as tests/test_kernels.py: fp32 2e-5 / bf16 3e-2 relative on acc,
m within rtol 1e-5 / atol 1e-4.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import chunked_paged_attn as cpa

pytestmark = pytest.mark.cuda

SHAPES = [
    # B, c, H, KVH, D, page_size, n_slots  (tests/test_kernels.py + SDAR-8B)
    (1, 2, 2, 1, 64, 16, 4),
    (2, 8, 4, 2, 64, 16, 8),
    (2, 16, 8, 2, 128, 16, 4),
    (3, 32, 6, 3, 64, 8, 16),
    (2, 1, 4, 4, 128, 32, 2),
    (4, 32, 32, 8, 128, 16, 32),
    (2, 300, 32, 8, 128, 16, 8),
    (2, 8, 8, 2, 8, 16, 4),             # sdar-8b SMOKE head_dim 8
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("rows_per_warp", [0, 1, 8])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_version(cuda, shape, dtype, rows_per_warp):
    B, c, H, KVH, D, ps, n_slots = shape
    rng = np.random.default_rng(42)
    P = B * n_slots + 3
    mk = lambda *s: torch.as_tensor(rng.normal(size=s), dtype=torch.float32,
                                    device=cuda).to(dtype)
    q, kp, vp = mk(B, c, H, D), mk(P, ps, KVH, D), mk(P, ps, KVH, D)
    tables = torch.as_tensor(
        rng.permutation(P)[:B * n_slots].reshape(B, n_slots),
        dtype=torch.int32, device=cuda)
    lens = rng.integers(1, ps * n_slots, B)
    lens[0] = 0                                   # an empty row
    lens = torch.as_tensor(lens, dtype=torch.int32, device=cuda)
    before = cpa.LAUNCHES
    if rows_per_warp:       # a forced row tiling
        acc, m, l = cpa.paged_chunk_attention_kernel(
            q, kp, vp, tables, lens, rows_per_warp=rows_per_warp)
    else:                   # the wrapper the model calls
        acc, m, l = cpa.paged_chunk_attention(q, kp, vp, tables, lens)
    torch.cuda.synchronize()
    assert cpa.LAUNCHES == before + 1
    acc_r, m_r, l_r = cpa.paged_chunk_ref(q, kp, vp, tables, lens)
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(m, m_r, rtol=1e-5, atol=1e-4)
    rel = float((acc - acc_r).abs().max()) / \
        (float(acc_r.abs().max()) + 1e-9)
    assert rel < tol, rel
    torch.testing.assert_close(l, l_r, rtol=tol, atol=1e-5)
    assert torch.all(acc[0] == 0) and torch.all(m[0] == -1e30)


def test_kernel_rejects_what_it_does_not_take(cuda):
    q = torch.zeros((1, 1, 4, 12), device=cuda)
    kp = torch.zeros((2, 16, 2, 12), device=cuda)
    t = torch.zeros((1, 1), dtype=torch.int32, device=cuda)
    ln = torch.zeros((1,), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        cpa.paged_chunk_attention_kernel(q, kp, kp, t, ln)
    q, kp = q[..., :8].contiguous(), kp[..., :8].contiguous()
    with pytest.raises(ValueError, match="rows_per_warp"):
        cpa.paged_chunk_attention_kernel(q, kp, kp, t, ln, rows_per_warp=4)
