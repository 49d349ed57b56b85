"""Chunked paged attention: the hand-written CUDA kernel, its plain
version, and the wrapper that picks between them by the input's device.

Replaces the Pallas TPU kernel ``paged_chunk_attention_kernel`` (and its
body ``_kernel``) of ``src/repro/kernels/chunked_paged_attn.py``: flash
partials (acc fp32 ``[B,c,H,D]``, m and l fp32 ``[B,c,H]``) of ``c`` chunk
queries per request against the request's paged KV prefix, keys at
positions ``>= ctx_lens[b]`` masked.  The kernel is CUDA C++ for
``sm_90a`` (``csrc/chunked_paged_attn.cu``), built with nvcc at first use
and bound through ctypes (:mod:`repro_torch.kernels.build`).

What bounds it on the H100: at decode shapes it reads every live KV page
once from HBM and does ~4 FLOPs per (query row, key, dim) — the bytes bound
it (3.35 TB/s) long before the tensor cores would.  The first design here
is deliberately simple (see the source note): fp32 FMAs on the CUDA cores,
K/V tiles staged through shared memory, rows tiled over blocks.  It is
right at every shape the serving path gives it but sits well above the
byte bound; tensor cores, TMA and split-context blocks are later work.

``LAUNCHES`` counts kernel launches (only the CUDA path adds to it), so a
run can show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import paged_chunk_ref

LAUNCHES = 0
HEAD_DIMS = (8, 16, 32, 64, 128)
ROWS_PER_WARP = (0, 1, 8)   # 0: one row a warp when G·c <= 8, else eight
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = build.load("chunked_paged_attn")
    fn = lib.paged_chunk_attn
    if fn.argtypes is None:
        fn.argtypes = [_P] * 8 + [_I] * 7 + [ctypes.c_float, _I, _I, _P]
        fn.restype = _I
    return fn


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"paged_chunk_attention kernel: {msg}")


def paged_chunk_attention_kernel(q, k_pages, v_pages, block_tables, ctx_lens,
                                 *, scale: float | None = None,
                                 rows_per_warp: int = 0):
    """Launch the CUDA kernel (CUDA tensors only; raises on anything the
    kernel does not take — no fallback).

    q [B,c,H,D]; k_pages/v_pages [P,ps,KVH,D], contiguous (a per-layer
    ``pool[l]`` view qualifies), same dtype as q (float32 or bfloat16),
    D in HEAD_DIMS; block_tables [B,n_slots] and ctx_lens [B] integer
    (entries past a row's ctx are never read).  ``rows_per_warp`` forces
    the row tiling (1 or 8) so the two can be timed against each other;
    0 picks it from the row count.
    """
    global LAUNCHES
    B, c, H, D = q.shape
    P, ps, KVH, Dk = k_pages.shape
    n_slots = block_tables.shape[1]
    _check(q.is_cuda, "q must be a CUDA tensor")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_tables", block_tables), ("ctx_lens", ctx_lens)):
        _check(t.device == q.device, f"{name} is on {t.device}, q on "
               f"{q.device}")
    _check(q.dtype in _DTYPES, f"unsupported dtype {q.dtype}")
    _check(k_pages.dtype == q.dtype and v_pages.dtype == q.dtype,
           "q, k_pages and v_pages must share one dtype")
    _check(D in HEAD_DIMS, f"head_dim {D} not in {HEAD_DIMS}")
    _check(rows_per_warp in ROWS_PER_WARP,
           f"rows_per_warp {rows_per_warp} not in {ROWS_PER_WARP}")
    _check(Dk == D and tuple(v_pages.shape) == tuple(k_pages.shape),
           "page shapes disagree with q")
    _check(H % KVH == 0, f"{H} heads not a multiple of {KVH} kv heads")
    _check(tuple(block_tables.shape) == (B, n_slots)
           and tuple(ctx_lens.shape) == (B,), "table/ctx shapes")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        _check(t.is_contiguous(), f"{name} must be contiguous")
        _check(t.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned")
    tables = block_tables.to(torch.int32).contiguous()
    lens = ctx_lens.to(torch.int32).contiguous()
    scale = float(scale if scale is not None else 1.0 / np.sqrt(D))

    acc = torch.empty((B, c, H, D), dtype=torch.float32, device=q.device)
    m = torch.empty((B, c, H), dtype=torch.float32, device=q.device)
    l = torch.empty((B, c, H), dtype=torch.float32, device=q.device)
    if B == 0 or c == 0:
        return acc, m, l
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib()(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 tables.data_ptr(), lens.data_ptr(), acc.data_ptr(),
                 m.data_ptr(), l.data_ptr(), B, c, H, KVH, D, ps, n_slots,
                 scale, _DTYPES[q.dtype], rows_per_warp, stream)
    if err != 0:
        raise RuntimeError(f"paged_chunk_attn launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1
    return acc, m, l


def paged_chunk_attention(q, k_pages, v_pages, block_tables, ctx_lens, *,
                          scale: float | None = None):
    """Flash partials of chunk queries vs the paged prefix cache.

    CUDA tensors launch the kernel; CPU tensors run the plain version
    (:func:`repro_torch.kernels.ref.paged_chunk_ref`).  Returns
    (acc [B,c,H,D] fp32, m [B,c,H], l [B,c,H]).
    """
    if q.is_cuda:
        return paged_chunk_attention_kernel(q, k_pages, v_pages, block_tables,
                                            ctx_lens, scale=scale)
    return paged_chunk_ref(q, k_pages, v_pages, block_tables, ctx_lens,
                           scale=scale)
