"""Chunked paged attention: the hand-written CUDA kernels, their plain
versions, and the wrapper that picks between them by the input's device.

Replaces the Pallas TPU kernel ``paged_chunk_attention_kernel`` (and its
body ``_kernel``) of ``src/repro/kernels/chunked_paged_attn.py``: flash
partials (acc fp32 ``[B,c,H,D]``, m and l fp32 ``[B,c,H]``) of ``c`` chunk
queries per request against the request's paged KV prefix, keys at
positions ``>= ctx_lens[b]`` masked.  The kernels are CUDA C++ for
``sm_90a`` (``csrc/chunked_paged_attn.cu`` with the shared tile
``csrc/attn_tile.cuh``), built with nvcc at first use and bound through
ctypes (:mod:`repro_torch.kernels.build`).

What bounds it on the H100: at decode shapes it reads every live KV page
once from HBM and does ~4 FLOPs per (query row, key, dim), so the bytes
bound it (3.35 TB/s).  The bf16 body (``body="tensor_core"``) runs QK^T and
PV on the tensor cores (mma.sync) with K/V tiles gathered by cp.async into
a two-stage ring, holds all G·c rows of a (request, kv head) in one block
so each page is read once per split, and splits each row's live keys over
``S`` blocks (split-KV, decided on the device from ``ctx_lens``; ``S``
itself from shapes only, :func:`pick_splits`), then merges the ``S``
partials with a second small kernel.  P enters PV in three bf16 parts, so
the partials carry fp32 probabilities (the plain version's), not the
Pallas body's bf16 ones: see the source note.  float32, and bf16 under
``body="cuda_core"``, run the first design: fp32 FMAs on the CUDA cores
with ``rows_per_warp`` as its knob.  wgmma, TMA and a persistent grid are
later work.

``LAUNCHES`` counts wrapper calls that launched the kernel and
``MERGE_LAUNCHES`` those that also launched the merge (S > 1); only the
CUDA path adds to them, so a run can show that its main path went through
the kernels.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import (KEYS_PER_TILE, paged_chunk_ref,
                                     paged_chunk_split_ref)

LAUNCHES = 0
MERGE_LAUNCHES = 0
HEAD_DIMS = (8, 16, 32, 64, 112, 128)
BODIES = ("auto", "tensor_core", "cuda_core")
ROWS_PER_WARP = (0, 1, 8)   # cuda_core: 0 is one row a warp when G·c <= 8
SMS = 132                   # streaming multiprocessors of an H100 SXM
WAVES = 2                   # the split grid aims at two full waves
# blocks of the tensor-core body an SM holds at D 128 (about 200 registers
# a thread): one of 8 warps, two of 4 (the kernel takes 4 warps for up to
# 64 rows, 8 above)
RESIDENT = {4: 2, 8: 1}
MAX_SPLITS = 16
ROWS_PER_BLOCK = 128        # the tensor-core body's largest row tile
_MAX_GRID_Z = 65535
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = build.load("chunked_paged_attn")
    fn = lib.paged_chunk_attn
    if fn.argtypes is None:
        fn.argtypes = [_P] * 9 + [_I] * 7 + [ctypes.c_float] + [_I] * 4 \
            + [_P]
        fn.restype = _I
    return fn


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"paged_chunk_attention kernel: {msg}")


def pick_splits(B: int, c: int, H: int, KVH: int, page_size: int,
                n_slots: int) -> int:
    """The tensor-core body's split count, from shapes alone: as many splits
    as fill ``WAVES`` whole waves of resident blocks (no half-empty last
    wave), but no more than the table's 64-key tiles (a single-tile table
    gives 1) or ``MAX_SPLITS``.  Never reads a device tensor, so the launch
    adds no host sync."""
    rows = (H // KVH) * c
    blocks = B * KVH * -(-rows // ROWS_PER_BLOCK)
    waves = WAVES * SMS * RESIDENT[4 if rows <= 64 else 8] // blocks
    tiles = -(-n_slots * page_size // KEYS_PER_TILE)
    return max(1, min(tiles, MAX_SPLITS, waves))


def paged_chunk_attention_kernel(q, k_pages, v_pages, block_tables, ctx_lens,
                                 *, scale: float | None = None,
                                 body: str = "auto", splits: int = 0,
                                 rows_per_warp: int = 0):
    """Launch the CUDA kernel (CUDA tensors only; raises on anything the
    kernel does not take — no fallback).

    q [B,c,H,D]; k_pages/v_pages [P,ps,KVH,D], contiguous (a per-layer
    ``pool[l]`` view qualifies), same dtype as q (float32 or bfloat16),
    D in HEAD_DIMS; block_tables [B,n_slots] and ctx_lens [B] integer
    (entries past a row's ctx are never read).

    The forcing arguments time one design against another; the model path
    passes none.  ``body``: "auto" runs "tensor_core" for bfloat16 and
    "cuda_core" for float32; "cuda_core" forces the first design in
    bfloat16.  ``splits``: the tensor-core body's split count, 0 to pick
    it (:func:`pick_splits`).  ``rows_per_warp``: the cuda-core body's row
    tiling (1 or 8), 0 to pick it from the row count.
    """
    global LAUNCHES, MERGE_LAUNCHES
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
    _check(body in BODIES, f"body {body!r} not in {BODIES}")
    if body == "auto":
        body = "tensor_core" if q.dtype == torch.bfloat16 else "cuda_core"
    _check(body == "cuda_core" or q.dtype == torch.bfloat16,
           "the tensor_core body takes bfloat16 only")
    _check(rows_per_warp in ROWS_PER_WARP,
           f"rows_per_warp {rows_per_warp} not in {ROWS_PER_WARP}")
    _check(body == "cuda_core" or rows_per_warp == 0,
           "rows_per_warp is a knob of the cuda_core body")
    _check(int(splits) == splits and splits >= 0, f"splits {splits} < 0")
    _check(body == "tensor_core" or splits <= 1,
           "splits is a knob of the tensor_core body")
    _check(Dk == D and tuple(v_pages.shape) == tuple(k_pages.shape),
           "page shapes disagree with q")
    _check(H % KVH == 0, f"{H} heads not a multiple of {KVH} kv heads")
    _check(tuple(block_tables.shape) == (B, n_slots)
           and tuple(ctx_lens.shape) == (B,), "table/ctx shapes")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        _check(t.is_contiguous(), f"{name} must be contiguous")
        _check(t.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned")
    S = 1
    if body == "tensor_core":
        S = int(splits) or pick_splits(B, c, H, KVH, ps, n_slots)
    _check(B * S <= _MAX_GRID_Z, f"B {B} x {S} splits exceeds the grid")
    tables = block_tables.to(torch.int32).contiguous()
    lens = ctx_lens.to(torch.int32).contiguous()
    scale = float(scale if scale is not None else 1.0 / np.sqrt(D))

    acc = torch.empty((B, c, H, D), dtype=torch.float32, device=q.device)
    m = torch.empty((B, c, H), dtype=torch.float32, device=q.device)
    l = torch.empty((B, c, H), dtype=torch.float32, device=q.device)
    if B == 0 or c == 0:
        return acc, m, l
    scratch = None
    if S > 1:
        scratch = torch.empty((S, B, c, H, D + 2), dtype=torch.float32,
                              device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib()(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 tables.data_ptr(), lens.data_ptr(), acc.data_ptr(),
                 m.data_ptr(), l.data_ptr(),
                 None if scratch is None else scratch.data_ptr(), B, c, H,
                 KVH, D, ps, n_slots, scale, _DTYPES[q.dtype],
                 int(body == "tensor_core"), rows_per_warp, S, stream)
    if err != 0:
        raise RuntimeError(f"paged_chunk_attn launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1
    MERGE_LAUNCHES += int(S > 1)
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
