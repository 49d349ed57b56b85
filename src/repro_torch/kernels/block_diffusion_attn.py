"""Block-diffusion attention: the hand-written CUDA kernel, its plain
version, and the wrapper that picks between them by the input's device.

Replaces the Pallas TPU kernel ``block_diffusion_attention_kernel`` (and
its body ``_kernel``) of ``src/repro/kernels/block_diffusion_attn.py``:
normalised block-causal attention over a whole position-aligned sequence —
query ``i`` sees key ``j`` when ``j // block_size <= i // block_size`` and
``j < lengths[b]`` — with the output in q's dtype.  It is what wave prefill
(``TransformerLM.prefill_paged``) runs once per layer; ``block_size`` 1 is
the causal mask of the AR configurations.  The kernel is CUDA C++ for
``sm_90a`` (``csrc/block_diffusion_attn.cu`` with the shared tile
``csrc/attn_tile.cuh``), built with nvcc at first use and bound through
ctypes (:mod:`repro_torch.kernels.build`).

What bounds it on the H100: at the SDAR-8B wave shape the live work is
~4·D·H·Σ(visible keys) FLOPs against a few tens of MB of q, k, v and out;
the work belongs on the tensor cores.  The bf16 body
(``body="tensor_core"``) runs QK^T and PV there (mma.sync, bf16 in, fp32
accumulate) on 64-row tiles with the GQA heads folded into the rows, K/V
tiles by cp.async into a two-stage ring, tiles past the block diagonal
skipped, and the longest row tiles launched first.
float32, and bf16 under ``body="cuda_core"``, run the first design: fp32
FMAs on the CUDA cores.  wgmma, TMA and a persistent grid are later work.

``LAUNCHES`` counts kernel launches (only the CUDA path adds to it), so a
run can show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import block_diffusion_ref

LAUNCHES = 0
HEAD_DIMS = (8, 16, 32, 64, 112, 128)
BODIES = ("auto", "tensor_core", "cuda_core")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ROWS = 64            # rows (positions × grouped heads) per thread block
_MAX_GRID_Z = 65535
_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = build.load("block_diffusion_attn")
    fn = lib.block_diffusion_attn
    if fn.argtypes is None:
        fn.argtypes = [_P] * 5 + [_I] * 6 + [ctypes.c_float, _I, _I, _P]
        fn.restype = _I
    return fn


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"block_diffusion_attention kernel: {msg}")


def block_diffusion_attention_kernel(q, k, v, lengths, *, block_size: int,
                                     scale: float | None = None,
                                     body: str = "auto"):
    """Launch the CUDA kernel (CUDA tensors only; raises on anything the
    kernel does not take — no fallback).

    q [B,T,H,D]; k/v [B,T,KVH,D], contiguous, same dtype as q (float32 or
    bfloat16), D in HEAD_DIMS, H a multiple of KVH; lengths [B] integer.
    Any T and any ``block_size >= 1``.  Returns [B,T,H,D] in q's dtype.

    ``body`` forces a design, to time one against the other (the model
    path passes none): "auto" runs "tensor_core" for bfloat16 and
    "cuda_core" for float32; "cuda_core" forces the first design in
    bfloat16.
    """
    global LAUNCHES
    B, T, H, D = q.shape
    _check(q.is_cuda, "q must be a CUDA tensor")
    for name, t in (("k", k), ("v", v), ("lengths", lengths)):
        _check(t.device == q.device, f"{name} is on {t.device}, q on "
               f"{q.device}")
    _check(q.dtype in _DTYPES, f"unsupported dtype {q.dtype}")
    _check(k.dtype == q.dtype and v.dtype == q.dtype,
           "q, k and v must share one dtype")
    _check(D in HEAD_DIMS, f"head_dim {D} not in {HEAD_DIMS}")
    _check(body in BODIES, f"body {body!r} not in {BODIES}")
    if body == "auto":
        body = "tensor_core" if q.dtype == torch.bfloat16 else "cuda_core"
    _check(body == "cuda_core" or q.dtype == torch.bfloat16,
           "the tensor_core body takes bfloat16 only")
    _check(k.dim() == 4 and tuple(k.shape[:2]) == (B, T)
           and k.shape[3] == D and tuple(v.shape) == tuple(k.shape),
           f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} disagree with q "
           f"{tuple(q.shape)}")
    KVH = k.shape[2]
    _check(KVH > 0 and H % KVH == 0,
           f"{H} heads not a multiple of {KVH} kv heads")
    _check(tuple(lengths.shape) == (B,), "lengths must be [B]")
    _check(not lengths.is_floating_point(), "lengths must be integer")
    _check(int(block_size) >= 1, f"block_size {block_size} < 1")
    _check(-(-T * (H // KVH) // _ROWS) <= _MAX_GRID_Z,
           f"T {T} too long for one launch")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(t.is_contiguous(), f"{name} must be contiguous")
        _check(t.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned")
    lens = lengths.to(torch.int32).contiguous()
    scale = float(scale if scale is not None else 1.0 / np.sqrt(D))

    out = torch.empty_like(q)
    if B == 0 or T == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    # a block of T or more keys is one block: the same mask, in an int
    err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
                 out.data_ptr(), B, T, H, KVH, D, min(int(block_size), T),
                 scale, _DTYPES[q.dtype], int(body == "tensor_core"), stream)
    if err != 0:
        raise RuntimeError(f"block_diffusion_attn launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1
    return out


def block_diffusion_attention(q, k, v, lengths, *, block_size: int,
                              scale: float | None = None):
    """Block-causal attention over a position-aligned sequence.

    CUDA tensors launch the kernel; CPU tensors run the plain version
    (:func:`repro_torch.kernels.ref.block_diffusion_ref`).  Returns
    [B,T,H,D] in q's dtype.
    """
    if q.is_cuda:
        return block_diffusion_attention_kernel(q, k, v, lengths,
                                                block_size=block_size,
                                                scale=scale)
    return block_diffusion_ref(q, k, v, lengths, block_size=block_size,
                               scale=scale)
