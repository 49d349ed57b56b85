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

:func:`cost` is the call's FLOPs and bytes, read by the op trace
(:mod:`repro_torch.analysis.optrace`, one op a call), the dry run and
``chip_smoke.py``'s bound.  A ``meta`` tensor takes a shape-only route:
an empty output of q's shape and dtype, nothing computed.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.analysis import optrace
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


def visible_keys(T: int, block_size: int, lengths) -> int:
    """Σ_b Σ_t of the keys query t of row b sees: ``min(len_b, (t // bs +
    1)·bs)`` (block-causal, keys below the row's length)."""
    t = np.arange(T, dtype=np.int64)
    reach = (t // block_size + 1) * block_size
    return int(sum(np.minimum(min(int(n), T), reach).sum() for n in lengths))


def cost(B: int, T: int, H: int, KVH: int, D: int, block_size: int,
         itemsize: int, lengths=None):
    """(FLOPs, bytes) of one call: ``4·D·H·Σ visible`` operations (QKᵀ and
    PV over the keys each query sees, :func:`visible_keys`) and the bytes
    it must move — q of the rows that see a key, the live K/V rows
    (positions < len_b), lengths and the whole output, each once.
    ``lengths``: this call's row lengths; None counts every row at T, what
    a shape-only count sees (the op trace, the dry run)."""
    if lengths is None:
        lengths = [T] * B
    live_rows = sum(1 for n in lengths if n > 0)
    nbytes = (live_rows * T * H * D * itemsize
              + sum(min(n, T) for n in lengths) * KVH * D * 2 * itemsize
              + B * 4 + B * T * H * D * itemsize)
    return 4.0 * D * H * visible_keys(T, block_size, lengths), nbytes


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
    kernel does not take — no fallback — and on inputs that require grad
    while autograd records, since the kernel has no backward pass).

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
    _check(not (torch.is_grad_enabled()
                and any(t.requires_grad for t in (q, k, v))),
           "an input requires grad and the kernel has no backward pass: "
           "differentiate the plain route (block_diffusion_ref, or "
           "TransformerLM.apply(impl=\"train\"))")
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
    (:func:`repro_torch.kernels.ref.block_diffusion_ref`); ``meta`` tensors
    return an empty output of q's shape.  Under an op trace the call is one
    op with :func:`cost` at full rows.  Returns [B,T,H,D] in q's dtype.
    """
    def run():
        if q.is_meta:
            return torch.empty_like(q)
        if q.is_cuda:
            return block_diffusion_attention_kernel(
                q, k, v, lengths, block_size=block_size, scale=scale)
        return block_diffusion_ref(q, k, v, lengths, block_size=block_size,
                                   scale=scale)

    B, T, H, D = q.shape
    return optrace.kernel_call(
        "block_diffusion_attention",
        lambda: cost(B, T, H, k.shape[2], D, min(int(block_size), T),
                     q.element_size()),
        (q, k, v, lengths), run)
