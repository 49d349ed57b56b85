#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed N] [--out results.json]

Phases, in order (any failed check raises and the script exits non-zero):

1. the card's name and power limit (nvidia-smi); TF32 off;
2. build every CUDA kernel of the port from ``src/repro_torch/kernels/csrc``
   with nvcc for sm_90a (one compile per source, all at once);
3. kernel phase: each kernel's wrapper on CUDA tensors against its plain
   PyTorch version on the same inputs, at the serving path's shapes (those
   of SDAR-8B, and of Llama-4 Scout, Qwen2-VL-2B and Kimi K2: GQA groups 5
   and 6, head dim 112), under each body (bf16: the tensor-core body the
   wrapper picks and the first, CUDA-core design; the paged kernel's
   tensor-core body also with one split),
   with times (CUDA events; the block-diffusion kernel beside
   ``scaled_dot_product_attention``), TFLOP/s and the card's least time for
   the same work; then the split merge at rows whose splits are all empty
   (ctx 0) or all but the first (ctx 5);
3b. MoE layer phase: one Llama-4 Scout layer's experts at full width on the
   token counts of a decode dispatch, a prefill chunk and a wave, the
   grouped route (``torch._grouped_mm``) against the loop route, timed
   beside the grouped products' bound, and run once under
   ``torch.cuda.set_sync_debug_mode("error")`` (no host sync);
4. model phase: one ``decode_step_paged`` dispatch of SDAR-8B at full width
   and depth in bf16, through the kernel and through the plain version, on
   the same weights and pool, held at limits that a control run (the
   kernel's acc skewed by ``CONTROL_SKEW``) must break, beside the phase's
   noise floor (the plain split version against the plain version) and
   the gap check's margin under other attention paths (readings only);
5. profile phase: the same dispatch at B 8, c 32 with every context at 512
   and at 2048 tokens, timed through the kernel and the plain version, and
   split by kernel with ``torch.profiler``: the device's busy share of the
   wall time and the paged kernel's share of the device time;
6. prefill model phase: one wave ``prefill_paged`` dispatch of SDAR-8B at
   full width and depth in bf16 (shape (e)), through the block-diffusion
   kernel and through its plain version, on the same weights and pool:
   head logits, conf, tok and the pages written, held at limits that a
   control run (the kernel's output skewed by ``CONTROL_SKEW``) must break,
   then where that dispatch's time goes, as in the profile phase;
7. serving phase (the main path): SDAR-8B (36 layers, d_model 4096, bf16,
   seeded random weights drawn on the card) served by the paged
   ``ModelBackend`` through ``ServingEngine`` — an elastic run of 8
   requests with chunked prefill, a shorter AR run, and the elastic run's
   requests again with wave prefill — with the kernels' launch counts (and
   the paged kernel's merge launches) set to 0 before each run and read
   after it;
8. the moe family: Llama-4 Scout at full width, 8 of its 48 layers (the
   card's 80 GB), random weights drawn on the card: one decode dispatch
   kernel path vs plain path as in phase 4, with the kernel path's routing
   pinned to the plain path's experts (with its own routing, the (token,
   layer) pairs whose top-1 expert flips are readings, beside the same
   readings of the plain split version as the noise floor), profiled as in
   phase 5 (the grouped products' device time too), then the elastic
   serving run of phase 7;
9. the vlm family: Qwen2-VL-2B at full width and depth (text only) served
   elastic with chunked prefill and with wave prefill, as in phase 7.
   Each model is freed before the next is drawn.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Without CUDA, or without the repository
beside this file, it prints no result and exits non-zero.
"""

from __future__ import annotations

import argparse
import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

H100_HBM_BPS = 3.35e12            # bytes/s, H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12,  # dense tensor-core bf16
              "float32": 67e12}    # fp32 outside the tensor cores
BF16_TOL, FP32_TOL = 3e-2, 2e-5   # tests/test_kernels.py:13-14
DEVICE = "cuda"


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def ptxas_report(text: str) -> list[dict]:
    """Registers and spill bytes of each kernel instantiation, from nvcc's
    ``-Xptxas=-v`` log, named ``kernel<template args>``."""
    import re

    types = {"13__nv_bfloat16": "bf16", "f": "float"}
    out, name, spill = [], None, 0
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"\d+((?:paged_chunk|block_diffusion)_attn\w*?"
                          r"_kernel)I(\w*?)EEv", m.group(1))
            args = [types.get(t, n) for t, n in re.findall(
                r"(13__nv_bfloat16|f(?=L))|L[ij](\d+)E", k.group(2))] \
                if k else []
            name = f"{k.group(1)}<{','.join(args)}>" if k else m.group(1)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append({"kernel": name, "registers": int(m.group(1)),
                        "spill_bytes": spill})
            name, spill = None, 0
    return out


def time_ms(fn, iters: int = 25, warmup: int = 3) -> float:
    """Median device time of one call: CUDA events around the call, with the
    device held busy first so host-side launch work is not timed."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------

RAGGED_CTX = [0, 1, 15, 16, 17, 2048, 700, 1333]
KERNEL_SHAPES = [
    # name, B, c, H, KVH, D, ps, dtype, ctx_lens
    ("a_decode_sdar8b", 8, 32, 32, 8, 128, 16, "bfloat16", RAGGED_CTX),
    ("a_decode_sdar8b_ctx2048", 8, 32, 32, 8, 128, 16, "bfloat16",
     [2048] * 8),
    ("b_ar_sdar8b", 8, 1, 32, 8, 128, 16, "bfloat16", RAGGED_CTX),
    ("c_prefill_chunk", 2, 256, 32, 8, 128, 16, "bfloat16", [0, 768]),
    ("d_fp32_d64", 4, 8, 8, 2, 64, 16, "float32", [0, 33, 100, 300]),
    # the moe and vlm families' decode: GQA groups 5 and 6 (G·c 160 and
    # 192 rows tile over the grid's x axis), head dim 112
    ("i_decode_scout", 8, 32, 40, 8, 128, 16, "bfloat16", RAGGED_CTX),
    ("j_decode_qwen2vl", 8, 32, 12, 2, 128, 16, "bfloat16", RAGGED_CTX),
    ("k_decode_kimi_k2", 8, 32, 64, 8, 112, 16, "bfloat16", RAGGED_CTX),
]


def bound(B, c, H, KVH, D, ps, dtype, ctx):
    """The card's least time for this call: the larger of the bytes it must
    move (q, the live K/V rows and table entries, ctx_lens, the outputs) over
    HBM bandwidth and its 4·Σctx·c·H·D operations over the peak rate for the
    input type.  Counts this call's data (live keys only)."""
    el = 2 if dtype == "bfloat16" else 4
    live = sum(ctx)
    nbytes = (B * c * H * D * el + live * KVH * D * 2 * el
              + sum(-(-x // ps) for x in ctx) * 4 + B * 4
              + B * c * H * (D + 2) * 4)
    ops = 4.0 * live * c * H * D
    t_b, t_o = nbytes / H100_HBM_BPS, ops / PEAK_FLOPS[dtype]
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


# The block-diffusion kernel at the wave-prefill shapes.  (e) is the SDAR-8B
# wave of 8 prompts padded to T 512 (one batch-padding row, lengths 0);
# (h) is the SMOKE config the CLI serves (head_dim 8, fp32, block 8) at
# T 48, which is not a power of two.
# (l)-(n) are the wave of (e) at the moe and vlm families' heads.
WAVE_LENGTHS = [512, 0, 130, 257, 384, 449, 200, 511]
BD_SHAPES = [
    # name, B, T, H, KVH, D, block_size, dtype, lengths
    ("e_wave_sdar8b", 8, 512, 32, 8, 128, 32, "bfloat16", WAVE_LENGTHS),
    ("f_long_sdar8b", 2, 2048, 32, 8, 128, 32, "bfloat16", [2048, 1500]),
    ("g_causal_bs1", 4, 256, 32, 8, 128, 1, "bfloat16", [256, 0, 100, 17]),
    ("h_smoke_fp32_d8", 3, 48, 8, 2, 8, 8, "float32", [48, 0, 5]),
    ("l_wave_scout", 8, 512, 40, 8, 128, 32, "bfloat16", WAVE_LENGTHS),
    ("m_wave_qwen2vl", 8, 512, 12, 2, 128, 32, "bfloat16", WAVE_LENGTHS),
    ("n_wave_kimi_k2", 8, 512, 64, 8, 112, 32, "bfloat16", WAVE_LENGTHS),
]


def bd_visible(T, bs, lengths) -> int:
    """Σ_b Σ_t of the keys query t of row b sees: min(len_b, (t//bs+1)·bs)."""
    return sum(min(min(n, T), (t // bs + 1) * bs)
               for n in lengths for t in range(T))


def bd_bound(B, T, H, KVH, D, bs, dtype, lengths):
    """The card's least time for one block-diffusion call: the larger of the
    bytes it must move over HBM bandwidth — q of the rows that see a key,
    the live K/V rows (positions < len_b), lengths and the whole output,
    each once — and its 4·D·H·Σ visible operations over the peak rate for
    the input type.  Counts this call's data."""
    el = 2 if dtype == "bfloat16" else 4
    live_rows = sum(1 for n in lengths if n > 0)
    nbytes = (live_rows * T * H * D * el
              + sum(min(n, T) for n in lengths) * KVH * D * 2 * el
              + B * 4 + B * T * H * D * el)
    ops = 4.0 * D * H * bd_visible(T, bs, lengths)
    t_b, t_o = nbytes / H100_HBM_BPS, ops / PEAK_FLOPS[dtype]
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def bd_kernel_phase(seed: int) -> list[dict]:
    """The block-diffusion kernel against its plain version at BD_SHAPES
    under each body (bf16: the tensor-core body and the CUDA-core body),
    with the time of each, the plain version's, one
    ``scaled_dot_product_attention``
    call's on the same function (rows with lengths >= 1 only: it gives NaN
    on an all-masked row; timed, never on the path) and the bound."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import block_diffusion_attn as bda

    rows = []
    for name, B, T, H, KVH, D, bs, dtype, lens in BD_SHAPES:
        td = getattr(torch, dtype)
        g = torch.Generator(device=DEVICE).manual_seed(seed)
        q = torch.randn((B, T, H, D), generator=g, device=DEVICE).to(td)
        k = torch.randn((B, T, KVH, D), generator=g, device=DEVICE).to(td)
        v = torch.randn((B, T, KVH, D), generator=g, device=DEVICE).to(td)
        ln = torch.as_tensor(lens, dtype=torch.int32, device=DEVICE)
        want = bda.block_diffusion_ref(q, k, v, ln, block_size=bs)
        bf16 = dtype == "bfloat16"
        tol = BF16_TOL if bf16 else FP32_TOL
        variants = {"picked": {}}
        if bf16:
            variants["cuda_core"] = {"body": "cuda_core"}
        err = 0.0
        for var, forced in variants.items():
            out = bda.block_diffusion_attention_kernel(
                q, k, v, ln, block_size=bs, **forced)
            torch.cuda.synchronize()
            err = max(err, float((out.float() - want.float()).abs().max()))
            torch.testing.assert_close(out.float(), want.float(), rtol=tol,
                                       atol=tol)
            if not torch.isfinite(out).all():
                raise AssertionError(f"{name} ({var}): non-finite output")
            for i in [i for i, n in enumerate(lens) if n == 0]:
                if not torch.all(out[i] == 0):
                    raise AssertionError(f"{name} ({var}): lengths-0 row {i}"
                                         f" is not 0")
        ms_by = {var: time_ms(lambda: bda.block_diffusion_attention_kernel(
            q, k, v, ln, block_size=bs, **forced))
            for var, forced in variants.items()}
        ms = ms_by["picked"]
        plain_ms = time_ms(lambda: bda.block_diffusion_ref(
            q, k, v, ln, block_size=bs))
        live = [i for i, n in enumerate(lens) if n > 0]
        pos = torch.arange(T, device=DEVICE)
        blk = torch.div(pos, bs, rounding_mode="floor")
        mask = (blk[None, :] <= blk[:, None])[None, None] & \
            (pos[None, :] < ln[live][:, None])[:, None, None, :]
        qs, ks, vs = (t[live].transpose(1, 2).contiguous()
                      for t in (q, k, v))
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, enable_gqa=True))
        b_ms, b_by = bd_bound(B, T, H, KVH, D, bs, dtype, lens)
        gflop = 4.0 * D * H * bd_visible(T, bs, lens) / 1e9
        row = {"shape": name, "B": B, "T": T, "H": H, "KVH": KVH, "D": D,
               "block_size": bs, "dtype": dtype, "lengths": lens,
               "max_abs_err": err,
               "body": "tensor_core" if bf16 else "cuda_core", "ms": ms,
               "ms_cuda_core": ms_by.get("cuda_core", ms),
               "ms_by_variant": ms_by, "plain_ms": plain_ms,
               "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
               "live_gflop": gflop, "tflops": gflop / ms,
               "kernel_over_bound": ms / b_ms}
        rows.append(row)
        times = "  ".join(f"{var} {t:.4f} ms ({gflop / t:.2f} TFLOP/s, "
                          f"{t / b_ms:.1f}x bound)"
                          for var, t in ms_by.items())
        log(f"kernel {name}: max_abs_err {err:.3e} | {times} | plain "
            f"{plain_ms:.4f} ms  sdpa {lib_ms:.4f} ms ({gflop / lib_ms:.2f} "
            f"TFLOP/s)  bound {b_ms:.5f} ms ({b_by}); {gflop:.3f} live "
            f"GFLOP")
        del q, k, v, out, want, qs, ks, vs, mask
    return rows


def paged_inputs(B, c, H, KVH, D, ps, dtype, ctx, seed: int):
    """Random q and K/V pages on the card, a random block table with room
    for the longest context, and ctx_lens: the paged kernel's arguments."""
    import numpy as np
    import torch

    td = getattr(torch, dtype)
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    n_slots = max(-(-max(ctx) // ps), 1)
    P = B * n_slots + 3
    q = torch.randn((B, c, H, D), generator=g, device=DEVICE).to(td)
    kp = torch.randn((P, ps, KVH, D), generator=g, device=DEVICE).to(td)
    vp = torch.randn((P, ps, KVH, D), generator=g, device=DEVICE).to(td)
    perm = np.random.default_rng(seed).permutation(P)[:B * n_slots]
    tables = torch.as_tensor(perm.reshape(B, n_slots), dtype=torch.int32,
                             device=DEVICE)
    lens = torch.as_tensor(ctx, dtype=torch.int32, device=DEVICE)
    return q, kp, vp, tables, lens


def check_partials(name, got, want, ctx, tol):
    """Hold paged partials against the plain version's; ctx-0 rows must be
    the exact empty partial.  Returns (max abs err, max rel err) of acc."""
    import torch

    acc, m, l = got
    acc_r, m_r, l_r = want
    e = float((acc - acc_r).abs().max())
    r = e / (float(acc_r.abs().max()) + 1e-9)
    torch.testing.assert_close(m, m_r, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(l, l_r, rtol=tol, atol=1e-5)
    if not r < tol:
        raise AssertionError(f"{name}: acc max relative error {r} >= {tol}")
    for i in [i for i, x in enumerate(ctx) if x == 0]:
        if not (torch.all(acc[i] == 0) and torch.all(l[i] == 0)
                and torch.all(m[i] == -1e30)):
            raise AssertionError(f"{name}: ctx-0 row {i} is not the empty "
                                 f"partial")
    return e, r


def kernel_phase(seed: int) -> list[dict]:
    """The paged kernel against its plain version at KERNEL_SHAPES under
    each body: bf16 the tensor-core body with the split count the wrapper
    picks and with one split, and the CUDA-core body; float32 the CUDA-core
    body under each row tiling.  Times of each, the plain version and the
    bound."""
    import torch

    from repro_torch.kernels import chunked_paged_attn as cpa

    rows = []
    for name, B, c, H, KVH, D, ps, dtype, ctx in KERNEL_SHAPES:
        args = paged_inputs(B, c, H, KVH, D, ps, dtype, ctx, seed)
        n_slots = args[3].shape[1]
        want = cpa.paged_chunk_ref(*args)
        bf16 = dtype == "bfloat16"
        tol = BF16_TOL if bf16 else FP32_TOL
        variants = {"picked": {}}
        if bf16:
            variants["tensor_core_s1"] = {"body": "tensor_core", "splits": 1}
            variants["cuda_core"] = {"body": "cuda_core"}
        else:
            variants["cuda_core_rows_1"] = {"rows_per_warp": 1}
            variants["cuda_core_rows_8"] = {"rows_per_warp": 8}
        err = rel = 0.0
        for v, forced in variants.items():
            got = cpa.paged_chunk_attention_kernel(*args, **forced)
            torch.cuda.synchronize()
            e, r = check_partials(f"{name} ({v})", got, want, ctx, tol)
            err, rel = max(err, e), max(rel, r)
        ms_by = {v: time_ms(lambda: cpa.paged_chunk_attention_kernel(
            *args, **forced)) for v, forced in variants.items()}
        plain_ms = time_ms(lambda: cpa.paged_chunk_ref(*args))
        b_ms, b_by = bound(B, c, H, KVH, D, ps, dtype, ctx)
        gflop = 4.0 * sum(ctx) * c * H * D / 1e9
        ms = ms_by["picked"]
        row = {"shape": name, "B": B, "c": c, "H": H, "KVH": KVH, "D": D,
               "page_size": ps, "n_slots": n_slots, "dtype": dtype,
               "ctx_lens": ctx, "max_abs_err": err, "max_rel_err": rel,
               "body": "tensor_core" if bf16 else "cuda_core",
               "splits": (cpa.pick_splits(B, c, H, KVH, ps, n_slots)
                          if bf16 else 1),
               "ms": ms, "ms_s1": ms_by.get("tensor_core_s1"),
               "ms_cuda_core": ms_by.get("cuda_core", ms),
               "ms_by_variant": ms_by, "plain_ms": plain_ms,
               "bound_ms": b_ms, "bound_by": b_by, "live_gflop": gflop,
               "tflops": gflop / ms, "kernel_over_bound": ms / b_ms}
        rows.append(row)
        times = "  ".join(f"{v} {t:.4f} ms ({gflop / t:.2f} TFLOP/s, "
                          f"{t / b_ms:.1f}x bound)" for v, t in ms_by.items())
        log(f"kernel {name}: max_abs_err {err:.3e} rel {rel:.3e} | {times}"
            f" | splits picked {row['splits']}  plain {plain_ms:.4f} ms  "
            f"bound {b_ms:.5f} ms ({b_by})")
        del args, got, want
    return rows


# The split merge at the SDAR-8B decode shape with a table of 2080 keys
# (33 tiles) and eight forced splits: row 0 has ctx 0, so all its splits
# are empty; row 1 has ctx 5, so only its first split is live.
MERGE_SHAPE = ("merge_sdar8b", 2, 32, 32, 8, 128, 16, "bfloat16", [0, 5])
MERGE_SPLITS = 8


def merge_phase(seed: int) -> dict:
    """The paged kernel's merge of split partials at MERGE_SHAPE: a ctx-0
    row must come out the exact empty partial, and a ctx-5 row (one live
    split merged with seven empty ones) bit-equal to the one-split run and
    within tolerance of the plain split version and the plain version."""
    import torch

    from repro_torch.kernels import chunked_paged_attn as cpa

    name, B, c, H, KVH, D, ps, dtype, ctx = MERGE_SHAPE
    args = paged_inputs(B, c, H, KVH, D, ps, dtype, [2080, 0], seed)
    q, kp, vp, tables, _ = args
    lens = torch.as_tensor(ctx, dtype=torch.int32, device=DEVICE)
    args = (q, kp, vp, tables, lens)
    before = cpa.MERGE_LAUNCHES
    split = cpa.paged_chunk_attention_kernel(*args, body="tensor_core",
                                             splits=MERGE_SPLITS)
    one = cpa.paged_chunk_attention_kernel(*args, body="tensor_core",
                                           splits=1)
    torch.cuda.synchronize()
    if cpa.MERGE_LAUNCHES != before + 1:
        raise AssertionError("merge: the split run launched no merge")
    for a, b in zip(split, one):
        if not torch.equal(a, b):
            raise AssertionError("merge: one live split merged with empty "
                                 "ones differs from the one-split run")
    e, _ = check_partials(name, split, cpa.paged_chunk_ref(*args),
                          ctx, BF16_TOL)
    e2, _ = check_partials(name, split, cpa.paged_chunk_split_ref(
        *args, splits=MERGE_SPLITS), ctx, BF16_TOL)
    log(f"merge {name} (ctx {ctx}, {MERGE_SPLITS} splits over "
        f"{tables.shape[1] * ps} table keys): ctx-0 row exact empty partial;"
        f" ctx-5 row bit-equal to one split; max abs err vs plain {e:.3e}, "
        f"vs plain split version {e2:.3e}")
    return {"shape": name, "ctx_lens": ctx, "splits": MERGE_SPLITS,
            "table_keys": int(tables.shape[1] * ps),
            "bit_equal_to_one_split": True, "max_abs_err": e,
            "max_abs_err_split_ref": e2}


# ---------------------------------------------------------------------------
# MoE layer phase
# ---------------------------------------------------------------------------

# One Llama-4 Scout layer's experts at full width (16 experts of d 5120 and
# f 8192, top-1, bf16) on T tokens: a decode dispatch (B 8 x c 32), a
# chunked-prefill tick (32 prompt tokens) and the wave of shape (e).
MOE_ARCH = "llama4-scout-17b-a16e"
MOE_TOKENS = (("decode", 256), ("prefill_chunk", 32), ("wave", 4096))


def moe_bound(cfg, T: int, n_touched: int):
    """The card's least time for the three grouped products of one MoE
    layer: the larger of the bytes they must move (the touched experts'
    three weights, the routed rows in and each product's output out, each
    once) over HBM bandwidth and their 6·C·d·f operations over the bf16
    peak, C the routed (token, expert) pairs."""
    d, f = cfg.d_model, cfg.moe_ff
    C = T * cfg.top_k
    nbytes = 2 * (3 * n_touched * d * f + C * d + 2 * C * f + C * f
                  + C * d)
    ops = 6.0 * C * d * f
    t_b, t_o = nbytes / H100_HBM_BPS, ops / PEAK_FLOPS["bfloat16"]
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def moe_layer_phase(seed: int) -> list[dict]:
    """The sorted MoE path (``_moe_local``) of one Scout layer: the CUDA
    grouped route (``torch._grouped_mm``, group sizes on the device) against
    the loop route (``grouped_matmul_loop``, sizes read on the host) on the
    same inputs, each timed, the grouped products alone timed beside their
    bound, and one grouped-route call under
    ``torch.cuda.set_sync_debug_mode("error")``, which raises on any host
    sync."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import moe

    cfg = get_config(MOE_ARCH)
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    p = {k: v[0] for k, v in moe.init_moe(g, cfg, DEVICE, 1).items()}
    w = (p["router"], p["w_gate"], p["w_up"], p["w_down"])
    log(f"moe: torch {torch.__version__}, torch._grouped_mm on bf16 "
        f"weights [E, d, f] {tuple(p['w_gate'].shape)} strides "
        f"{p['w_gate'].stride()} and [E, f, d] strides "
        f"{p['w_down'].stride()}")
    rows_out = []
    for name, T in MOE_TOKENS:
        x = torch.randn((T, cfg.d_model), generator=g, device=DEVICE).to(
            torch.bfloat16)
        calls = moe.GROUPED_CALLS
        got = moe._moe_local(x, *w, cfg=cfg)
        torch.cuda.synchronize()
        if moe.GROUPED_CALLS != calls + 3:
            raise AssertionError(f"moe {name}: the grouped route made "
                                 f"{moe.GROUPED_CALLS - calls} calls, not 3")
        exact = moe.grouped_matmul
        moe.grouped_matmul = moe.grouped_matmul_loop
        try:
            want = moe._moe_local(x, *w, cfg=cfg)
            plain_ms = time_ms(lambda: moe._moe_local(x, *w, cfg=cfg),
                               iters=10)
        finally:
            moe.grouped_matmul = exact
        err = float((got.float() - want.float()).abs().max())
        torch.testing.assert_close(got.float(), want.float(), rtol=BF16_TOL,
                                   atol=BF16_TOL)
        if not torch.isfinite(got).all():
            raise AssertionError(f"moe {name}: non-finite output")
        torch.cuda.set_sync_debug_mode("error")
        try:
            moe._moe_local(x, *w, cfg=cfg)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        # the grouped products alone, on this call's routing
        gates, ids = moe._route(x, w[0], cfg.top_k)
        order = torch.argsort(ids.reshape(-1), stable=True)
        rows = x[torch.div(order, cfg.top_k, rounding_mode="floor")]
        gsz = torch.bincount(ids.reshape(-1), minlength=cfg.n_experts).to(
            torch.int32)
        n_touched = int((gsz > 0).sum())

        def products():
            a = moe.grouped_matmul(rows, w[1], gsz)
            b = moe.grouped_matmul(rows, w[2], gsz)
            return moe.grouped_matmul(a * b, w[3], gsz)

        grouped_ms = time_ms(products, iters=10)
        layer_ms = time_ms(lambda: moe._moe_local(x, *w, cfg=cfg), iters=10)
        b_ms, b_by = moe_bound(cfg, T, n_touched)
        row = {"tokens": name, "T": T, "experts_touched": n_touched,
               "max_abs_err": err, "layer_ms": layer_ms,
               "grouped_ms": grouped_ms, "plain_layer_ms": plain_ms,
               "bound_ms": b_ms, "bound_by": b_by,
               "grouped_over_bound": grouped_ms / b_ms,
               "sync_free": True}
        rows_out.append(row)
        log(f"moe {name} (T {T}, {n_touched} experts touched): grouped vs "
            f"loop route max abs err {err:.3e}; no host sync under "
            f"set_sync_debug_mode('error'); layer {layer_ms:.4f} ms, three "
            f"grouped products {grouped_ms:.4f} ms ({grouped_ms / b_ms:.2f}x"
            f" bound {b_ms:.4f} ms, {b_by}), loop route layer "
            f"{plain_ms:.4f} ms")
        del x, got, want, rows
    del p, w
    torch.cuda.empty_cache()
    return rows_out


# ---------------------------------------------------------------------------
# model phase
# ---------------------------------------------------------------------------

MODEL_B, MODEL_C = 8, 32
MODEL_CTX = [0, 1, 17, 100, 300, 511, 1000, 2047]
PROFILE_CTX = (512, 2048)
# The model phase holds the kernel path against the plain path at these
# limits.  Each reading is (kernel path vs plain path) on one dispatch:
#   logits_rel           max |logits - logits_plain| / std(logits_plain)
#   tokens_differ_share  share of the B·c argmax tokens that differ
#   conf_rel             max |conf - conf_plain| / conf_plain
# A control run, the kernel's acc scaled by 1 + CONTROL_SKEW in every layer,
# must break the CONTROL_BREAKS limits, so the check can see a kernel that
# is a few percent off.  Both readings are printed every run.  The limits
# sit between the two readings of the first H100 run (kernel 0.305 / 0.169,
# control 0.711 / 0.325).  The token share is a cap only: bf16 rounding
# through 36 layers of random weights already flips about an eighth of the
# tokens, whose top-1/top-2 gaps are a tenth of a logit, so a 3% skew
# moves it too little to tell apart.
CONTROL_SKEW = 0.03
MODEL_LIMITS = {"logits_rel": 0.5, "conf_rel": 0.25,
                "tokens_differ_share": 0.25}
CONTROL_BREAKS = ("logits_rel", "conf_rel")


def make_pool(model, seed: int):
    """One bf16 page pool of random K/V for B 8 rows of up to 2048 + 32
    tokens, with a random block table: used by the model and profile
    phases."""
    import numpy as np
    import torch

    ps = model.cfg.kv_page_size
    n_slots = -(-(max(max(MODEL_CTX), *PROFILE_CTX) + MODEL_C) // ps)
    P = MODEL_B * n_slots
    cache = model.init_paged_cache(P, ps, dtype=torch.bfloat16,
                                   device=DEVICE)
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    for t in cache.values():
        t.copy_(torch.randn(t.shape, generator=g, device=DEVICE))
    perm = np.random.default_rng(seed).permutation(P)
    tables = torch.as_tensor(perm.reshape(MODEL_B, n_slots),
                             dtype=torch.int32, device=DEVICE)
    return cache, tables


def decode_inputs(model, ctx, seed: int):
    """A decode window (4 committed tokens, the rest masked) for each row,
    starting at ``ctx[b]``."""
    import numpy as np
    import torch

    cfg = model.cfg
    rng = np.random.default_rng(seed)
    win = np.full((MODEL_B, MODEL_C), cfg.mask_token_id, np.int64)
    win[:, :4] = rng.integers(4, cfg.vocab_size - 8, (MODEL_B, 4))
    start = torch.as_tensor(ctx, dtype=torch.int64, device=DEVICE)
    return (torch.as_tensor(win, device=DEVICE), start,
            torch.full((MODEL_B,), MODEL_C, dtype=torch.int64, device=DEVICE),
            torch.zeros(MODEL_B, dtype=torch.int64, device=DEVICE))


# The gap sweep: the decode gap check's margin with the attention of the
# dispatch taken by other paths (readings only): the tensor-core body at
# each split count, the CUDA-core body, the plain split version, and the
# plain version with P rounded to bf16 (the Pallas body's numerics).
SWEEP_SPLITS = (1, 2, 3, 4, 5, 8)
SWEEP_PLAIN_SPLITS = (2, 3, 4, 8)


def model_phase(model, params, pool, seed: int) -> dict:
    import torch

    import repro_torch.models.transformer as tfm
    from repro_torch.kernels import chunked_paged_attn as cpa
    from repro_torch.kernels.ops import softmax_confidence_device

    cfg = model.cfg
    cache, tables = pool
    win, start, valid, n_adv = decode_inputs(model, MODEL_CTX, seed)

    def dispatch(impl):
        conf, tok, _ = model.decode_step_paged(params, cache, win, start,
                                               valid, tables, start, n_adv,
                                               impl=impl)
        logits, _ = model.chunk_forward_paged(params, cache, win, start,
                                              valid, tables, start,
                                              impl=impl)
        _, t2 = softmax_confidence_device(logits)
        if not torch.equal(t2, tok):
            raise AssertionError("decode_step_paged disagrees with "
                                 "chunk_forward_paged + sampling")
        for t in (conf, logits):
            if not torch.isfinite(t).all():
                raise AssertionError(f"non-finite model output ({impl})")
        return conf, tok, logits

    cr, tr, lr = dispatch("ref")
    kernel = dispatch("kernel")
    exact = tfm.paged_chunk_attention

    def skewed(*a, **k):
        acc, m, l = exact(*a, **k)
        return acc * (1 + CONTROL_SKEW), m, l

    tfm.paged_chunk_attention = skewed
    try:
        control = dispatch("kernel")
    finally:
        tfm.paged_chunk_attention = exact
    # the phase's noise floor: the plain split version (the plain math, the
    # kernel's split of the keys, another order of the sums) on the plain
    # path — a reading only
    plain, n_keys = tfm.paged_chunk_ref, tables.shape[1] * cfg.kv_page_size
    splits = cpa.pick_splits(MODEL_B, MODEL_C, cfg.n_heads, cfg.n_kv_heads,
                             cfg.kv_page_size, tables.shape[1])
    tfm.paged_chunk_ref = lambda *a, **k: cpa.paged_chunk_split_ref(
        *a, splits=splits, **k)
    try:
        reorder = dispatch("ref")
    finally:
        tfm.paged_chunk_ref = plain
    torch.cuda.synchronize()

    readings, margin_of, gap, lr_std = decode_readings(cr, tr, lr)
    sound, ctl = readings(*kernel), readings(*control)
    ck, tk, lk = kernel
    n_diff, max_gap, margin = margin_of(tk)
    floor = {**readings(*reorder), "splits": splits}
    floor["tokens_differ"], floor["max_gap_where_differ"], \
        floor["gap_margin"] = margin_of(reorder[1])
    floor["logits_max_abs_err"] = float((reorder[2] - lr).abs().max())
    res = {"B": MODEL_B, "c": MODEL_C, "ctx_lens": MODEL_CTX,
           "tokens": tk.numel(), "tokens_differ": n_diff,
           "max_gap_where_differ": max_gap,
           "min_gap": float(gap.min()), "gap_margin": margin,
           "logits_std_plain": lr_std,
           "logits_max_abs_err": float((lk - lr).abs().max()),
           "conf_max_abs_err": float((ck - cr).abs().max()),
           "conf_plain_max": float(cr.max()), "kernel_vs_plain": sound,
           "control_skew": CONTROL_SKEW, "control_vs_plain": ctl,
           "plain_split_vs_plain": floor,
           "limits": MODEL_LIMITS, "control_breaks": CONTROL_BREAKS}
    log(f"model decode_step_paged (B {MODEL_B}, c {MODEL_C}, ctx "
        f"{MODEL_CTX}, {cfg.n_layers} layers, {cfg.compute_dtype}): tokens "
        f"differ {n_diff}/{tk.numel()} (largest top-1/top-2 gap where they "
        f"differ {res['max_gap_where_differ']:.4f}, least margin under the "
        f"bf16 tolerance {margin}); logits std "
        f"{lr_std:.4f}, max abs err {res['logits_max_abs_err']:.4f}; conf "
        f"max {res['conf_plain_max']:.3e}, max abs err "
        f"{res['conf_max_abs_err']:.3e}")
    for key, lim in MODEL_LIMITS.items():
        log(f"  {key}: kernel {sound[key]:.4f}  control (acc x "
            f"{1 + CONTROL_SKEW}) {ctl[key]:.4f}  plain split version "
            f"{floor[key]:.4f}  limit {lim}")
    log(f"  noise floor, the plain split version ({splits} splits) against "
        f"the plain version: tokens differ {floor['tokens_differ']}, "
        f"largest gap where they differ {floor['max_gap_where_differ']:.4f},"
        f" least margin {floor['gap_margin']}, logits max abs err "
        f"{floor['logits_max_abs_err']:.4f}")
    res["gap_sweep"] = sweep_margins(model_paths(cpa), dispatch, tfm,
                                     margin_of)
    if n_diff and not margin > 0:
        raise AssertionError("model: a token differs where its top-1/top-2 "
                             "logit gap exceeds the bf16 tolerance")
    check_limits("model", sound, ctl, MODEL_LIMITS, CONTROL_BREAKS)
    return res


def decode_readings(cr, tr, lr):
    """From the plain path's conf, tok and logits of one decode dispatch:
    ``readings(conf, tok, logits)`` of another path against it (the
    MODEL_LIMITS keys), ``margin_of(tok)`` (tokens that differ, the largest
    plain top-1/top-2 gap among them, and the least (tolerance - gap) over
    them: tokens may differ only where the plain gap is under the bf16
    tolerance of the top-1 logit), the plain gaps and the logits' std."""
    lr_std = float(lr.std())

    def readings(conf, tok, logits, *_):
        return {"logits_rel": float((logits - lr).abs().max()) / lr_std,
                "tokens_differ_share": float((tok != tr).float().mean()),
                "conf_rel": float(((conf - cr).abs() / cr).max())}

    top2 = lr.topk(2, dim=-1).values
    gap = top2[..., 0] - top2[..., 1]
    tol = BF16_TOL * top2[..., 0].abs().clamp(min=1.0)

    def margin_of(tok):
        diff = tok != tr
        n = int(diff.sum())
        return (n, float(gap[diff].max()) if n else 0.0,
                float((tol - gap)[diff].min()) if n else None)

    return readings, margin_of, gap, lr_std


def check_limits(what, sound, ctl, limits, breaks):
    """The kernel path's readings under their limits, and the control run's
    over each limit in ``breaks`` (else the limit could not see the
    control's error)."""
    for key, lim in limits.items():
        if not sound[key] < lim:
            raise AssertionError(f"{what}: kernel path {key} {sound[key]} >= "
                                 f"{lim}")
        if key in breaks and not ctl[key] >= lim:
            raise AssertionError(f"{what}: the control run's {key} "
                                 f"{ctl[key]} stays under {lim}, so this "
                                 f"limit cannot see a {CONTROL_SKEW:.0%} "
                                 f"error")


def model_paths(cpa):
    """(name, impl, attention function) of each gap-sweep path."""
    import torch

    kern = [(f"tensor_core S {n}", "kernel",
             lambda *a, n=n, **k: cpa.paged_chunk_attention_kernel(
                 *a, body="tensor_core", splits=n, **k))
            for n in SWEEP_SPLITS]
    kern.append(("cuda_core", "kernel",
                 lambda *a, **k: cpa.paged_chunk_attention_kernel(
                     *a, body="cuda_core", **k)))
    plain = [(f"plain split S {n}", "ref",
              lambda *a, n=n, **k: cpa.paged_chunk_split_ref(*a, splits=n,
                                                             **k))
             for n in SWEEP_PLAIN_SPLITS]
    plain.append(("plain, P rounded to bf16", "ref",
                  lambda *a, **k: cpa.paged_chunk_ref(
                      *a, p_dtype=torch.bfloat16, **k)))
    return kern + plain


def sweep_margins(paths, dispatch, tfm, margin_of) -> list[dict]:
    """The gap check's reading for each path: the decode dispatch with its
    paged attention (kernel path) or its plain attention (plain path)
    replaced by the path's function."""
    out = []
    for name, impl, fn in paths:
        slot = "paged_chunk_attention" if impl == "kernel" else \
            "paged_chunk_ref"
        keep = getattr(tfm, slot)
        setattr(tfm, slot, fn)
        try:
            tok = dispatch(impl)[1]
        finally:
            setattr(tfm, slot, keep)
        n, gap, margin = margin_of(tok)
        out.append({"path": name, "tokens_differ": n,
                    "max_gap_where_differ": gap, "gap_margin": margin})
        log(f"  gap sweep, {name}: tokens differ {n}, largest gap where "
            f"they differ {gap:.4f}, margin {margin}")
    return out


# ---------------------------------------------------------------------------
# profile phase
# ---------------------------------------------------------------------------

def profile_dispatch(dispatch, kernel: str, iters: int, n: int,
                     ops: tuple = ()) -> dict:
    """Where one dispatch's time goes: wall per dispatch (host clock around
    ``torch.cuda.synchronize``, median of ``iters``) through the kernel,
    the plain version and the kernel again, then ``torch.profiler`` over
    ``n`` kernel-path dispatches: device time, busy share of the wall, the
    share of the device kernel whose name holds ``kernel``, and the device
    time of each PyTorch op in ``ops`` (the kernels it launched)."""
    import torch

    def wall_ms(impl):
        dispatch(impl)
        ts = []
        for _ in range(iters):
            t0 = time.perf_counter()
            dispatch(impl)
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(ts)

    walls = {"kernel": [wall_ms("kernel")], "ref": [wall_ms("ref")]}
    walls["kernel"].append(wall_ms("kernel"))
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            dispatch("kernel")
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kern = sorted(((e.key, e.self_device_time_total, e.count)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA),
                  key=lambda r: -r[1])
    busy = sum(t for _, t, _ in kern)
    mine = sum(t for k, t, _ in kern if kernel in k)
    if not mine > 0:
        raise AssertionError(f"profile: {kernel} shows no device time")
    op_us = {op: sum(e.device_time_total for e in prof.key_averages()
                     if e.key == op) for op in ops}
    for op, t in op_us.items():
        if not t > 0:
            raise AssertionError(f"profile: {op} shows no device time")
    return {"wall_ms_kernel": walls["kernel"], "wall_ms_plain": walls["ref"],
            "profiled_dispatches": n,
            "wall_ms_profiled": wall_us / n / 1e3,
            "device_ms_per_dispatch": busy / n / 1e3,
            "device_busy_share": busy / wall_us,
            "kernel_ms_per_dispatch": mine / n / 1e3,
            "kernel_share_of_device": mine / max(busy, 1e-9),
            "device_kernels_per_dispatch": sum(c for *_, c in kern) / n,
            "ops": {op: {"ms_per_dispatch": t / n / 1e3,
                         "share_of_device": t / max(busy, 1e-9)}
                    for op, t in op_us.items()},
            "top": [{"name": k[:90], "ms_per_dispatch": t / n / 1e3,
                     "calls_per_dispatch": c / n} for k, t, c in kern[:8]]}


def log_profile(what: str, row: dict, kernel: str):
    log(f"profile {what}: wall ms kernel {row['wall_ms_kernel'][0]:.2f}, "
        f"{row['wall_ms_kernel'][1]:.2f}, plain {row['wall_ms_plain'][0]:.2f};"
        f" profiled wall {row['wall_ms_profiled']:.2f} ms, device "
        f"{row['device_ms_per_dispatch']:.2f} ms (busy share "
        f"{row['device_busy_share']:.3f}) in "
        f"{row['device_kernels_per_dispatch']:.0f} kernels; {kernel} kernel "
        f"{row['kernel_ms_per_dispatch']:.3f} ms (share of device "
        f"{row['kernel_share_of_device']:.3f})" + "".join(
            f"; {op} {r['ms_per_dispatch']:.3f} ms (share of device "
            f"{r['share_of_device']:.3f})" for op, r in row["ops"].items()))
    for r in row["top"]:
        log(f"  {r['ms_per_dispatch']:8.3f} ms {r['calls_per_dispatch']:6.1f}x"
            f"  {r['name']}")


def profile_phase(model, params, pool, seed: int) -> list[dict]:
    """Where one decode dispatch's time goes, at every context of
    PROFILE_CTX (:func:`profile_dispatch`, 3 profiled dispatches)."""
    cache, tables = pool
    out = []
    for ctx in PROFILE_CTX:
        win, start, valid, n_adv = decode_inputs(model, [ctx] * MODEL_B, seed)

        def dispatch(impl):
            conf, tok, _ = model.decode_step_paged(
                params, cache, win, start, valid, tables, start, n_adv,
                impl=impl)
            return conf.cpu(), tok.cpu()

        row = {"B": MODEL_B, "c": MODEL_C, "ctx": ctx,
               **profile_dispatch(dispatch, "paged_chunk_attn", 5, 3)}
        out.append(row)
        log_profile(f"ctx {ctx} (B {MODEL_B}, c {MODEL_C})", row, "paged")
    return out


# ---------------------------------------------------------------------------
# MoE model phase
# ---------------------------------------------------------------------------

# One decode_step_paged of Llama-4 Scout at full width and MOE_LAYERS deep
# (bf16, random weights drawn on the card), every context at MOE_CTX, kernel
# path vs plain path.  Top-1 routing is discontinuous: where attention's
# rounding moves a token across its router's top-1/top-2 boundary, its
# hidden state jumps to another expert's output, and the jump spreads to
# the row's later tokens and layers.  So the kernel path is held at
# MOE_LIMITS (the MODEL_LIMITS readings) with its routing pinned to the
# plain path's experts (each layer's gates from its own router
# probabilities), as the CPU tests teacher-force window tokens, and to the
# decode gap check of phase 4; the control run (the kernel's acc x (1 +
# CONTROL_SKEW), pinned the same way) must break every limit.  The limits
# sit between the two readings of the first H100 run (kernel 0.0986 /
# 0.0646 / 0.0391, control 0.3204 / 0.1689 / 0.1445).  Readings only, from
# the kernel path with its own routing: the tokens that differ and the gap
# check's margin, the (token, layer) pairs whose top-1 expert differs from
# the plain path's, the largest plain router-probability margin among them,
# and the same for the primary flips (those in a row with no flip in an
# earlier layer, so moved by attention's rounding alone); the same readings
# of the plain split version with its own routing, as the noise floor of two
# plain paths that sum in another order; and, pinned, the largest
# router-probability difference.
MOE_LAYERS, MOE_CTX = 8, 512
MOE_LIMITS = {"logits_rel": 0.2, "conf_rel": 0.12,
              "tokens_differ_share": 0.09}
MOE_CONTROL_BREAKS = tuple(MOE_LIMITS)


def moe_model_phase(model, params, pool, seed: int) -> dict:
    import torch

    import repro_torch.models.moe as moe
    import repro_torch.models.transformer as tfm
    from repro_torch.kernels import chunked_paged_attn as cpa

    cfg = model.cfg
    L = cfg.n_layers
    cache, tables = pool
    win, start, valid, n_adv = decode_inputs(model, [MOE_CTX] * MODEL_B,
                                             seed)
    route = moe._route

    def dispatch(impl, pin=None):
        """decode_step_paged, then chunk_forward_paged for the logits; each
        layer's router probabilities and own choice of experts are kept,
        and with ``pin`` ([L, T, k]) the experts used are pin's."""
        probs, ids_own = [], []

        def rec(x, router_w, top_k):
            p = torch.softmax((x @ router_w.to(x.dtype)).float(), dim=-1)
            gates, ids = route(x, router_w, top_k)
            layer = len(probs) % L
            probs.append(p)
            ids_own.append(ids)
            if pin is not None:
                ids = pin[layer]
                gates = p.gather(-1, ids.long())
                gates = gates / torch.clamp(gates.sum(-1, keepdim=True),
                                            min=1e-9)
            return gates, ids

        moe._route = rec
        try:
            conf, tok, _ = model.decode_step_paged(
                params, cache, win, start, valid, tables, start, n_adv,
                impl=impl)
            logits, _ = model.chunk_forward_paged(
                params, cache, win, start, valid, tables, start, impl=impl)
        finally:
            moe._route = route
        if len(probs) != 2 * L:
            raise AssertionError(f"moe model: {len(probs)} routings, not "
                                 f"2 x {L}")
        if not torch.equal(tfm.softmax_confidence_device(logits)[1], tok):
            raise AssertionError("moe model: decode_step_paged disagrees "
                                 "with chunk_forward_paged + sampling")
        for t in (conf, logits):
            if not torch.isfinite(t).all():
                raise AssertionError(f"moe model: non-finite output "
                                     f"({impl})")
        return (conf, tok, logits, torch.stack(probs[L:]),
                torch.stack(ids_own[L:]))

    plain = dispatch("ref")
    free = dispatch("kernel")
    kernel = dispatch("kernel", pin=plain[4])
    # the free-running noise floor: the plain split version (the plain
    # math, the kernel's split of the keys, another order of the sums) on
    # the plain path, routing free — a reading only
    plain_attn = tfm.paged_chunk_ref
    splits = cpa.pick_splits(MODEL_B, MODEL_C, cfg.n_heads, cfg.n_kv_heads,
                             cfg.kv_page_size, tables.shape[1])
    tfm.paged_chunk_ref = lambda *a, **k: cpa.paged_chunk_split_ref(
        *a, splits=splits, **k)
    try:
        reorder = dispatch("ref")
    finally:
        tfm.paged_chunk_ref = plain_attn
    exact = tfm.paged_chunk_attention

    def skewed(*a, **k):
        acc, m, l = exact(*a, **k)
        return acc * (1 + CONTROL_SKEW), m, l

    tfm.paged_chunk_attention = skewed
    try:
        control = dispatch("kernel", pin=plain[4])
    finally:
        tfm.paged_chunk_attention = exact
    torch.cuda.synchronize()
    readings, margin_of, gap, lr_std = decode_readings(*plain[:3])
    sound, ctl = readings(*kernel), readings(*control)
    pinned_margin = margin_of(kernel[1])
    p_plain, top_plain = plain[3], plain[4][..., 0]

    def own_routing(run):
        """A run with its own routing against the plain path: the
        readings, the gap check, and the (token, layer) pairs whose top-1
        expert differs — primary where no earlier layer of that row
        flipped — with the plain router-probability margins among them."""
        n_diff, max_gap, margin = margin_of(run[1])
        top = run[4][..., 0]
        flips = top_plain != top                              # [L, B·c]
        fmargin = (p_plain.gather(-1, top_plain[..., None].long())
                   - p_plain.gather(-1, top[..., None].long()))[..., 0]
        by_row = flips.reshape(L, MODEL_B, MODEL_C).any(-1)   # [L, B]
        earlier = torch.cumsum(by_row.int(), 0) - by_row.int() > 0
        primary = flips & ~earlier.repeat_interleave(MODEL_C, dim=1)
        n_flips, n_primary = int(flips.sum()), int(primary.sum())
        return {"vs_plain": readings(*run), "tokens_differ": n_diff,
                "max_gap_where_differ": max_gap, "gap_margin": margin,
                "expert_flips": n_flips, "routed_pairs": flips.numel(),
                "flips_by_layer": flips.sum(-1).tolist(),
                "largest_router_margin_where_flipped":
                    float(fmargin[flips].max()) if n_flips else None,
                "primary_flips": n_primary,
                "largest_router_margin_primary":
                    float(fmargin[primary].max()) if n_primary else None}

    def log_own(what, o):
        log(f"  {what}: tokens differ {o['tokens_differ']}/{res['tokens']} "
            f"(largest top-1/top-2 gap where they differ "
            f"{o['max_gap_where_differ']:.4f}, gap check margin "
            f"{o['gap_margin']}); top-1 expert differs in "
            f"{o['expert_flips']} of {o['routed_pairs']} (token, layer) "
            f"pairs, by layer {o['flips_by_layer']}, largest plain "
            f"router-probability margin among them "
            f"{o['largest_router_margin_where_flipped']}; "
            f"{o['primary_flips']} primary flips, largest margin among them "
            f"{o['largest_router_margin_primary']}; logits_rel "
            f"{o['vs_plain']['logits_rel']:.4f}, conf_rel "
            f"{o['vs_plain']['conf_rel']:.4f}")

    res = {"arch": cfg.name, "layers": L, "B": MODEL_B, "c": MODEL_C,
           "ctx": MOE_CTX, "tokens": free[1].numel(),
           "logits_std_plain": lr_std, "kernel_vs_plain": sound,
           "control_skew": CONTROL_SKEW, "control_vs_plain": ctl,
           "limits": MOE_LIMITS, "control_breaks": MOE_CONTROL_BREAKS,
           "routing": "pinned to the plain path's experts",
           "pinned_tokens_differ": pinned_margin[0],
           "pinned_gap_margin": pinned_margin[2],
           "pinned_router_prob_max_diff":
               float((kernel[3] - p_plain).abs().max())}
    res["own_routing"] = own_routing(free)
    res["plain_split_own_routing"] = {**own_routing(reorder),
                                      "splits": splits}
    log(f"moe model decode_step_paged ({cfg.name}, {L} layers at full "
        f"width, B {MODEL_B}, c {MODEL_C}, ctx {MOE_CTX}, "
        f"{cfg.compute_dtype}); own routing, readings:")
    log_own("kernel path", res["own_routing"])
    log_own(f"noise floor, the plain split version ({splits} splits)",
            res["plain_split_own_routing"])
    log(f"  routing pinned to the plain path's: tokens differ "
        f"{pinned_margin[0]} (gap check margin {pinned_margin[2]}), router "
        f"probabilities differ by at most "
        f"{res['pinned_router_prob_max_diff']:.3e}")
    for key, lim in MOE_LIMITS.items():
        log(f"  {key} (pinned): kernel {sound[key]:.4f}  control (acc x "
            f"{1 + CONTROL_SKEW}) {ctl[key]:.4f}  limit {lim}")
    if pinned_margin[0] and not pinned_margin[2] > 0:
        raise AssertionError("moe model: with pinned routing a token "
                             "differs where its top-1/top-2 logit gap "
                             "exceeds the bf16 tolerance")
    check_limits("moe model", sound, ctl, MOE_LIMITS, MOE_CONTROL_BREAKS)

    def head_only(impl):
        conf, tok, _ = model.decode_step_paged(params, cache, win, start,
                                               valid, tables, start, n_adv,
                                               impl=impl)
        return conf.cpu(), tok.cpu()

    res["profile"] = profile_dispatch(head_only, "paged_chunk_attn", 5, 3,
                                      ops=("aten::_grouped_mm",))
    log_profile(f"moe decode ({cfg.name}, ctx {MOE_CTX})", res["profile"],
                "paged")
    return res


# ---------------------------------------------------------------------------
# prefill model phase
# ---------------------------------------------------------------------------

# One wave prefill_paged dispatch at shape (e), kernel path vs plain path.
# Readings (live rows, lengths >= 1):
#   logits_rel      max |logits - logits_plain| / std(logits_plain)
#   conf_rel        max |conf - conf_plain| / conf_plain
#   pages_rel       max |pages - pages_plain| / std(pages_plain) over every
#                   K/V row the dispatch wrote (36 layers)
#   tokens_differ   argmax tokens that differ (of 7)
# A control run, the kernel's output scaled by 1 + CONTROL_SKEW in every
# layer, must break the PREFILL_CONTROL_BREAKS limits.  Both readings are
# printed every run.  The limits sit between the two readings of the first
# H100 run (kernel 0.090 / 0.032 / 0.117, control 0.288 / 0.064 / 0.334);
# the token count is a reading only (7 tokens, none differed in either).
PREFILL_LIMITS = {"logits_rel": 0.18, "conf_rel": 0.048, "pages_rel": 0.22}
PREFILL_CONTROL_BREAKS = ("logits_rel", "conf_rel", "pages_rel")


def prefill_model_phase(model, params, pool, seed: int) -> dict:
    import numpy as np
    import torch

    import repro_torch.models.transformer as tfm
    from repro_torch.kernels.ops import softmax_confidence_device

    cfg = model.cfg
    cache, tables = pool
    name, B, T, *_, lens = BD_SHAPES[0]
    rng = np.random.default_rng(seed + 7)
    toks = np.zeros((B, T), np.int64)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(4, cfg.vocab_size - 8, n)
    toks = torch.as_tensor(toks, device=DEVICE)
    ln = torch.as_tensor(lens, dtype=torch.int32, device=DEVICE)
    live = [i for i, n in enumerate(lens) if n > 0]
    L, P, ps, KVH, hd = cache["k_pages"].shape
    pos = torch.arange(T, device=DEVICE)[None].expand(B, T)
    dest = tfm._page_dest(tables, pos, pos < ln[:, None].long(), ps, P)
    dest = dest.reshape(-1)
    dest = dest[dest < P * ps]

    def dispatch(impl):
        logits, _ = model.prefill_paged(params, cache, toks, ln, tables,
                                        head_mode="logits", impl=impl)
        conf, tok = softmax_confidence_device(logits)
        written = torch.cat([cache[n].view(L, P * ps, KVH, hd)[:, dest]
                             for n in ("k_pages", "v_pages")]).float()
        for t in (logits, written):
            if not torch.isfinite(t).all():
                raise AssertionError(f"prefill: non-finite output ({impl})")
        return conf[live], tok[live], logits[live], written

    cr, tr, lr, wr = dispatch("ref")
    kernel = dispatch("kernel")
    (cs, ts), _ = model.prefill_paged(params, cache, toks, ln, tables,
                                      head_mode="sample")
    if not torch.equal(ts[live], kernel[1]):
        raise AssertionError("prefill head_mode 'sample' disagrees with "
                             "'logits' + sampling")
    exact = tfm.block_diffusion_attention

    def skewed(*a, **k):
        return exact(*a, **k) * (1 + CONTROL_SKEW)

    tfm.block_diffusion_attention = skewed
    try:
        control = dispatch("kernel")
    finally:
        tfm.block_diffusion_attention = exact
    torch.cuda.synchronize()
    lr_std, wr_std = float(lr.std()), float(wr.std())

    def readings(conf, tok, logits, written):
        return {"logits_rel": float((logits - lr).abs().max()) / lr_std,
                "conf_rel": float(((conf - cr).abs() / cr).max()),
                "pages_rel": float((written - wr).abs().max()) / wr_std,
                "tokens_differ": int((tok != tr).sum())}

    sound, ctl = readings(*kernel), readings(*control)
    top2 = lr.topk(2, dim=-1).values

    def head_only(impl):
        (conf, tok), _ = model.prefill_paged(params, cache, toks, ln, tables,
                                             head_mode="sample", impl=impl)
        return conf.cpu(), tok.cpu()

    prof = profile_dispatch(head_only, "block_diffusion_attn", 3, 2)
    log_profile(f"prefill_paged {name}", prof, "block-diffusion")
    res = {"shape": name, "B": B, "T": T, "lengths": lens,
           "live_rows": len(live), "written_kv_rows": int(dest.numel()),
           "logits_std_plain": lr_std, "pages_std_plain": wr_std,
           "min_top2_gap_plain": float((top2[:, 0] - top2[:, 1]).min()),
           "kernel_vs_plain": sound, "control_skew": CONTROL_SKEW,
           "control_vs_plain": ctl, "limits": PREFILL_LIMITS,
           "control_breaks": PREFILL_CONTROL_BREAKS, "profile": prof}
    log(f"model prefill_paged ({name}: B {B}, T {T}, lengths {lens}, "
        f"{cfg.n_layers} layers, {cfg.compute_dtype}): logits std "
        f"{lr_std:.4f}, pages std {wr_std:.4f}, {res['written_kv_rows']} "
        f"K/V rows written a layer; least top-1/top-2 gap (plain) "
        f"{res['min_top2_gap_plain']:.4f}")
    for key in sound:
        log(f"  {key}: kernel {sound[key]}  control (out x "
            f"{1 + CONTROL_SKEW}) {ctl[key]}  limit "
            f"{PREFILL_LIMITS.get(key, 'none (a reading)')}")
    check_limits("prefill", sound, ctl, PREFILL_LIMITS,
                 PREFILL_CONTROL_BREAKS)
    return res


# ---------------------------------------------------------------------------
# serving phase (the main path)
# ---------------------------------------------------------------------------

def record_gaps(be, gaps: dict):
    """While a diffusion run serves, note for every committed token the
    top-1/top-2 logit gap of the decode dispatch that committed it:
    ``gaps[id(state)][output index] = gap``.  Hooks the decode sampler and
    the batched commit; undo with the returned function."""
    import numpy as np

    import repro_torch.models.transformer as tfm
    import repro_torch.serving.backends as backends

    sampler, commit = tfm.softmax_confidence_device, backends.batch_apply_step
    last = {}

    def sample(logits):
        if logits.dim() == 3:                 # decode [B, c, V]
            top2 = logits.topk(2, dim=-1).values
            last["gap"] = top2[..., 0] - top2[..., 1]
        return sampler(logits)

    def apply(states, conf, tok, valid, cai):
        frozen = [st.frozen for st in states]
        mask, n_adv = commit(states, conf, tok, valid, cai)
        gap = last.pop("gap").float().cpu().numpy()
        for i, st in enumerate(states):
            row = gaps.setdefault(id(st), {})
            for j in np.nonzero(mask[i])[0]:
                row[frozen[i] + int(j)] = float(gap[i, j])
        return mask, n_adv

    tfm.softmax_confidence_device = sample
    backends.batch_apply_step = apply

    def undo():
        tfm.softmax_confidence_device = sampler
        backends.batch_apply_step = commit
    return undo


def serve_run(model, params, mode: str, reqs, max_len: int) -> dict:
    """One serving run: ``mode`` "elastic" (chunked prefill), "ar", or
    "wave" (the elastic run with wave prefill)."""
    import torch

    from repro_torch.core.latency_model import CPU_HOST, AnalyticDeviceModel
    from repro_torch.core.scheduler import ElasticScheduler, FixedScheduler
    from repro_torch.kernels import block_diffusion_attn as bda
    from repro_torch.kernels import chunked_paged_attn as cpa
    from repro_torch.models import moe
    from repro_torch.serving import DATASETS, ModelBackend, ServingEngine

    cfg = model.cfg
    wave = mode == "wave"
    sorted_moe = moe.takes_sorted_path(cfg)   # grouped products, every layer
    be = ModelBackend(model, params, n_slots=8, max_len=max_len,
                      decode_mode="ar" if mode == "ar" else "elastic",
                      cache_dtype=torch.bfloat16, device=DEVICE,
                      prefill_mode="wave" if wave else "chunked")
    if mode in ("elastic", "wave"):   # as launch/serve.py builds it
        sched = ElasticScheduler.from_analytic(
            AnalyticDeviceModel(cfg, CPU_HOST),
            prior_tokens_per_step=DATASETS["sharegpt"].tokens_per_step_bd32,
            batches=(1, 2, 4, 8), ctx=128.0)
    else:
        sched = FixedScheduler(1)
    shapes = {"decode": [], "prefill": []}

    def record(kind, fn):
        def wrapped(params, cache, tokens, *a, **k):
            shapes[kind].append(tuple(tokens.shape))
            return fn(params, cache, tokens, *a, **k)
        return wrapped

    prefill_fn = "prefill_paged" if wave else "prefill_chunk_paged"
    model.decode_step_paged = record("decode", type(model).decode_step_paged
                                     .__get__(model))
    setattr(model, prefill_fn, record("prefill", getattr(type(model),
                                                         prefill_fn)
                                      .__get__(model)))
    outs, gaps, gap_of = {}, {}, {}
    release = be.release

    def spy(rid):
        st = be.state(rid)
        outs[rid] = st.output_tokens
        gap_of[rid] = gaps.pop(id(st), {})
        release(rid)

    be.release = spy
    ptrs = (be.kv.k_pages.data_ptr(), be.kv.v_pages.data_ptr())
    eng = ServingEngine(be, sched, max_batch=8)
    undo = record_gaps(be, gaps) if wave else (lambda: None)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cpa.LAUNCHES = cpa.MERGE_LAUNCHES = bda.LAUNCHES = 0
    moe.GROUPED_CALLS = 0
    t0 = time.perf_counter()
    try:
        rep = eng.run(list(reqs))
        torch.cuda.synchronize()
    finally:
        undo()
    wall = time.perf_counter() - t0
    launches, bd_launches = cpa.LAUNCHES, bda.LAUNCHES
    merges, grouped = cpa.MERGE_LAUNCHES, moe.GROUPED_CALLS
    delattr(model, prefill_fn)
    del model.decode_step_paged

    n_dec, n_pre = be.decode_dispatches, be.prefill_dispatches
    tokens = sum(len(v) for v in outs.values())
    dec_bytes = sum(8 * b * c for b, c in shapes["decode"])
    pre_bytes = sum(8 * b for b, _ in shapes["prefill"])
    res = {"arch": cfg.name, "layers": cfg.n_layers, "mode": mode,
           "requests": len(rep.metrics),
           "tokens_committed": tokens, "decode_dispatches": n_dec,
           "prefill_dispatches": n_pre, "kernel_launches": launches,
           "merge_launches": merges, "bd_kernel_launches": bd_launches,
           "grouped_mm_calls": grouped,
           "prefill_shapes": shapes["prefill"],
           "host_bytes_per_decode_dispatch": dec_bytes / max(n_dec, 1),
           "wall_s": wall, "tok_per_s": tokens / wall,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "chunks": sorted({c for _, c in shapes["decode"]}),
           "batches": sorted({b for b, _ in shapes["decode"]})}
    log(f"serve {cfg.name} ({cfg.n_layers} layers) {mode}: "
        f"{res['requests']} requests finished, {tokens} "
        f"tokens committed, {n_dec} decode + {n_pre} prefill dispatches, "
        f"{launches} paged ({merges} with a split merge) + {bd_launches} "
        f"block-diffusion kernel launches, {grouped} grouped products, "
        f"prefill shapes {sorted(set(shapes['prefill']))}, "
        f"{res['host_bytes_per_decode_dispatch']:.1f}"
        f" host bytes per decode dispatch, {wall:.3f} s wall, "
        f"{res['tok_per_s']:.2f} committed tok/s, max_memory_allocated "
        f"{res['max_memory_allocated']} B, chunks {res['chunks']}, "
        f"batches {res['batches']}")

    checks = [
        (len(rep.metrics) == len(reqs), "not every request finished"),
        (all(len(outs[r.rid]) == r.max_new_tokens for r in reqs),
         "a request committed the wrong number of tokens"),
        (all(0 <= t < cfg.vocab_size for v in outs.values() for t in v),
         "a committed token is outside the vocabulary"),
        (n_dec == len(shapes["decode"]) and n_pre == len(shapes["prefill"]),
         "dispatch counters disagree with the dispatches made"),
        (wave or launches == cfg.n_layers * (n_dec + n_pre),
         f"{launches} kernel launches != {cfg.n_layers} x {n_dec + n_pre} "
         f"dispatches"),
        (merges <= launches, f"{merges} merge launches > {launches} paged "
         f"launches"),
        (wave or bd_launches == 0,
         f"{bd_launches} block-diffusion launches in a chunked run"),
        (not wave or launches == cfg.n_layers * n_dec,
         f"{launches} paged launches != {cfg.n_layers} x {n_dec} decode "
         f"dispatches"),
        (not wave or bd_launches == cfg.n_layers * n_pre > 0,
         f"{bd_launches} block-diffusion launches != {cfg.n_layers} x "
         f"{n_pre} prefill dispatches"),
        (grouped == (3 * cfg.n_layers * (n_dec + n_pre) if sorted_moe
                     else 0),
         f"{grouped} grouped products != 3 x {cfg.n_layers} MoE layers x "
         f"{n_dec + n_pre} dispatches"),
        (be.host_transfer_bytes == dec_bytes + pre_bytes,
         "host bytes != 8·Bp·c per decode + 8·Bp per prefill dispatch"),
        ((be.kv.k_pages.data_ptr(), be.kv.v_pages.data_ptr()) == ptrs,
         "the page pool moved"),
        (be.kv.free_pages == be.kv.n_pages, "pages leaked"),
    ]
    for ok, msg in checks:
        if not ok:
            raise AssertionError(f"serve {cfg.name} {mode}: {msg}")
    res["outputs"] = {r.rid: outs[r.rid] for r in reqs}
    res["gaps"] = gap_of
    return res


def compare_runs(wave: dict, chunked: dict) -> dict:
    """Committed tokens of the wave run against the chunked elastic run on
    the same requests: the share that differ, and the least top-1/top-2
    logit gap (wave run) among the tokens that differ.  The runs differ in
    the prefill kernel's bf16 rounding and in the chunks the elastic
    scheduler picks (it sees the whole backlog at once in wave mode), so
    this is a reading, not a check."""
    total, diff, gaps, first = 0, 0, [], {}
    for rid, toks in chunked["outputs"].items():
        mine = wave["outputs"][rid]
        total += len(toks)
        for i, (a, b) in enumerate(zip(mine, toks)):
            if a != b:
                diff += 1
                first.setdefault(rid, i)
                if i in wave["gaps"].get(rid, {}):
                    gaps.append(wave["gaps"][rid][i])
    out = {"tokens": total, "tokens_differ": diff,
           "tokens_differ_share": diff / max(total, 1),
           "requests_identical": len(chunked["outputs"]) - len(first),
           "first_divergence": first,
           "least_gap_where_differ": min(gaps) if gaps else None,
           "gap_at_first_divergence": {
               rid: wave["gaps"].get(rid, {}).get(i)
               for rid, i in first.items()}}
    log(f"wave vs chunked elastic ({wave['arch']}): {diff}/{total} "
        f"committed tokens differ "
        f"(share {out['tokens_differ_share']:.4f}), "
        f"{out['requests_identical']} of {len(chunked['outputs'])} requests "
        f"identical; first divergence by request {first}; least top-1/top-2 "
        f"gap among the differing tokens (wave run) "
        f"{out['least_gap_where_differ']}, at each first divergence "
        f"{out['gap_at_first_divergence']}")
    return out


def make_requests(cfg, seed: int, n: int, prompt: tuple, new: tuple):
    import numpy as np

    from repro_torch.serving import Request
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        p = int(rng.integers(prompt[0], prompt[1] + 1))
        out.append(Request(rid=i, arrival_time=0.0, prompt_len=p,
                           max_new_tokens=int(rng.integers(new[0],
                                                           new[1] + 1)),
                           prompt_tokens=rng.integers(
                               4, cfg.vocab_size - 8, p).tolist()))
    return out


# ---------------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="also write every result as JSON to this path")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the repository's src/repro_torch is not beside "
              f"{Path(__file__).name}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))

    card = card_line()
    log(f"card: {card}")
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models import build_model

    t0 = time.perf_counter()
    libs = build.build(build.all_sources())
    build_s = time.perf_counter() - t0
    log(f"built {sorted(libs)} in {build_s:.2f} s")
    ptxas = [r for path in libs.values()
             for r in ptxas_report(Path(str(path) + ".log").read_text())]
    for r in ptxas:
        log(f"  ptxas: {r['kernel']}: {r['registers']} registers, "
            f"{r['spill_bytes']} bytes spilled")

    kern_rows = kernel_phase(args.seed)
    merge_res = merge_phase(args.seed)
    bd_rows = bd_kernel_phase(args.seed)
    torch.cuda.empty_cache()
    moe_rows = moe_layer_phase(args.seed)

    def draw(cfg):
        model = build_model(cfg)
        t0 = time.perf_counter()
        params = model.init_params(
            torch.Generator(device=DEVICE).manual_seed(args.seed),
            device=DEVICE)
        torch.cuda.synchronize()
        n_params = sum(t.numel() for t in params.values())
        log(f"{cfg.name} ({cfg.n_layers} layers) params: {n_params} "
            f"({cfg.param_dtype}) drawn on the card in "
            f"{time.perf_counter() - t0:.2f} s")
        return model, params

    def free(what):
        # a backend's hooks form reference cycles: collect them, so the
        # model's weights are gone before the next model is drawn
        gc.collect()
        torch.cuda.empty_cache()
        log(f"{what} freed: {torch.cuda.memory_allocated()} B still "
            f"allocated")

    # the elastic request shape of every model, made anew for each run (the
    # engine stamps requests)
    elastic_reqs = lambda cfg: make_requests(  # noqa: E731
        cfg, args.seed, 8, (128, 512), (64, 128))

    cfg = get_config("sdar-8b")
    model, params = draw(cfg)
    pool = make_pool(model, args.seed)
    model_res = model_phase(model, params, pool, args.seed)
    profile_res = profile_phase(model, params, pool, args.seed)
    prefill_res = prefill_model_phase(model, params, pool, args.seed)
    del pool
    torch.cuda.empty_cache()

    runs = [serve_run(model, params, "elastic", elastic_reqs(cfg),
                      max_len=1024)]
    torch.cuda.empty_cache()
    runs.append(serve_run(model, params, "ar",
                          make_requests(cfg, args.seed + 1, 4, (128, 256),
                                        (16, 32)), max_len=512))
    torch.cuda.empty_cache()
    runs.append(serve_run(model, params, "wave", elastic_reqs(cfg),
                          max_len=1024))
    wave_vs_chunked = {"sdar-8b": compare_runs(runs[2], runs[0])}
    del model, params
    free("sdar-8b")

    # Llama-4 Scout at full width, MOE_LAYERS deep (the card's 80 GB)
    cfg = get_config(MOE_ARCH).replace(n_layers=MOE_LAYERS)
    model, params = draw(cfg)
    pool = make_pool(model, args.seed)
    moe_model_res = moe_model_phase(model, params, pool, args.seed)
    del pool
    torch.cuda.empty_cache()
    runs.append(serve_run(model, params, "elastic", elastic_reqs(cfg),
                          max_len=1024))
    del model, params
    free(cfg.name)

    # Qwen2-VL-2B at full width and depth, text only
    cfg = get_config("qwen2-vl-2b")
    model, params = draw(cfg)
    runs.append(serve_run(model, params, "elastic", elastic_reqs(cfg),
                          max_len=1024))
    torch.cuda.empty_cache()
    runs.append(serve_run(model, params, "wave", elastic_reqs(cfg),
                          max_len=1024))
    wave_vs_chunked[cfg.name] = compare_runs(runs[-1], runs[-2])
    del model, params
    free(cfg.name)
    for r in runs:
        del r["outputs"], r["gaps"]

    head = kern_rows[0]
    kernels = [{
        "name": "paged_chunk_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/chunked_paged_attn.cu",
        "replaces": "src/repro/kernels/chunked_paged_attn.py:85",
        "launches": sum(r["kernel_launches"] for r in runs),
        "merge_launches": sum(r["merge_launches"] for r in runs),
        "max_abs_err": max(r["max_abs_err"] for r in kern_rows),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": None,
        "ms_cuda_core": head["ms_cuda_core"], "splits": head["splits"],
        "shape": head["shape"],
        "shapes": kern_rows, "merge": merge_res,
    }, {
        "name": "block_diffusion_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/block_diffusion_attn.cu",
        "replaces": "src/repro/kernels/block_diffusion_attn.py:86",
        "launches": sum(r["bd_kernel_launches"] for r in runs),
        "max_abs_err": max(r["max_abs_err"] for r in bd_rows),
        "ms": bd_rows[0]["ms"], "plain_ms": bd_rows[0]["plain_ms"],
        "bound_ms": bd_rows[0]["bound_ms"],
        "bound_by": bd_rows[0]["bound_by"],
        "library_ms": bd_rows[0]["library_ms"],
        "ms_cuda_core": bd_rows[0]["ms_cuda_core"], "splits": 1,
        "shape": bd_rows[0]["shape"],
        "shapes": bd_rows,
    }]
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"card": card, "build_s": build_s, "ptxas": ptxas,
             "kernels": kernels, "moe_layer": moe_rows,
             "model": model_res, "profile": profile_res,
             "prefill_model": prefill_res, "moe_model": moe_model_res,
             "serve": runs, "wave_vs_chunked": wave_vs_chunked}, indent=1))
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
