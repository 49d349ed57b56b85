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
   and 6, head dim 112; the hybrid's: (o) the slot view, one page of
   640 tokens a request, (p) the [1, 640] prefill; and SeamlessM4T's, G 1
   and head dim 64: (q) the decoder's slot read, (r) its cross read, (s)
   the bidirectional encoder), under each body (bf16: the tensor-core body the
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
7b. cluster phase: two SDAR-8B replicas built by ``build_model_cluster``
   sharing the weights on the card, each with its own bf16 page pool, serve
   12 requests (the first 8 are phase 7's elastic requests) through
   ``ClusterEngine`` — (i) chunked prefill behind the saturation router,
   (ii) wave prefill behind round robin — every replica routed, every pool
   in place and drained, the second replica's pool the only memory it
   adds, launches = layers x dispatches of each kernel's kind; then
   (iii) the migration drill: a request force-spilled after 8 committed
   tokens, migrated to a peer, finishing there with the ticket's and the
   swapped-in pages' bytes equal to the source's and the tokens of an
   uninterrupted run;
7c. sharded pool phase: split-KV on an S-shard ``kv`` mesh whose every
   shard is this card (``make_kv_mesh(S, devices=[DEVICE] * S)``): (i)
   ``split_kv_paged_partial`` at shape (a) for S 2 and 4 with tables from a
   striped allocator, against the unsharded kernel and the plain versions
   (a ctx-0 row exact, a one-shard row bit-equal to its shard's partial),
   timed for S 1, 2, 4; (ii) one full-width decode dispatch with S 4
   against the same dispatch unsharded, at phase 4's limits, the first
   layer's paged-prefix partial held at its call site against a control
   with one shard's acc skewed; (iii) phase 7's elastic requests served by
   ``ModelBackend(kv_shards=4)`` with chunked prefill and ``kv_shards=2``
   with wave prefill: paged launches = S x layers x paged-reading
   dispatches, device dispatches and collective bytes as the backend's
   formula, every shard block in place, the pools drained, and at each
   request's first decode dispatch that commits otherwise than phase 7's
   unsharded run in the same window, every difference within the bf16
   rule; the requests that commit phase 7's tokens a reading;
8. the moe family: Llama-4 Scout at full width, 8 of its 48 layers (the
   card's 80 GB), random weights drawn on the card: one decode dispatch
   kernel path vs plain path as in phase 4, with the kernel path's routing
   pinned to the plain path's experts (with its own routing, the (token,
   layer) pairs whose top-1 expert flips are readings, beside the same
   readings of the plain split version as the noise floor), profiled as in
   phase 5 (the grouped products' device time too), then the elastic
   serving run of phase 7;
8b. expert parallelism: a one-card (data 2, model 4) mesh (every shard
   this card; 4 of Scout's 16 experts a shard, f split 2 x 4096): (i) one
   Scout layer (phase 8's weights) at T 256 and 32 through
   ``moe_block_sharded`` (``training_rules``) and ``moe_block_2d``
   (``serving_rules(moe_2d=True)``), each against the unsharded sorted path
   at capacity factor 0 (sharded at the fp32 tolerance, 2d at bf16) and
   against the plain grouped loop on the same shards; at the configured
   capacity factor each body's time, its 3 x 8 grouped calls, the pairs it
   drops and its analytic collective bytes; (ii) phase 8's decode dispatch
   on the mesh under ``serving_rules(moe_2d=True)`` through the paged
   kernel, its routing pinned as phase 8's, held at phase 8's limits and
   the bf16 rule, one dispatch counted (paged launches = layers, grouped
   calls = 3 x 8 x layers) and profiled; (iii) one training step of Scout
   at full width, 1 layer (phase 8's layer 0, copied), B 2 x 512, on the
   mesh under ``training_rules`` against the same step with no mesh (loss
   and every gradient), ``torch._grouped_mm``'s own backward read, AdamW
   steps (bf16 state) timed with their peak memory, and the MoE leaves and
   moments saved and restored under another spec byte-exact;
9. the vlm family: Qwen2-VL-2B at full width and depth (text only) served
   elastic with chunked prefill and with wave prefill, as in phase 7;
10. the ssm family: RWKV6-1.6B at full width and depth (24 layers, d_model
   2048, bf16, random weights drawn on the card) on the dense-slot path: one
   ``prefill`` of a [1, 640] padded prompt and one AR ``advance_states`` at
   B 8, T 1, each against the same dispatch with the weights in fp32
   (readings: no hand kernel runs here); then phase 16 on its weights;
11. the hybrid family: Jamba-1.5-Large at full width cut to one period (8
   layers) and 10 experts (the card's 80 GB): phase 16 on its weights;
   then one ``prefill`` of a [1, 640] padded prompt (block-diffusion kernel vs
   plain) and one ``chunk_forward`` at B 8, c 32 with every slot at ctx 512
   (the paged kernel on the slot view vs plain), MoE routing pinned to the
   plain path's experts, held at limits their controls must break
   (free-running expert flips, and the plain split version's, as
   readings), and the ``chunk_forward`` profiled (the Mamba scans', the
   paged kernel's and ``_grouped_mm``'s device time);
12. training on the card: (a) ``Trainer`` on SDAR-8B at full width cut to
   4 of 36 layers (2.016B params; B 4 x 1024 tokens, block-diffusion loss,
   remat, fp32 AdamW moments): one step's gradients (every leaf's norm
   above 0; 2 microbatches against 1 within the bf16 tolerance), the
   training route's forward against ``apply(impl="kernel")`` at a limit
   its x1.03 control must break, 10 steps (the loss falls; no hand kernel
   launches), the restart drill (checkpoint at step 5, failure at 7,
   resume: the final loss matches; both replay the captured step), one
   step profiled; (b) ``python -m
   repro_torch.launch.train`` on smollm-135m at full width and depth in a
   subprocess (20 steps, the loss falls); (c) 2 steps of ``encdec_loss`` on
   SeamlessM4T-large-v2 at full width and depth (finite, every leaf's
   gradient norm above 0);
13. the encoder-decoder family: SeamlessM4T-large-v2 at full width and
   depth (24 + 24 layers, random weights drawn on the card): 8 sources
   admitted (block-diffusion launches = 24 encoder layers x 1 admission),
   8 block-pinned windows of c 32 (paged launches = 2 x 24 layers x 8
   windows, self and cross reads of the slot views), the caches in place,
   finite logits; the first layer's encoder, self-read and cross-read
   outputs against the plain path at limits their controls must break; one
   window profiled;
14. analysis: (i) ``python -m repro_torch.analysis.check --device cuda
   --kv-shards 1,2`` as a function call (0 active findings on the audit
   model at 1 and 2 shards of this card), each seeded dispatch fixture on
   CUDA tensors firing exactly its rule, the sync counter against an
   ``.item()`` control; (ii) Pass 1 at full width: the inventory's entries
   built on SDAR-8B (36 layers, phase 7's weights drawn again from the
   seed) with every row live — decode at B 8, c 32, ctx 512 and a chunked
   prefill of 512 after 512 through the paged kernel, the wave at B 8, T
   512 through the block-diffusion kernel, ``copy_pages``, ``write_pages``
   — at 1 and 2 shards: rules HLO001-005 (HLO003 with each dispatch's sync
   count) and HLO006 give no finding, launches = layers x dispatches; (iii)
   the dry run (``repro_torch.launch.dryrun`` on ``meta``, in a subprocess
   started after the build) of SDAR-8B decode_32k cut to 2 layers and
   SmolLM-135M train_4k cut to 2 layers at 16 microbatches, each on a 1 x 1
   mesh, against the same step on the card: argument bytes vs
   ``memory_allocated()`` (equal within the allocator's rounding), the
   predicted peak vs ``max_memory_allocated()``, the trace's roofline time
   vs the step's wall (readings);
15. captured dispatches (run inside the SDAR-8B block, after 7c): the
   paged dispatches of ``ModelBackend`` replay one CUDA graph per bucket
   on the card (``serving/graphs.py``).  (i) SDAR-8B's decode at B 8, c
   32 with every context at 512 and at 2048, a chunked prefill of 512
   after 512 and a wave prefill of [8, 512], each through a captured
   backend and its eager twin (``graphs=False``) on the same pool
   contents and host arrays: conf and tok bit-equal, the pools equal, the
   captured pool in place, launches a replay = the eager call's (layers
   a call); both paths' wall, device ms, kernels and busy share; (ii) the
   graphs captured, the seconds spent capturing them and the graph
   pools' bytes, here and over the serving runs; (iii) every serving run
   of phases 7, 7b and 7c runs captured after its eager twin, and its
   committed tokens' sha1, dispatches and launches must equal the
   twin's (the twin records the logit gaps the bf16 rule reads, which a
   replay does not compute on the host).  Scout-8L and Qwen2-VL elastic
   serve captured, Qwen2-VL wave eager (its gaps are compare_runs'
   readings); the slot path is phase 16's, SeamlessM4T's (phase 13)
   eager;
16. the slot path captured (run inside phases 10 and 11, on their
   weights): the recurrent-slot dispatches of ``ModelBackend`` replay one
   CUDA graph per key — ``slot_prefill`` (one graph whatever the slot or
   prompt length), ``window`` and ``advance`` (one graph a distinct T).
   (i) On RWKV6-1.6B and Jamba-1P-10E, a captured backend and its eager
   twin on the same host arrays: a slot prefill into slot 0 and into slot
   5 (one graph serves both), then the AR step (RWKV6) or a window and a
   block commit (Jamba), each twice: logits, KV rows, len and states
   bit-equal, launches a call equal and = the model's layers; each kind's
   wall (median of 5) on both sides, device ms, kernels and busy share on
   both sides but the eager slot prefill (the eager side's with the scans'
   and grouped products' device time);
   the slot prefill graph's node count (``cuGraphGetNodes``) and capture
   seconds.  (ii) The serving run — RWKV6 AR (8 requests,
   ``FixedScheduler(1)``), Jamba block-pinned (8 requests, elastic), 8
   slots of 640 — eagerly (``graphs=False``, served once: it captures
   nothing) and then captured, served twice on one backend (cold with its
   captures, warm): every request
   finishes, token utilization 1.0 (AR), finite logits, launches = layers
   x dispatches of each kind (counted at the backend's ``_dispatch``), the
   slot cache in place, released slots zero, HLO005 in slot form, the
   slot-mode telemetry counters the reference's zeros; each captured serve
   commits the eager serve's tokens (sha1) with its calls and launches;
   walls, tok/s, graphs, replays,
   capture seconds, graph-pool bytes and ``max_memory_allocated``;
17. the JAX package's last jits captured: the page pool's COW copies and
   swap-ins replay from the owning backend's graph cache (their serving
   use runs inside phases 7 and 7b: the prefix cache's copies, the
   migration drill's swap-in), and ``Trainer`` replays its whole step as
   one CUDA graph (phase 12's 10-step run and restart drill now run
   captured).  (ii) (run after phase 15, on SDAR-8B's weights) the
   full-width pool (36 layers, KVH 8, hd 128, page 16, bf16) of a
   captured backend and of an eager twin, filled with the same seeded
   pages: COW copies and swap-ins of 1, 3, 8 and 33 pages, the pools
   bit-equal after every one and in place, one graph a kind and pow-2
   count, each kind's wall a call on both sides (median of 25); (i) (run
   after phase 12) SDAR-8B-4L trained 10 steps by an eager twin and by a
   captured ``Trainer`` from the same seed: per-step losses equal, the
   params and moments after 3 steps bit-equal (else held to a second
   eager run's floor, printed), the live tensors in place,
   ``memory_allocated`` flat over the replays, no host sync in a replay,
   the step walls (median of steps 3-10) on both sides, one more step of
   each profiled, the graph's node count, capture seconds and pool
   bytes; phase 12's captured restart drill read back;
18. the examples (``examples/*_torch.py``) driven in-process on the card,
   after phase 14: (i) ``serve_elastic_torch --tight-pool`` at its
   defaults (every request complete, each pool drained and in place, the
   tight pool preempting, params and pools on the card, each backend's
   graph cache replayed, paged launches above 0), then again on the CPU
   from the same params: the AR and fixed-8 runs' tokens held by the fp32
   rule at each request's first difference (the margin logged), the
   elastic run's chunks logged (the card profiles ``H100_SXM``, the CPU
   ``CPU_HOST``); (ii) ``quickstart_torch`` (the loss at step 60 below
   step 20's, 32 tokens a chunk, both kernels' launches logged, paged
   above 0), each chunk's decode on the card held to the same decode on
   the CPU from the card-trained params by the fp32 rule; (iii)
   ``train_diffusion_lm_torch --full --steps 40`` (smollm-135m at full
   width and depth, fp32, captured): the failure at step 25, the restart
   from the checkpoint after 20 steps to step 40, its losses bit-equal to
   an uninterrupted run resumed from that checkpoint, the median step,
   ``max_memory_allocated`` and the graph's replays logged; (iv)
   ``scheduler_sim_torch --device h100-sxm`` and ``cluster_sim_torch``.
   Each model is freed before the next is drawn.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Without CUDA, or without the repository
beside this file, it prints no result and exits non-zero.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

H100_HBM_BPS = 3.35e12            # bytes/s, H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12,  # dense tensor-core bf16
              "float32": 67e12}    # fp32 outside the tensor cores
BF16_TOL, FP32_TOL = 3e-2, 2e-5   # tests/test_kernels.py:13-14
DEVICE = "cuda"


T0 = time.perf_counter()


def log(*a):
    print(*a, flush=True)


def log_phase(name: str):
    log(f"== {name} (at {time.perf_counter() - T0:.1f} s)")


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
    # the hybrid's dense-slot cache partial: Jamba's 64/8 heads, one page of
    # S = 640 tokens a request (the slot cache read as B pages)
    ("o_slot_jamba", 8, 32, 64, 8, 128, 640, "bfloat16",
     [0, 1, 31, 32, 33, 639, 300, 512]),
    # the encoder-decoder's decoder (SeamlessM4T: 16/16 heads, G 1, head_dim
    # 64): its slot cache (S 256) and its cross cache (S 1024, the source
    # lengths of phase 13), one page a request
    ("q_encdec_self", 8, 32, 16, 16, 64, 256, "bfloat16",
     [0, 1, 31, 32, 33, 255, 100, 200]),
    ("r_encdec_cross", 8, 32, 16, 16, 64, 1024, "bfloat16",
     [1024, 17, 512, 700, 1, 333, 900, 256]),
]


def roofline(flops: float, nbytes: float, dtype: str):
    """The card's least time for ``flops`` operations at the peak rate for
    ``dtype`` and ``nbytes`` over HBM bandwidth: (ms, what bounds it)."""
    t_b, t_o = nbytes / H100_HBM_BPS, flops / PEAK_FLOPS[dtype]
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def bound(B, c, H, KVH, D, ps, dtype, ctx):
    """The card's least time for this call, from the kernel module's cost
    function (``chunked_paged_attn.cost``) on this call's data (live keys
    only): its bytes over HBM bandwidth, its 4·Σctx·c·H·D operations over
    the peak rate for the input type."""
    from repro_torch.kernels.chunked_paged_attn import cost
    el = 2 if dtype == "bfloat16" else 4
    return roofline(*cost(B, c, H, KVH, D, ps, el, ctx=ctx), dtype)


# The block-diffusion kernel at the wave-prefill shapes.  (e) is the SDAR-8B
# wave of 8 prompts padded to T 512 (one batch-padding row, lengths 0);
# (h) is the SMOKE config the CLI serves (head_dim 8, fp32, block 8) at
# T 48, which is not a power of two.
# (l)-(n) are the wave of (e) at the moe and vlm families' heads; (p) the
# hybrid's [1, 640] padded slot prefill.
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
    # the hybrid's padded slot prefill at Jamba's heads
    ("p_prefill_jamba", 1, 640, 64, 8, 128, 32, "bfloat16", [417]),
    # SeamlessM4T's encoder: bidirectional (block = S_src) over the source
    # lengths of phase 13, 16/16 heads, head_dim 64
    ("s_encoder_seamless", 8, 1024, 16, 16, 64, 1024, "bfloat16",
     [1024, 17, 512, 700, 1, 333, 900, 256]),
]


def bd_visible(T, bs, lengths) -> int:
    """Σ_b Σ_t of the keys query t of row b sees: min(len_b, (t//bs+1)·bs)
    (the kernel module's ``visible_keys``)."""
    from repro_torch.kernels.block_diffusion_attn import visible_keys
    return visible_keys(T, bs, lengths)


def bd_bound(B, T, H, KVH, D, bs, dtype, lengths):
    """The card's least time for one block-diffusion call, from the kernel
    module's cost function (``block_diffusion_attn.cost``) on this call's
    lengths: its bytes over HBM bandwidth, its 4·D·H·Σ visible operations
    over the peak rate for the input type."""
    from repro_torch.kernels.block_diffusion_attn import cost
    el = 2 if dtype == "bfloat16" else 4
    return roofline(*cost(B, T, H, KVH, D, bs, el, lengths=lengths), dtype)


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
        gflop = bda.cost(B, T, H, KVH, D, bs, 2, lengths=lens)[0] / 1e9
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
        gflop = cpa.cost(B, c, H, KVH, D, ps, 2, ctx=ctx)[0] / 1e9
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

def profile_dispatch(dispatch, kernel: str | None, iters: int, n: int,
                     ops: tuple = ()) -> dict:
    """Where one dispatch's time goes: wall per dispatch (host clock around
    ``torch.cuda.synchronize``, median of ``iters``) through the kernel,
    the plain version and the kernel again, then ``torch.profiler`` over
    ``n`` kernel-path dispatches: device time, busy share of the wall, the
    share of the device kernel whose name holds ``kernel`` (None: a
    dispatch that runs no hand kernel), and the device time of each
    PyTorch op or ``record_function`` range in ``ops`` (the kernels
    launched inside it)."""
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
    return {"wall_ms_kernel": walls["kernel"], "wall_ms_plain": walls["ref"],
            **device_profile(lambda: dispatch("kernel"), kernel, n, ops)}


def device_profile(run, kernel: str | None, n: int, ops: tuple = (),
                   require: bool = True) -> dict:
    """``torch.profiler`` over ``n`` calls of ``run``: device time, busy
    share of the wall, the share of the device kernel whose name holds
    ``kernel``, the device time of each op or range in ``ops``, the top
    kernels.  ``require``: raise when ``kernel`` or an op shows no device
    time."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = torch.autograd.DeviceType
    # device kernels only: a record_function range's span on the device
    # timeline is not a kernel
    kern = sorted(((e.key, e.self_device_time_total, e.count)
                   for e in prof.key_averages()
                   if e.device_type == dev.CUDA and e.key not in ops
                   and not getattr(e, "is_user_annotation", False)),
                  key=lambda r: -r[1])
    busy = sum(t for _, t, _ in kern)
    mine = sum(t for k, t, _ in kern if kernel and kernel in k)
    if require and kernel and not mine > 0:
        raise AssertionError(f"profile: {kernel} shows no device time")
    op_us = {op: sum(e.device_time_total for e in prof.key_averages()
                     if e.key == op and e.device_type == dev.CPU)
             for op in ops}
    for op, t in op_us.items():
        if require and not t > 0:
            raise AssertionError(f"profile: {op} shows no device time")
    return {"profiled_dispatches": n,
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


def log_profile(what: str, row: dict, kernel: str | None):
    log(f"profile {what}: wall ms kernel {row['wall_ms_kernel'][0]:.2f}, "
        f"{row['wall_ms_kernel'][1]:.2f}, plain {row['wall_ms_plain'][0]:.2f};"
        f" profiled wall {row['wall_ms_profiled']:.2f} ms, device "
        f"{row['device_ms_per_dispatch']:.2f} ms (busy share "
        f"{row['device_busy_share']:.3f}) in "
        f"{row['device_kernels_per_dispatch']:.0f} kernels" + (
            f"; {kernel} kernel {row['kernel_ms_per_dispatch']:.3f} ms "
            f"(share of device {row['kernel_share_of_device']:.3f})"
            if kernel else "") + "".join(
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


def routed(run, pin=None, per_layer: int = 1):
    """``run()`` with every MoE layer's router probabilities and own top-k
    experts recorded, call by call; with ``pin`` ([n, T, k]) the i-th call
    routes to ``pin[(i // per_layer) % n]`` instead (gates from its own
    probabilities, renormalised; ``per_layer``: the calls a layer makes,
    one a shard under the 2d body).  Returns (run's result, probabilities,
    own experts)."""
    import torch

    import repro_torch.models.moe as moe

    route = moe._route
    probs, ids_own = [], []

    def rec(x, router_w, top_k):
        p = torch.softmax((x @ router_w.to(x.dtype)).float(), dim=-1)
        gates, ids = route(x, router_w, top_k)
        i = len(probs)
        probs.append(p)
        ids_own.append(ids)
        if pin is not None:
            ids = pin[(i // per_layer) % len(pin)]
            gates = p.gather(-1, ids.long())
            gates = gates / torch.clamp(gates.sum(-1, keepdim=True),
                                        min=1e-9)
        return gates, ids

    moe._route = rec
    try:
        out = run()
    finally:
        moe._route = route
    return out, probs, ids_own


def moe_model_phase(model, params, pool, seed: int) -> dict:
    import torch

    import repro_torch.models.transformer as tfm
    from repro_torch.kernels import chunked_paged_attn as cpa

    cfg = model.cfg
    L = cfg.n_layers
    cache, tables = pool
    win, start, valid, n_adv = decode_inputs(model, [MOE_CTX] * MODEL_B,
                                             seed)

    def dispatch(impl, pin=None):
        """decode_step_paged, then chunk_forward_paged for the logits; each
        layer's router probabilities and own choice of experts are kept,
        and with ``pin`` ([L, T, k]) the experts used are pin's."""
        def run():
            conf, tok, _ = model.decode_step_paged(
                params, cache, win, start, valid, tables, start, n_adv,
                impl=impl)
            logits, _ = model.chunk_forward_paged(
                params, cache, win, start, valid, tables, start, impl=impl)
            return conf, tok, logits

        (conf, tok, logits), probs, ids_own = routed(run, pin)
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
# expert-parallel phase (phase 8b): Scout on a one-card (data x model) mesh
# ---------------------------------------------------------------------------

# The mesh's every shard is this card: (data 2, model 4), so each shard
# holds 4 of Scout's 16 experts, and the 2d body splits f into 2 x 4096.
# The block level runs one Scout layer (phase 8's layer 0) on the token
# counts of a decode dispatch and a prefill chunk; the model level phase
# 8's decode dispatch; the training level one step of Scout at full width
# cut to 1 layer (phase 8's layer 0, copied), B 2 x 512, bf16 AdamW state
# (the reference's launch/specs.py).  One card moves no collective bytes:
# they are the analytic ring all-reduce's, summed over the devices.
EP_MESH = (2, 4)
EP_TOKENS = (("decode", 256), ("prefill_chunk", 32))
EP_TRAIN_B, EP_TRAIN_T = 2, 512
EP_GRAD_NOISE = 1e-6    # tests/test_torch_training.py's noise floor


def ep_mesh():
    import torch

    from repro_torch.launch.mesh import Mesh
    n = EP_MESH[0] * EP_MESH[1]
    return Mesh(("data", "model"), EP_MESH, (torch.device(DEVICE),) * n)


def ep_rules():
    """(body name, body, the rules that pick it in ``moe_block``)."""
    from repro_torch.distributed.sharding import serving_rules, training_rules
    from repro_torch.models import moe
    return (("sharded", moe.moe_block_sharded, training_rules()),
            ("2d", moe.moe_block_2d, serving_rules(moe_2d=True)))


def ep_collective_bytes(body: str, T: int, d: int) -> int:
    """The bytes a ring all-reduce of each body's fp32 ``y`` sends, summed
    over the devices: (n - 1) x 2 x its bytes a group of n.  sharded: one
    group a data row over the model axis, ``[T/D, d]``; 2d: one group of
    every device, ``[T, d]``."""
    D, M = EP_MESH
    if body == "sharded":
        return D * (M - 1) * 2 * (T // D) * d * 4
    return (D * M - 1) * 2 * T * d * 4


def ep_dropped(cfg, x, router, body: str) -> int:
    """The (token, expert) pairs each body drops at ``cfg``'s capacity:
    over every data row (sharded) or once (2d), each model shard keeps at
    most its capacity of its experts' pairs."""
    import torch

    from repro_torch.models import moe
    D, M = EP_MESH
    E_loc = cfg.n_experts // M
    rows = x.reshape(D, -1, x.shape[-1]) if body == "sharded" else x[None]
    out = 0
    for r in rows:
        ids = moe._route(r, router, cfg.top_k)[1].reshape(-1)
        n = torch.bincount(torch.div(ids, E_loc, rounding_mode="floor"),
                           minlength=M)
        C = moe.capacity(r.shape[0], cfg.top_k, cfg.capacity_factor, M)
        out += int(torch.clamp(n - C, min=0).sum())
    return out


def ep_block_level(cfg, params, seed: int, layer_rows) -> list[dict]:
    """Phase 8b (i): each body on one Scout layer against the unsharded
    ``_moe_local`` with capacity factor 0 (sharded: the same up to fp32
    order; 2d: the bf16 tolerance, each f-partial rounded) and against the
    plain grouped loop on the same shards; then, at the configured capacity
    factor, each body's median CUDA-event time beside the unsharded layer's
    (this run's and phase 3b's), its grouped calls (3 a shard), the pairs
    it drops and its analytic collective bytes, and one call under
    ``set_sync_debug_mode("error")``."""
    import torch

    from repro_torch.distributed.sharding import use_rules
    from repro_torch.models import moe

    mesh = ep_mesh()
    n_shards = len(mesh.devices)
    p = {k: params[f"blocks/pos0/ffn/{k}"][0]
         for k in ("router", "w_gate", "w_up", "w_down")}
    w = (p["router"], p["w_gate"], p["w_up"], p["w_down"])
    cfg0 = cfg.replace(capacity_factor=0.0)
    g = torch.Generator(device=DEVICE).manual_seed(seed + 8)
    out = []
    for tokens, T in EP_TOKENS:
        x = torch.randn((1, T, cfg.d_model), generator=g,
                        device=DEVICE).to(torch.bfloat16)
        whole0 = moe._moe_local(x[0], *w, cfg=cfg0)
        whole_ms = time_ms(lambda: moe._moe_local(x[0], *w, cfg=cfg),
                           iters=10)
        phase3b = next((r["layer_ms"] for r in layer_rows if r["T"] == T),
                       None)
        for body, fn, rules in ep_rules():
            with use_rules(rules, mesh):
                calls = moe.GROUPED_CALLS
                got0 = fn(p, cfg0, x)[0]
                torch.cuda.synchronize()
                n_calls = moe.GROUPED_CALLS - calls
                if n_calls != 3 * n_shards:
                    raise AssertionError(f"ep {body} T {T}: {n_calls} "
                                         f"grouped calls, not 3 x "
                                         f"{n_shards}")
                exact = moe.grouped_matmul
                moe.grouped_matmul = moe.grouped_matmul_loop
                try:
                    loop0 = fn(p, cfg0, x)[0]
                finally:
                    moe.grouped_matmul = exact
                got = fn(p, cfg, x)[0]
                ms = time_ms(lambda: fn(p, cfg, x), iters=10)
                torch.cuda.set_sync_debug_mode("error")
                try:
                    fn(p, cfg, x)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            scale = float(whole0.float().abs().max())
            rel = float((got0.float() - whole0.float()).abs().max()) / scale
            rel_loop = float((got0.float() - loop0.float()).abs().max()) \
                / scale
            tol = FP32_TOL if body == "sharded" else BF16_TOL
            for what, r, lim in (("the unsharded layer", rel, tol),
                                 ("the plain grouped loop", rel_loop,
                                  BF16_TOL)):
                if not r <= lim:
                    raise AssertionError(f"ep {body} T {T}: {r} from {what}"
                                         f" (limit {lim})")
            if not torch.isfinite(got).all():
                raise AssertionError(f"ep {body} T {T}: non-finite output")
            row = {"tokens": tokens, "T": T, "body": body,
                   "mesh": list(EP_MESH),
                   "rel_err_vs_unsharded_cf0": rel,
                   "bit_equal_to_unsharded_cf0": bool(torch.equal(got0,
                                                                  whole0)),
                   "rel_err_vs_loop_cf0": rel_loop, "limit": tol,
                   "grouped_calls": n_calls,
                   "capacity_factor": cfg.capacity_factor,
                   "pairs_dropped": ep_dropped(cfg, x[0], w[0], body),
                   "rel_err_cf_vs_cf0": float(
                       (got.float() - got0.float()).abs().max()) / scale,
                   "ms": ms, "unsharded_ms": whole_ms,
                   "unsharded_ms_phase3b": phase3b,
                   "collective_bytes_analytic": ep_collective_bytes(
                       body, T, cfg.d_model),
                   "collective_bytes_this_card": 0, "sync_free": True}
            out.append(row)
            log(f"ep {body} (mesh data {EP_MESH[0]} x model {EP_MESH[1]}) "
                f"T {T}: vs unsharded cf 0 rel err {rel:.3e} (bit-equal "
                f"{row['bit_equal_to_unsharded_cf0']}, limit {tol}), vs the "
                f"plain loop {rel_loop:.3e}; {n_calls} grouped calls; at cf "
                f"{cfg.capacity_factor}: {row['pairs_dropped']} pairs "
                f"dropped, {ms:.4f} ms against the unsharded layer's "
                f"{whole_ms:.4f} ms (phase 3b {phase3b}); analytic "
                f"collective bytes {row['collective_bytes_analytic']} (this "
                f"card moves none); no host sync")
        del x, whole0
    return out


def ep_model_level(model, params, seed: int, moe_model_res: dict) -> dict:
    """Phase 8b (ii): phase 8's decode dispatch under ``serving_rules(
    moe_2d=True)`` on the mesh (every MoE layer the 2d body, the paged
    kernel for attention), its routing pinned to the plain path's experts
    as phase 8 pins it: held at MOE_LIMITS against the plain path and to
    the bf16 rule (a token may differ only where the plain top-1/top-2 gap
    is under the bf16 tolerance), beside the unsharded kernel path pinned
    the same way; with its own routing, the (token, layer) pairs whose
    top-1 expert differs from the unsharded kernel path's (a reading).
    The counted run: one ``decode_step_paged`` on the mesh, counts set to 0
    just before it (paged launches = layers, grouped calls = 3 x shards x
    layers).  Then profiled as phase 8's dispatch."""
    import torch

    from repro_torch.distributed.sharding import serving_rules, use_rules
    from repro_torch.kernels import chunked_paged_attn as cpa
    from repro_torch.models import moe

    cfg = model.cfg
    L = cfg.n_layers
    mesh = ep_mesh()
    n_shards = len(mesh.devices)
    rules = serving_rules(moe_2d=True)
    cache, tables = make_pool(model, seed)
    win, start, valid, n_adv = decode_inputs(model, [MOE_CTX] * MODEL_B,
                                             seed)

    def head_only(impl):
        conf, tok, _ = model.decode_step_paged(params, cache, win, start,
                                               valid, tables, start, n_adv,
                                               impl=impl)
        return conf, tok

    def dispatch(impl, pin=None, ep=False):
        def run():
            conf, tok = head_only(impl)
            logits, _ = model.chunk_forward_paged(
                params, cache, win, start, valid, tables, start, impl=impl)
            return conf, tok, logits

        with use_rules(rules if ep else None, mesh if ep else None):
            (conf, tok, logits), probs, ids = routed(
                run, pin, n_shards if ep else 1)
        per = n_shards if ep else 1
        if len(probs) != 2 * L * per:
            raise AssertionError(f"ep model: {len(probs)} routings, not "
                                 f"2 x {L} x {per}")
        for t in (conf, logits):
            if not torch.isfinite(t).all():
                raise AssertionError("ep model: non-finite output")
        return conf, tok, logits, torch.stack(ids[L * per::per])

    plain = dispatch("ref")
    kernel = dispatch("kernel", pin=plain[3])
    ep = dispatch("kernel", pin=plain[3], ep=True)
    kernel_free = dispatch("kernel")
    ep_free = dispatch("kernel", ep=True)
    torch.cuda.synchronize()
    readings, margin_of, _, lr_std = decode_readings(*plain[:3])
    ep_r, k_r = readings(*ep[:3]), readings(*kernel[:3])
    n_diff, max_gap, margin = margin_of(ep[1])
    flips = ep_free[3][..., 0] != kernel_free[3][..., 0]
    cpa.LAUNCHES = cpa.MERGE_LAUNCHES = 0
    moe.GROUPED_CALLS = 0
    with use_rules(rules, mesh):
        head_only("kernel")
    torch.cuda.synchronize()
    counted = {"kernel_launches": cpa.LAUNCHES,
               "merge_launches": cpa.MERGE_LAUNCHES,
               "grouped_calls": moe.GROUPED_CALLS}
    if counted["kernel_launches"] != L or \
            counted["grouped_calls"] != 3 * n_shards * L:
        raise AssertionError(f"ep model: counted {counted}, not {L} paged "
                             f"launches and 3 x {n_shards} x {L} grouped "
                             f"calls")
    res = {"arch": cfg.name, "layers": L, "B": MODEL_B, "c": MODEL_C,
           "ctx": MOE_CTX, "mesh": list(EP_MESH), "rules": "serving_rules("
           "moe_2d=True)", "routing": "pinned to the plain path's experts",
           "logits_std_plain": lr_std, "ep_vs_plain": ep_r,
           "unsharded_kernel_vs_plain": k_r,
           "ep_vs_unsharded_kernel": {
               "logits_rel": float((ep[2] - kernel[2]).abs().max()) / lr_std,
               "tokens_differ": int((ep[1] != kernel[1]).sum())},
           "tokens_differ": n_diff, "max_gap_where_differ": max_gap,
           "gap_margin": margin, "limits": MOE_LIMITS,
           "own_routing_expert_flips_vs_unsharded": int(flips.sum()),
           "routed_pairs": flips.numel(), **counted}
    log(f"ep model decode_step_paged ({cfg.name}, {L} layers, B {MODEL_B}, "
        f"c {MODEL_C}, ctx {MOE_CTX}) on the mesh under serving_rules("
        f"moe_2d=True), routing pinned: tokens differ {n_diff} (largest "
        f"gap where they differ {max_gap:.4f}, margin {margin}); own "
        f"routing: top-1 differs from the unsharded kernel path in "
        f"{res['own_routing_expert_flips_vs_unsharded']} of {flips.numel()}"
        f" (token, layer) pairs; one counted dispatch: {counted}")
    for key, lim in MOE_LIMITS.items():
        log(f"  {key} (pinned): mesh {ep_r[key]:.4f}  unsharded kernel "
            f"{k_r[key]:.4f}  limit {lim}")
    if n_diff and not margin > 0:
        raise AssertionError("ep model: a token differs where its "
                             "top-1/top-2 gap exceeds the bf16 tolerance")
    for key, lim in MOE_LIMITS.items():
        if not ep_r[key] < lim:
            raise AssertionError(f"ep model: {key} {ep_r[key]} >= {lim}")

    def profiled(impl):
        with use_rules(rules, mesh):
            conf, tok = head_only(impl)
        return conf.cpu(), tok.cpu()

    res["profile"] = profile_dispatch(profiled, "paged_chunk_attn", 5, 3,
                                      ops=("aten::_grouped_mm",))
    base = moe_model_res["profile"]
    res["profile_unsharded_phase8"] = {
        k: base[k] for k in ("wall_ms_kernel", "device_ms_per_dispatch",
                             "device_busy_share", "kernel_ms_per_dispatch",
                             "device_kernels_per_dispatch")}
    log_profile(f"ep decode ({cfg.name}, ctx {MOE_CTX}, mesh)",
                res["profile"], "paged")
    log(f"  phase 8's unsharded dispatch: wall {base['wall_ms_kernel']} ms,"
        f" device {base['device_ms_per_dispatch']:.2f} ms, busy share "
        f"{base['device_busy_share']:.3f}, "
        f"{base['device_kernels_per_dispatch']:.0f} kernels")
    del cache, tables
    return res


def ep_layer_params(params, n_layers: int = 1) -> dict:
    """A copy of the first ``n_layers`` of a model's params (the stacked
    ``blocks/…`` leaves cut, the others whole)."""
    return {k: (v[:n_layers] if k.startswith("blocks/") else v).clone()
            for k, v in params.items()}


def ep_train_level(cfg, params, seed: int, workdir: Path) -> dict:
    """Phase 8b (iii): one training step of Scout at full width, 1 layer
    (``params``: phase 8's layer 0, copied), capacity factor 0, under
    ``training_rules`` on the mesh against the same step with no mesh (the
    loss, and each leaf's gradient within the bf16 tolerance relative to
    its largest value; a leaf that is rounding noise on both sides, the
    top-1 router, counts as equal); ``torch._grouped_mm``'s own backward
    (dX at the rows past the last group: what the wrapper masks); then a
    step with AdamW (bf16 state) on the mesh, timed, its peak memory, and
    its MoE leaves and their moments saved and restored under another spec
    (``elastic_shardings`` of swapped rules) byte-exact, piece by piece."""
    import numpy as np
    import torch

    from repro_torch.distributed.sharding import (NamedSharding,
                                                  shard_tensor,
                                                  training_rules,
                                                  unshard_tensor, use_rules)
    from repro_torch.models import build_model, moe
    from repro_torch.training import AdamW, AdamWConfig, CheckpointManager
    from repro_torch.training.fault_tolerance import elastic_shardings
    from repro_torch.training.objectives import diffusion_masks
    from repro_torch.training.train_loop import (make_train_step,
                                                 step_generator)

    mesh = ep_mesh()
    model = build_model(cfg)
    n_params = sum(t.numel() for t in params.values())
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.as_tensor(rng.integers(
        4, cfg.vocab_size - 8, (EP_TRAIN_B, EP_TRAIN_T)), device=DEVICE)}
    masks = diffusion_masks(step_generator(seed, 0, DEVICE), EP_TRAIN_B,
                            EP_TRAIN_T, cfg.block_size)
    rules = training_rules()

    # _grouped_mm's own backward at one layer's w_gate, 4 groups of 64 of
    # 512 rows: dX past the last group, unmasked
    rows = torch.randn((512, cfg.d_model), device=DEVICE,
                       dtype=torch.bfloat16).requires_grad_()
    offs = torch.tensor([64, 128, 192, 256], dtype=torch.int32,
                        device=DEVICE)
    w_gate = params["blocks/pos0/ffn/w_gate"][0, :4]
    dx, = torch.autograd.grad(torch._grouped_mm(rows, w_gate, offs=offs),
                              rows, torch.ones((512, cfg.moe_ff),
                                               device=DEVICE,
                                               dtype=torch.bfloat16))
    raw_past = dx[256:].float()
    raw_dx = {"rows_past_groups": 256,
              "nonzero": int((raw_past != 0).sum()),
              "non_finite": int((~torch.isfinite(raw_past)).sum())}
    del rows, dx, raw_past

    def grads(on_mesh):
        step = make_train_step(model, GradsOut())
        with use_rules(rules if on_mesh else None, mesh if on_mesh else None):
            _, _, out = step(params, None, batch, masks=masks)
        torch.cuda.synchronize()
        return float(out["loss"]), out["grads"]

    calls = moe.GROUPED_CALLS
    loss_mesh, g_mesh = grads(True)
    calls = moe.GROUPED_CALLS - calls
    # remat runs each layer's forward again in the backward
    want_calls = 3 * len(mesh.devices) * cfg.n_layers * (1 + cfg.remat)
    if calls != want_calls:
        raise AssertionError(f"ep train: {calls} grouped calls, not "
                             f"{want_calls}")
    loss_plain, g_plain = grads(False)
    floor = EP_GRAD_NOISE * max(float(g.float().abs().max())
                                for g in g_plain.values())
    rel, noise = {}, []
    for k, g in g_plain.items():
        scale = float(g.float().abs().max())
        err = float((g_mesh[k].float() - g.float()).abs().max())
        if scale < floor:
            noise.append(k)
            rel[k] = 0.0 if float(g_mesh[k].float().abs().max()) < floor \
                else 1.0
        else:
            rel[k] = err / scale
        if not torch.isfinite(g_mesh[k]).all():
            raise AssertionError(f"ep train: non-finite gradient of {k}")
    del g_mesh, g_plain
    torch.cuda.empty_cache()
    worst = max(rel, key=rel.get)
    res = {"arch": cfg.name, "layers": cfg.n_layers, "params": n_params,
           "B": EP_TRAIN_B, "T": EP_TRAIN_T, "mesh": list(EP_MESH),
           "capacity_factor": cfg.capacity_factor,
           "loss_mesh": loss_mesh, "loss_plain": loss_plain,
           "grad_rel_by_leaf": rel, "grad_rel_max": rel[worst],
           "grad_rel_worst_leaf": worst, "noise_leaves": noise,
           "grad_tol": BF16_TOL, "grouped_calls_mesh_step": calls,
           "raw_grouped_mm_backward_dx": raw_dx}
    log(f"ep train {cfg.name} ({cfg.n_layers} layer, full width, {n_params}"
        f" params, B {EP_TRAIN_B} x T {EP_TRAIN_T}) under training_rules on"
        f" the mesh: loss {loss_mesh:.6f} vs no mesh {loss_plain:.6f}; "
        f"gradients' largest rel err {rel[worst]:.3e} ({worst}), noise "
        f"leaves {noise}; {calls} grouped calls in the forward and its "
        f"recomputation (remat {cfg.remat}); "
        f"_grouped_mm's own dX past the last group: {raw_dx}")
    if not abs(loss_mesh - loss_plain) <= BF16_TOL * max(1.0,
                                                         abs(loss_plain)):
        raise AssertionError(f"ep train: loss {loss_mesh} vs {loss_plain}")
    if not rel[worst] < BF16_TOL:
        raise AssertionError(f"ep train: gradient of {worst} off by "
                             f"{rel[worst]}")

    # a step with AdamW on the mesh: wall and peak memory
    opt = AdamW(AdamWConfig(state_dtype="bfloat16"))
    state = opt.init(params)
    step = make_train_step(model, opt)
    walls = []
    torch.cuda.reset_peak_memory_stats()
    for i in range(2):
        t0 = time.perf_counter()
        with use_rules(rules, mesh):
            _, _, metrics = step(params, state, batch, masks=masks)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    res.update({"step_wall_s": walls, "step_loss": float(metrics["loss"]),
                "max_memory_allocated": torch.cuda.max_memory_allocated(),
                "param_bytes": sum(t.numel() * t.element_size()
                                   for t in params.values())})
    log(f"  AdamW (bf16 state) steps on the mesh: wall {walls} s, max "
        f"memory allocated {res['max_memory_allocated']} B (params "
        f"{res['param_bytes']} B)")

    # the MoE leaves and their moments, saved and restored under another
    # spec: (None, "data", "model", None) for the expert stacks
    names = [f"blocks/pos0/ffn/{k}" for k in moe.axes_moe(cfg)]
    axes = {n: ("layers",) + moe.axes_moe(cfg)[n.rsplit("/", 1)[1]]
            for n in names}
    tree = {"params": {n: params[n] for n in names},
            "opt": {n: {m: state["mu"][n][m] for m in ("m", "v")}
                    for n in names}}
    saved = {n: tree["params"][n] for n in names}
    saved.update({f"{n}/{m}": tree["opt"][n][m] for n in names
                  for m in ("m", "v")})
    new_specs = elastic_shardings(axes, training_rules(
        data_axes=("model",), model_axis="data"))
    shardings = {"params": {n: NamedSharding(mesh, new_specs[n])
                            for n in names},
                 "opt": {n: {m: NamedSharding(mesh, new_specs[n])
                             for m in ("m", "v")} for n in names}}
    mgr = CheckpointManager(str(workdir / "ep"), async_save=False)
    t0 = time.perf_counter()
    mgr.save(1, tree)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back, step_no = mgr.restore_latest(tree, shardings=shardings)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    got = {n: back["params"][n] for n in names}
    got.update({f"{n}/{m}": back["opt"][n][m] for n in names
                for m in ("m", "v")})
    n_bytes, n_pieces = 0, 0
    for key, pieces in got.items():
        spec = new_specs[key if key in new_specs else key.rsplit("/", 1)[0]]
        live = saved[key]
        for p, q in zip(pieces, shard_tensor(live, mesh, spec)):
            if not (p.dtype == q.dtype and torch.equal(
                    p.view(torch.int16), q.view(torch.int16))):
                raise AssertionError(f"ep restore: a piece of {key} differs")
            n_pieces += 1
        if not torch.equal(unshard_tensor(pieces, mesh, spec)
                           .view(torch.int16), live.view(torch.int16)):
            raise AssertionError(f"ep restore: {key} differs")
        n_bytes += live.numel() * live.element_size()
    res["restore"] = {"step": step_no, "specs": {n: list(new_specs[n])
                                                 for n in names},
                      "leaves": len(got), "pieces": n_pieces,
                      "bytes": n_bytes, "save_s": save_s,
                      "restore_s": restore_s, "byte_exact": True}
    log(f"  checkpoint of the MoE leaves and moments ({len(got)} leaves, "
        f"{n_bytes} B): saved in {save_s:.2f} s, restored under "
        f"{res['restore']['specs']} in {restore_s:.2f} s, {n_pieces} "
        f"pieces byte-exact")
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

# graph captures on the card over the whole script: count and host seconds
# (``time_captures`` wraps ``CudaCapturer.capture``)
CAPTURES = {"n": 0, "s": 0.0}


def time_captures():
    """Count every CUDA-graph capture and the host seconds it takes (the
    capture's Python and the graph's instantiation) into CAPTURES."""
    from repro_torch.serving import graphs

    capture = graphs.CudaCapturer.capture

    def timed(self, fn, like):
        t0 = time.perf_counter()
        try:
            return capture(self, fn, like)
        finally:
            CAPTURES["n"] += 1
            CAPTURES["s"] += time.perf_counter() - t0

    graphs.CudaCapturer.capture = timed


def graph_stats(be, since: dict | None = None) -> dict | None:
    """A backend's graph cache (None for an eager backend): graphs
    captured, replays, the bytes its memory pool holds, and the capture
    seconds since ``since`` (a copy of CAPTURES)."""
    if be.graphs is None:
        return None
    out = {"graphs": len(be.graphs.entries), "replays": be.graphs.replays,
           "pool_bytes": be.graphs.pool_bytes()}
    if since is not None:
        out["captures"] = CAPTURES["n"] - since["n"]
        out["capture_s"] = CAPTURES["s"] - since["s"]
    return out


def record_gaps(be, gaps: dict, margins: dict | None = None,
                steps: dict | None = None, rel_tol: float = BF16_TOL,
                sampled: bool = True):
    """While a diffusion run serves, note for every committed token the
    top-1/top-2 logit gap of the decode dispatch that committed it:
    ``gaps[id(state)][output index] = gap``, and in ``margins`` the op
    rule's margin there (``rel_tol`` x max(|top-1|, 1) - gap; below 0 the
    gap exceeds the op tolerance).  With ``steps``, every decode dispatch
    a state takes part in appends to ``steps[id(state)]`` its window and
    what decided the commits (:func:`dispatch_divergence`).  Hooks the
    decode sampler and the batched commit; undo with the returned
    function.  ``sampled=False`` (a captured run, whose replays do not run
    the sampler on the host) hooks the commit only: the steps without
    gaps, and no gaps or margins."""
    import numpy as np

    import repro_torch.models.transformer as tfm
    import repro_torch.serving.backends as backends

    sampler, commit = tfm.softmax_confidence_device, backends.batch_apply_step
    last = {}

    def sample(logits):
        if logits.dim() == 3:                 # decode [B, c, V]
            top2 = logits.topk(2, dim=-1).values
            last["gap"] = top2[..., 0] - top2[..., 1]
            last["tol"] = rel_tol * top2[..., 0].abs().clamp(min=1.0)
        return sampler(logits)

    def apply(states, conf, tok, valid, cai):
        frozen = [st.frozen for st in states]
        mask, n_adv = commit(states, conf, tok, valid, cai)
        if sampled:
            gap = last.pop("gap").float().cpu().numpy()
            tol = last.pop("tol").float().cpu().numpy()
        for i, st in enumerate(states):
            v = int(valid[i])
            if steps is not None and v:
                rec = {"frozen": frozen[i], "valid": v, "c": mask.shape[1],
                       "threshold": float(st.threshold),
                       "cai": np.array(cai[i, :v]), "commit": mask[i, :v],
                       "tok": np.array(tok[i, :v]),
                       "conf": np.asarray(conf[i, :v], np.float64)}
                if sampled:
                    rec.update(gap=gap[i, :v], tol=tol[i, :v])
                steps.setdefault(id(st), []).append(rec)
            if not sampled:
                continue
            row = gaps.setdefault(id(st), {})
            for j in np.nonzero(mask[i])[0]:
                row[frozen[i] + int(j)] = float(gap[i, j])
                if margins is not None:
                    margins.setdefault(id(st), {})[frozen[i] + int(j)] = \
                        float(tol[i, j] - gap[i, j])
        return mask, n_adv

    if sampled:
        tfm.softmax_confidence_device = sample
    backends.batch_apply_step = apply

    def undo():
        tfm.softmax_confidence_device = sampler
        backends.batch_apply_step = commit
    return undo


def serve_run(model, params, mode: str, reqs, max_len: int,
              kv_shards: int = 1, graphs: bool = True) -> dict:
    """One serving run: ``mode`` "elastic" (chunked prefill), "ar", or
    "wave" (the elastic run with wave prefill); with ``kv_shards`` > 1 on a
    pool sharded over a ``kv_shards``-way mesh of this one card (phase
    7c), every paged read split-KV.  ``graphs``: the paged dispatches
    replay captured CUDA graphs (the backend's default on the card), or
    run eagerly; only an eager run records the decode dispatches' logit
    gaps (:func:`record_gaps`), which a replay does not compute on the
    host."""
    import hashlib

    import torch

    from repro_torch.analysis import rules
    from repro_torch.core.latency_model import CPU_HOST, AnalyticDeviceModel
    from repro_torch.core.scheduler import ElasticScheduler, FixedScheduler
    from repro_torch.kernels import block_diffusion_attn as bda
    from repro_torch.kernels import chunked_paged_attn as cpa
    from repro_torch.models import moe
    from repro_torch.serving import DATASETS, ModelBackend, ServingEngine
    from repro_torch.serving.backends import _split_kv_collective_bytes
    from torch.utils._pytree import tree_leaves

    cfg = model.cfg
    wave = mode == "wave"
    S = kv_shards
    sorted_moe = moe.takes_sorted_path(cfg)   # grouped products, every layer
    shard_kw = {} if S == 1 else {"kv_shards": S,
                                  "kv_mesh": kv_shard_spec(S).mesh}
    be = ModelBackend(model, params, n_slots=8, max_len=max_len,
                      decode_mode="ar" if mode == "ar" else "elastic",
                      cache_dtype=torch.bfloat16, device=DEVICE,
                      prefill_mode="wave" if wave else "chunked",
                      graphs=graphs, **shard_kw)
    if mode in ("elastic", "wave"):   # as launch/serve.py builds it
        sched = ElasticScheduler.from_analytic(
            AnalyticDeviceModel(cfg, CPU_HOST),
            prior_tokens_per_step=DATASETS["sharegpt"].tokens_per_step_bd32,
            batches=(1, 2, 4, 8), ctx=128.0)
    else:
        sched = FixedScheduler(1)
    shapes = {"decode": [], "prefill": []}
    budget_findings = []

    dispatch = be._dispatch

    def record(kind, fn, **host):
        # at the backend, which sees every dispatch, replayed or not: each
        # dispatch's returned tensors other than the pool's held to rule
        # HLO003's budget, 8·B·c bytes a decode, 8·B a prefill
        out = dispatch(kind, fn, **host)
        B, c = host["toks"].shape
        kind = "decode" if kind == "decode" else "prefill"
        shapes[kind].append((B, c))
        budget_findings.extend(rules.check_host_budget(
            [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)],
            budget_bytes=8 * B * (c if kind == "decode" else 1),
            pool=be.kv, target=f"{kind} {(B, c)}"))
        return out

    be._dispatch = record
    outs, gaps, gap_of, margins, margin_of = {}, {}, {}, {}, {}
    steps, steps_of = {}, {}
    release = be.release

    def spy(rid):
        st = be.state(rid)
        outs[rid] = st.output_tokens
        gap_of[rid] = gaps.pop(id(st), {})
        margin_of[rid] = margins.pop(id(st), {})
        steps_of[rid] = steps.pop(id(st), [])
        release(rid)

    be.release = spy
    ptrs = rules.pool_ptrs(be.kv)
    eng = ServingEngine(be, sched, max_batch=8)
    undo = record_gaps(be, gaps, margins, steps) \
        if mode != "ar" and not graphs else (lambda: None)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cpa.LAUNCHES = cpa.MERGE_LAUNCHES = bda.LAUNCHES = 0
    moe.GROUPED_CALLS = 0
    captures = dict(CAPTURES)
    t0 = time.perf_counter()
    try:
        rep = eng.run(list(reqs))
        torch.cuda.synchronize()
    finally:
        undo()
    wall = time.perf_counter() - t0
    launches, bd_launches = cpa.LAUNCHES, bda.LAUNCHES
    merges, grouped = cpa.MERGE_LAUNCHES, moe.GROUPED_CALLS

    n_dec, n_pre = be.decode_dispatches, be.prefill_dispatches
    tokens = sum(len(v) for v in outs.values())
    dec_bytes = sum(8 * b * c for b, c in shapes["decode"])
    pre_bytes = sum(8 * b for b, _ in shapes["prefill"])
    res = {"arch": cfg.name, "layers": cfg.n_layers, "mode": mode,
           "kv_shards": S, "requests": len(rep.metrics),
           "tokens_committed": tokens, "decode_dispatches": n_dec,
           "prefill_dispatches": n_pre, "kernel_launches": launches,
           "merge_launches": merges, "bd_kernel_launches": bd_launches,
           "grouped_mm_calls": grouped,
           "prefill_shapes": shapes["prefill"],
           "host_bytes_per_decode_dispatch": dec_bytes / max(n_dec, 1),
           "wall_s": wall, "tok_per_s": tokens / wall,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "chunks": sorted({c for _, c in shapes["decode"]}),
           "batches": sorted({b for b, _ in shapes["decode"]}),
           "device_dispatches": be.device_dispatches,
           "collective_bytes": be.collective_bytes,
           "path": "captured" if graphs else "eager",
           "tokens_sha1": hashlib.sha1(json.dumps(
               [outs[r.rid] for r in reqs]).encode()).hexdigest(),
           "graphs": graph_stats(be, captures)}
    # the analytic cross-shard merge traffic of the dispatches made: every
    # decode and chunked-prefill dispatch reads the pool (a wave writes only)
    want_bytes = sum(_split_kv_collective_bytes(S, cfg.n_layers, cfg.n_heads,
                                                cfg.hd, b, t)
                     for b, t in shapes["decode"]
                     + ([] if wave else shapes["prefill"]))
    log(f"serve {cfg.name} ({cfg.n_layers} layers) {mode}"
        f"{f', {S} kv shards' if S > 1 else ''}, {res['path']}: "
        f"{res['requests']} requests finished, {tokens} "
        f"tokens committed, {n_dec} decode + {n_pre} prefill dispatches, "
        f"{launches} paged ({merges} with a split merge) + {bd_launches} "
        f"block-diffusion kernel launches, {grouped} grouped products, "
        f"prefill shapes {sorted(set(shapes['prefill']))}, "
        f"{res['host_bytes_per_decode_dispatch']:.1f}"
        f" host bytes per decode dispatch, {wall:.3f} s wall, "
        f"{res['tok_per_s']:.2f} committed tok/s, max_memory_allocated "
        f"{res['max_memory_allocated']} B, chunks {res['chunks']}, "
        f"batches {res['batches']}; device dispatches "
        f"{be.device_dispatches}, collective bytes {be.collective_bytes}; "
        f"graphs {res['graphs']}; tokens sha1 {res['tokens_sha1']}")

    checks = [
        (len(rep.metrics) == len(reqs), "not every request finished"),
        (all(len(outs[r.rid]) == r.max_new_tokens for r in reqs),
         "a request committed the wrong number of tokens"),
        (all(0 <= t < cfg.vocab_size for v in outs.values() for t in v),
         "a committed token is outside the vocabulary"),
        (n_dec == len(shapes["decode"]) and n_pre == len(shapes["prefill"]),
         "dispatch counters disagree with the dispatches made"),
        (wave or launches == S * cfg.n_layers * (n_dec + n_pre),
         f"{launches} kernel launches != {S} x {cfg.n_layers} x "
         f"{n_dec + n_pre} dispatches"),
        (merges <= launches, f"{merges} merge launches > {launches} paged "
         f"launches"),
        (wave or bd_launches == 0,
         f"{bd_launches} block-diffusion launches in a chunked run"),
        (not wave or launches == S * cfg.n_layers * n_dec,
         f"{launches} paged launches != {S} x {cfg.n_layers} x {n_dec} "
         f"decode dispatches"),
        (not wave or bd_launches == cfg.n_layers * n_pre > 0,
         f"{bd_launches} block-diffusion launches != {cfg.n_layers} x "
         f"{n_pre} prefill dispatches"),
        (grouped == (3 * cfg.n_layers * (n_dec + n_pre) if sorted_moe
                     else 0),
         f"{grouped} grouped products != 3 x {cfg.n_layers} MoE layers x "
         f"{n_dec + n_pre} dispatches"),
        (be.host_transfer_bytes == dec_bytes + pre_bytes,
         "host bytes != 8·Bp·c per decode + 8·Bp per prefill dispatch"),
        (not budget_findings, "; ".join(f"{f.target}: {f.message}"
                                        for f in budget_findings[:3])),
        *pool_checks("the page pool", be.kv, ptrs),
        (be.kv.free_pages == be.kv.n_pages, "pages leaked"),
        (be.device_dispatches == S * (n_dec + n_pre),
         f"device_dispatches {be.device_dispatches} != {S} x "
         f"{n_dec + n_pre}"),
        (be.collective_bytes == want_bytes,
         f"collective_bytes {be.collective_bytes} != {want_bytes}, the "
         f"formula summed over the dispatches"),
    ]
    for ok, msg in checks:
        if not ok:
            raise AssertionError(f"serve {cfg.name} {mode}: {msg}")
    res["outputs"] = {r.rid: outs[r.rid] for r in reqs}
    res["gaps"] = gap_of
    res["margins"] = margin_of
    res["steps"] = steps_of
    return res


TWIN_KEYS = ("wall_s", "tok_per_s", "kernel_launches", "merge_launches",
             "bd_kernel_launches", "grouped_mm_calls", "decode_dispatches",
             "prefill_dispatches", "max_memory_allocated", "tokens_sha1")


def hold_twins(what: str, run: dict, eager: dict) -> dict:
    """Phase 15 (iii): a captured run against its eager twin — the same
    committed tokens (sha1), dispatches and launches.  Returns ``run`` with
    the twin's readings under "eager" and its recorded logit gaps."""
    same = {k: run[k] == eager[k] for k in TWIN_KEYS
            if k in run and not k.startswith(("wall", "tok_per", "max_"))}
    log(f"{what}: captured {run['wall_s']:.3f} s against eager "
        f"{eager['wall_s']:.3f} s wall; the same {sorted(same)}: "
        f"{all(same.values())}")
    if not all(same.values()):
        raise AssertionError(f"{what}: the captured run differs from its "
                             f"eager twin in "
                             f"{[k for k, v in same.items() if not v]}")
    run["eager"] = {k: eager[k] for k in TWIN_KEYS if k in eager}
    for k in ("outputs", "gaps", "margins", "steps"):
        if k in eager:
            run[k] = eager[k]
    return run


def serve_twins(model, params, mode: str, reqs, max_len: int,
                kv_shards: int = 1) -> dict:
    """One serving run eagerly (it records the logit gaps), then captured
    (the backend's default), each on ``reqs()``; held by
    :func:`hold_twins`."""
    import torch

    eager = serve_run(model, params, mode, reqs(), max_len, kv_shards,
                      graphs=False)
    torch.cuda.empty_cache()
    run = serve_run(model, params, mode, reqs(), max_len, kv_shards)
    return hold_twins(f"serve {model.cfg.name} {mode}"
                      f"{f', {kv_shards} kv shards' if kv_shards > 1 else ''}",
                      run, eager)


def dispatch_divergence(run, base, what: str, rule: str = "bf16") -> dict:
    """Each request's first decode dispatch (its k-th, counting only the
    dispatches it takes part in) where ``run`` and ``base`` differ, and the
    ``rule`` (the op tolerance ``base``'s steps carry as ``tol``: bf16's,
    or fp32's) held there, a check.

    Up to that dispatch both runs committed the same (position, token)
    pairs, so the request's state is the same.  Where the window differs
    too (start, length, chunk or the committed-at-input mask), the
    scheduler chose another chunk — other requests had diverged already —
    and the logits are of other inputs: a reading.  Where the window is
    the same, the commits differ only by the logits' rounding, and every
    difference must sit within the op tolerance ``eps`` = the rule's
    relative tolerance x max(|top-1|, 1) of ``base``'s logits there: a
    token that flips at a position both commit has ``base``'s top-1/top-2
    gap under ``eps``; a position above the threshold in one run only has
    |ln conf - ln threshold| under 2·eps (a move of every logit by eps
    moves ln conf by at most 2·eps); two runs that both commit their single most confident
    position (no position above the threshold) but pick different ones
    have |ln conf_p - ln conf_q| under 2·(eps_p + eps_q).  A dispatch's
    margin is its least such margin; below 0 is a fault."""
    import numpy as np

    out, faults = {}, []
    for rid, bsteps in base["steps"].items():
        for k, (b, r) in enumerate(zip(bsteps, run["steps"][rid])):
            same_window = (b["frozen"] == r["frozen"]
                           and b["valid"] == r["valid"] and b["c"] == r["c"]
                           and np.array_equal(b["cai"], r["cai"]))
            same_commits = (np.array_equal(b["commit"], r["commit"])
                            and np.array_equal(b["tok"][b["commit"]],
                                               r["tok"][r["commit"]]))
            if same_window and same_commits:
                continue
            rec = {"dispatch": k, "position": b["frozen"]}
            if not same_window:
                rec["kind"] = "window"
                out[rid] = rec
                break
            eps, ln = b["tol"], np.log(np.maximum(b["conf"], 1e-300))
            lnt = np.log(b["threshold"])
            margins = [("token", int(j), float(eps[j] - b["gap"][j]))
                       for j in np.nonzero(b["commit"] & r["commit"]
                                           & (b["tok"] != r["tok"]))[0]]
            if not np.array_equal(b["commit"], r["commit"]):
                unc = ~b["cai"]
                above = [(x["conf"] > x["threshold"]) & unc for x in (b, r)]
                if not above[0].any() and not above[1].any():
                    p, q = (int(np.argmax(x["commit"])) for x in (b, r))
                    margins.append(("fallback", (p, q), float(
                        2 * (eps[p] + eps[q]) - abs(ln[p] - ln[q]))))
                else:
                    margins += [("threshold", int(j),
                                 float(2 * eps[j] - abs(ln[j] - lnt)))
                                for j in np.nonzero(above[0] != above[1])[0]]
            kind, at, margin = min(margins, key=lambda m: m[2])
            rec.update(kind=kind, at=at, margin=margin,
                       differences=len(margins))
            out[rid] = rec
            if margin < 0:
                faults.append((rid, rec))
            break
    checked = {rid: x["margin"] for rid, x in out.items() if "margin" in x}
    log(f"{what}: first differing decode dispatch by request "
        f"{ {rid: (x['dispatch'], x['kind']) for rid, x in out.items()} }; "
        f"{rule} rule's margin there (same window) {checked}")
    if faults:
        raise AssertionError(f"{what}: a first differing dispatch breaks the "
                             f"{rule} rule: {faults}")
    return {"by_request": out, "checked": len(checked),
            "least_margin": min(checked.values()) if checked else None}


def compare_runs(wave: dict, chunked: dict,
                 what: str = "wave vs chunked elastic") -> dict:
    """Committed tokens of the wave run against the chunked elastic run on
    the same requests (or of any run with recorded gaps against a base
    run): the share that differ, the least top-1/top-2 logit gap (first
    run) among the tokens that differ, and the gap and the bf16 rule's
    margin at each request's first divergence.  The runs differ in the
    prefill kernel's bf16 rounding and in the chunks the elastic scheduler
    picks (it sees the whole backlog at once in wave mode), and a token
    committed a dispatch earlier or later moves every later window, so this
    is a reading, not a check."""
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
               for rid, i in first.items()},
           "margin_at_first_divergence": {
               rid: wave.get("margins", {}).get(rid, {}).get(i)
               for rid, i in first.items()}}
    log(f"{what} ({wave['arch']}): {diff}/{total} "
        f"committed tokens differ "
        f"(share {out['tokens_differ_share']:.4f}), "
        f"{out['requests_identical']} of {len(chunked['outputs'])} requests "
        f"identical; first divergence by request {first}; least top-1/top-2 "
        f"gap among the differing tokens (first run) "
        f"{out['least_gap_where_differ']}, at each first divergence "
        f"{out['gap_at_first_divergence']} (bf16 rule's margin "
        f"{out['margin_at_first_divergence']})")
    return out


# ---------------------------------------------------------------------------
# cluster phase (phase 7b): SDAR-8B replicas sharing one card
# ---------------------------------------------------------------------------

# twice phase 7's 8 elastic requests would be 16; cut to 12: with 16, phase
# 7b took 85.7 s on an H100 SXM (700 W) and the whole script 561 s, 30%
# over the 430 s it took before the phase
CLUSTER_REQUESTS = 12
CLUSTER_PROMPT, CLUSTER_NEW = (128, 512), (64, 128)
CLUSTER_MAX_LEN = 1024
CLUSTER_MEM_RTOL = 0.05          # the second replica's rise vs its pool
DRILL_PROMPT, DRILL_NEW, DRILL_SPILL_AT = 256, 64, 8


def build_replicas(model, params, n: int, router, graphs: bool = True,
                   **kw):
    """``build_model_cluster`` on the card in bf16, every replica's paged
    dispatches captured (``graphs``) or eager, with
    ``torch.cuda.memory_allocated()`` read before the first replica and
    after each replica's backend is built."""
    import torch

    from repro_torch.cluster import factory

    backend = factory.ModelBackend
    torch.cuda.synchronize()
    mem = [torch.cuda.memory_allocated()]

    def counted(*a, **k):
        be = backend(*a, graphs=graphs, **k)
        torch.cuda.synchronize()
        mem.append(torch.cuda.memory_allocated())
        return be

    factory.ModelBackend = counted
    try:
        cluster = factory.build_model_cluster(
            model, params, n, router, device=DEVICE,
            cache_dtype=torch.bfloat16, **kw)
    finally:
        factory.ModelBackend = backend
    return cluster, mem


def pool_bytes(kv) -> int:
    from repro_torch.analysis.rules import pool_tensors
    return sum(t.numel() * t.element_size() for t in pool_tensors(kv))


def pool_checks(what: str, pool, ptrs) -> list:
    """Rule HLO001 (``repro_torch.analysis.rules.check_pool_donation``) on a
    run's pool: every tensor at its ``data_ptr`` of before the run; as
    (ok, message) checks."""
    from repro_torch.analysis.rules import check_pool_donation
    fs = check_pool_donation(pool, ptrs, target=what)
    return [(not fs, "; ".join(f.message for f in fs))]


def spy_outputs(cores) -> dict:
    """Every replica's committed tokens at release: ``{(replica, rid):
    tokens}``."""
    outs = {}
    for i, core in enumerate(cores):
        be = core.backend

        def make(release, be, i):
            def spy(rid):
                outs[(i, rid)] = list(be.state(rid).output_tokens)
                release(rid)
            return spy

        be.release = make(be.release, be, i)
    return outs


def cluster_checks(what, cfg, params, cores, ptrs, outs, reqs) -> list:
    """The checks every phase-7b run shares: each request commits its
    ``max_new_tokens`` tokens, none the mask id or outside the vocabulary;
    the weights are the caller's (one ``data_ptr`` a weight across the
    replicas); every pool stayed in place and drained, no page seized or
    spilled."""
    want = {r.rid: r.max_new_tokens for r in reqs}
    got = {rid: toks for (_, rid), toks in outs.items() if rid in want}
    return [
        (sorted(got) == sorted(want), "not every request finished"),
        (all(len(got[rid]) == n for rid, n in want.items()),
         "a request committed the wrong number of tokens"),
        (all(0 <= t < cfg.vocab_size and t != cfg.mask_token_id
             for v in got.values() for t in v),
         "a committed token is the mask id or outside the vocabulary"),
        (all(core.backend.params is params and all(
            core.backend.params[n].data_ptr() == t.data_ptr()
            for n, t in params.items()) for core in cores),
         "a replica does not share the weights"),
        *[c for core, p in zip(cores, ptrs)
          for c in pool_checks(what, core.backend.kv, p)],
        (all(core.backend.kv.free_pages == core.backend.kv.n_pages
             and not core.backend.kv._spilled and not core.backend.kv._seized
             for core in cores), "a pool did not drain"),
    ]


def raise_failed(what, checks):
    for ok, msg in checks:
        if not ok:
            raise AssertionError(f"{what}: {msg}")


def cluster_run(model, params, name: str, router: str, prefill_mode: str,
                reqs, graphs: bool = True) -> dict:
    """One ``build_model_cluster`` run of two SDAR-8B replicas sharing the
    weights, their dispatches captured (``graphs``) or eager: every request
    at t = 0, the kernels' launch counts set to 0 before
    ``ClusterEngine.run`` and read after it."""
    import hashlib

    import torch

    from repro_torch.analysis import rules
    from repro_torch.kernels import block_diffusion_attn as bda
    from repro_torch.kernels import chunked_paged_attn as cpa
    from repro_torch.serving import DATASETS

    cfg = model.cfg
    host_pages = -(-(CLUSTER_PROMPT[1] + CLUSTER_NEW[1]) // cfg.kv_page_size)
    cluster, mem = build_replicas(
        model, params, 2, router, graphs, profile=DATASETS["sharegpt"],
        mode="elastic", n_slots=8, max_len=CLUSTER_MAX_LEN,
        prefill_mode=prefill_mode, host_kv_pages=host_pages)
    cores = cluster.replicas
    sizes = [pool_bytes(core.backend.kv) for core in cores]
    rise = mem[2] - mem[1]
    ptrs = [rules.pool_ptrs(core.backend.kv) for core in cores]
    outs = spy_outputs(cores)
    torch.cuda.synchronize()
    cpa.LAUNCHES = cpa.MERGE_LAUNCHES = bda.LAUNCHES = 0
    captures = dict(CAPTURES)
    t0 = time.perf_counter()
    rep = cluster.run(list(reqs))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, merges, bd_launches = (cpa.LAUNCHES, cpa.MERGE_LAUNCHES,
                                     bda.LAUNCHES)
    n_dec = [core.backend.decode_dispatches for core in cores]
    n_pre = [core.backend.prefill_dispatches for core in cores]
    tokens = sum(len(v) for v in outs.values())
    wave = prefill_mode == "wave"
    res = {"run": name, "router": router, "prefill_mode": prefill_mode,
           "requests": len(rep.metrics), "tokens_committed": tokens,
           "wall_s": wall, "tok_per_s": tokens / wall,
           "route_counts": list(rep.route_counts), "spills": rep.spills,
           "preemptions": rep.preemptions, "migrations": rep.migrations,
           "rejected": list(rep.rejected),
           "decode_dispatches": n_dec, "prefill_dispatches": n_pre,
           "kernel_launches": launches, "merge_launches": merges,
           "bd_kernel_launches": bd_launches,
           "pool_bytes": sizes, "memory_rise_second_replica": rise,
           "outputs": {rid: toks for (_, rid), toks in outs.items()},
           "path": "captured" if graphs else "eager",
           "graphs": [graph_stats(core.backend) for core in cores],
           "capture_s": CAPTURES["s"] - captures["s"] if graphs else None}
    res["tokens_sha1"] = hashlib.sha1(json.dumps(
        [res["outputs"][rid] for rid in sorted(res["outputs"])]).encode()
                                      ).hexdigest()
    log(f"cluster {name}, {res['path']} ({router}, {prefill_mode} prefill, "
        f"2 replicas of "
        f"{cfg.name}, {cfg.n_layers} layers): {res['requests']} requests "
        f"finished, {tokens} tokens committed in {wall:.3f} s wall "
        f"({res['tok_per_s']:.2f} committed tok/s); routed "
        f"{res['route_counts']}, spills {rep.spills}, preemptions "
        f"{rep.preemptions}, migrations {rep.migrations}; decode "
        f"dispatches {n_dec}, prefill dispatches {n_pre}; {launches} paged "
        f"({merges} with a split merge) + {bd_launches} block-diffusion "
        f"launches; pools {sizes} B, memory_allocated rose {rise} B when "
        f"the second replica was built; graphs {res['graphs']}")
    weights = sum(t.numel() * t.element_size() for t in params.values())
    checks = cluster_checks(f"cluster {name}", cfg, params, cores, ptrs,
                            outs, reqs) + [
        (len(rep.metrics) == len(reqs) and not rep.rejected,
         "a request was rejected"),
        (all(n >= 1 for n in rep.route_counts), "a replica was routed none"),
        (abs(rise - sizes[1]) <= CLUSTER_MEM_RTOL * sizes[1]
         and rise < weights,
         f"the second replica raised memory_allocated by {rise} B, its "
         f"pool is {sizes[1]} B (the weights {weights} B)"),
        (launches == cfg.n_layers * (sum(n_dec) if wave
                                     else sum(n_dec) + sum(n_pre)),
         f"{launches} paged launches != {cfg.n_layers} x the "
         f"{'decode' if wave else 'decode + chunked-prefill'} dispatches"),
        (merges <= launches, f"{merges} merges > {launches} launches"),
        (bd_launches == (cfg.n_layers * sum(n_pre) if wave else 0)
         and (not wave or bd_launches > 0),
         f"{bd_launches} block-diffusion launches, {sum(n_pre)} "
         f"{prefill_mode}-prefill dispatches"),
    ]
    raise_failed(f"cluster {name}", checks)
    return res


def migration_drill(model, params, seed: int, graphs: bool = True,
                    eager: dict | None = None) -> dict:
    """The migration drill of the reference's fault-tolerance tests at
    full width: one request (prompt 256, 64 new tokens) on replica 0 is
    force-spilled once it has committed 8 tokens, migrated out and into
    replica 1 and finished there; replica 2 serves the same request
    uninterrupted.  The ticket's K/V must equal the source pages read just
    before the spill, the destination's pages must hold them after the
    swap-in, and the tokens must equal the uninterrupted run's (else the
    first divergence and its top-1/top-2 gap are recorded; a gap above
    the bf16 tolerance is a fault).  With ``graphs`` the replicas'
    dispatches are captured and the gap is that of ``eager``, the drill's
    eager twin (a replay computes no logits on the host)."""
    import hashlib

    import torch

    from repro_torch.analysis import rules
    from repro_torch.kernels import block_diffusion_attn as bda
    from repro_torch.kernels import chunked_paged_attn as cpa
    from repro_torch.serving import DATASETS

    cfg = model.cfg
    n_pages = -(-(DRILL_PROMPT + DRILL_NEW) // cfg.kv_page_size)
    cluster, _ = build_replicas(
        model, params, 3, "round_robin", graphs,
        profile=DATASETS["sharegpt"], mode="bd8", n_slots=8,
        max_len=CLUSTER_MAX_LEN, prefill_mode="chunked",
        host_kv_pages=n_pages)
    cores = cluster.replicas
    src, dst, solo = cores
    ptrs = [rules.pool_ptrs(core.backend.kv) for core in cores]
    outs = spy_outputs(cores)
    make = lambda: make_requests(  # noqa: E731
        cfg, seed + 2, 1, (DRILL_PROMPT, DRILL_PROMPT),
        (DRILL_NEW, DRILL_NEW))
    bits = lambda t: t.contiguous().view(torch.int16)  # noqa: E731

    def serve(core, gaps, req=None):
        undo = (lambda: None) if graphs else record_gaps(core.backend, gaps)
        try:
            if req is not None:
                core.submit(req)
            while not core.idle:
                core.tick()
        finally:
            undo()

    torch.cuda.synchronize()
    cpa.LAUNCHES = cpa.MERGE_LAUNCHES = bda.LAUNCHES = 0
    captures = dict(CAPTURES)
    t0 = time.perf_counter()
    solo_gaps, mig_gaps = {}, {}
    serve(solo, solo_gaps, make()[0])
    # the source: serve until 8 tokens are committed and the prefill is done
    s = src.backend
    src.submit(make()[0])
    while not src.idle:
        st = s._states.get(0)
        if st is not None and st.n_committed >= DRILL_SPILL_AT \
                and not s._prefill.pending(0):
            break
        src.tick()
    committed = s._states[0].n_committed
    table = s.kv.block_table(0)
    n_tokens = s.kv.length(0)
    before = (s.kv.k_pages[:, table].cpu(), s.kv.v_pages[:, table].cpu())
    spilled = src.preempt(0, reason="drain", force_spill=True)
    (moved,) = src.take_pending()
    ticket = s.migrate_out(0)
    payload = ticket["payload"] if ticket is not None else {}
    # the destination: adopt, then the spill-resume admission swaps in
    d = dst.backend
    swapped = {}
    swap_in = d.kv.swap_in_request

    def swap_in_read(rid):
        new = swap_in(rid)
        swapped["pages"] = (d.kv.k_pages[:, new].cpu(),
                            d.kv.v_pages[:, new].cpu())
        return new

    d.kv.swap_in_request = swap_in_read
    adopted = d.migrate_in(moved, ticket)
    dst.note_failover(moved.rid)
    serve(dst, mig_gaps, moved)
    del d.kv.swap_in_request
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, merges, bd_launches = (cpa.LAUNCHES, cpa.MERGE_LAUNCHES,
                                     bda.LAUNCHES)
    n_disp = sum(core.backend.decode_dispatches
                 + core.backend.prefill_dispatches for core in cores)

    base, mig = outs.get((2, 0), []), outs.get((1, 0), [])
    first = next((i for i, (a, b) in enumerate(zip(base, mig)) if a != b),
                 None)
    gap = None
    if first is not None and eager is not None:
        gap = eager["gap_at_first_divergence"]
    elif first is not None:
        gaps = [g.get(first) for g in (*solo_gaps.values(),
                                       *mig_gaps.values())]
        gap = min((g for g in gaps if g is not None), default=None)
    payload_equal = bool(
        payload.get("k") is not None
        and payload["k"].device.type == "cpu"
        and torch.equal(bits(payload["k"]), bits(before[0]))
        and torch.equal(bits(payload["v"]), bits(before[1])))
    swap_equal = bool(
        "pages" in swapped
        and torch.equal(bits(swapped["pages"][0]), bits(before[0]))
        and torch.equal(bits(swapped["pages"][1]), bits(before[1])))
    res = {"committed_at_spill": committed, "spilled_tokens": n_tokens,
           "spilled_pages": len(table), "payload_equal": payload_equal,
           "swap_in_equal": swap_equal, "tokens_equal": base == mig,
           "first_divergence": first, "gap_at_first_divergence": gap,
           "wall_s": wall, "tokens_committed": len(base) + len(mig),
           "kernel_launches": launches, "merge_launches": merges,
           "bd_kernel_launches": bd_launches,
           "path": "captured" if graphs else "eager",
           "tokens_sha1": hashlib.sha1(json.dumps([base, mig]).encode()
                                       ).hexdigest(),
           "graphs": [graph_stats(core.backend) for core in cores],
           "capture_s": CAPTURES["s"] - captures["s"] if graphs else None}
    log(f"migration drill, {res['path']} ({cfg.name}, {cfg.n_layers} "
        f"layers): spilled at "
        f"{committed} committed tokens ({n_tokens} tokens in {len(table)} "
        f"pages), ticket K/V equal to the source pages: {payload_equal}, "
        f"the destination's pages after swap-in: {swap_equal}; migrated "
        f"tokens equal the uninterrupted run's: {base == mig} (first "
        f"divergence {first}, gap {gap}); {wall:.3f} s wall for both runs, "
        f"{launches} paged ({merges} with a split merge) + {bd_launches} "
        f"block-diffusion launches")
    checks = cluster_checks("migration drill", cfg, params, cores, ptrs,
                            {k: v for k, v in outs.items() if k != (2, 0)},
                            make()) + [
        (len(base) == DRILL_NEW, "the uninterrupted run did not finish"),
        (committed >= DRILL_SPILL_AT and bool(spilled) and ticket is not None
         and adopted, "the spill, the ticket or the adoption failed"),
        (payload_equal, "the ticket's K/V differs from the source pages"),
        (swap_equal, "the destination's pages differ after the swap-in"),
        (base == mig or (gap is not None and gap <= BF16_TOL),
         f"the migrated tokens diverge at {first} with gap {gap}"),
        (launches == cfg.n_layers * n_disp and bd_launches == 0,
         f"{launches} paged launches != {cfg.n_layers} x {n_disp} "
         f"dispatches, or {bd_launches} block-diffusion launches"),
    ]
    raise_failed("migration drill", checks)
    return res


def cluster_phase(model, params, seed: int, elastic: dict) -> dict:
    """Phase 7b: (i) chunked prefill behind the saturation router, (ii)
    wave prefill behind round robin, on the same 12 requests, and (iii)
    the migration drill, each eagerly and then captured, held to its eager
    twin (:func:`hold_twins`).  The first 8 requests are phase 7's elastic
    run's; how many commit the same tokens, and where each first differs,
    is a reading."""
    import torch

    cfg = model.cfg
    t0 = time.perf_counter()
    reqs = lambda: make_requests(  # noqa: E731
        cfg, seed, CLUSTER_REQUESTS, CLUSTER_PROMPT, CLUSTER_NEW)
    runs = []
    for name, router, prefill in (("chunked", "saturation", "chunked"),
                                  ("wave", "round_robin", "wave")):
        twin = []
        for graphs in (False, True):
            twin.append(cluster_run(model, params, name, router, prefill,
                                    reqs(), graphs))
            gc.collect()
            torch.cuda.empty_cache()
        runs.append(hold_twins(f"cluster {name}", twin[1], twin[0]))
    first = {rid: next((i for i, (a, b) in enumerate(
        zip(runs[0]["outputs"][rid], toks)) if a != b), None)
        for rid, toks in elastic["outputs"].items()}
    same = sum(i is None for i in first.values())
    log(f"cluster chunked vs phase 7's elastic run: {same} of "
        f"{len(first)} shared requests commit the same tokens; first "
        f"divergence by request {first}")
    eager = migration_drill(model, params, seed, graphs=False)
    gc.collect()
    torch.cuda.empty_cache()
    drill = hold_twins("migration drill", migration_drill(
        model, params, seed, eager=eager), eager)
    gc.collect()
    torch.cuda.empty_cache()
    for r in runs:
        del r["outputs"]
    wall = time.perf_counter() - t0
    log(f"phase 7b: {wall:.3f} s wall")
    return {"runs": runs, "drill": drill, "same_as_phase7": same,
            "first_divergence_vs_phase7": first, "wall_s": wall}


# ---------------------------------------------------------------------------
# sharded pool phase (phase 7c): split-KV over an S-shard mesh of one card
# ---------------------------------------------------------------------------

SPLIT_SHARDS = (2, 4)              # kernel level, at shape (a)
SPLIT_DECODE_SHARDS = 4            # dispatch level
SPLIT_SERVE = (("elastic", 4), ("wave", 2))   # serving: mode, kv_shards
# The dispatch level holds the sharded decode dispatch against the same
# dispatch unsharded (both through the kernel) at phase 4's limits, plus:
#   pages_rel   max |pages - pages_unsharded| / std over the K/V rows the
#               dispatch froze (4 a row, 36 layers), at the logits' limit:
#               layers >= 1 carry the same downstream rounding
#   prefix_rel  max |o - o_unsharded| / max |o_unsharded|, o = acc / l of
#               the first layer's paged-prefix partial (live rows): the
#               call site, whose inputs are identical on both paths
# The control skews ONE shard's acc by CONTROL_SKEW.  A row's keys spread
# over the S shards, so the skew reaches the output at about 1/S of phase
# 4's strength, under the downstream noise of 36 random bf16 layers; the
# control must break prefix_rel, and its downstream readings are printed.
# Split-KV changes only the fp32 order of the prefix partial's sums
# (about 1e-6 relative at the call site); a one-shard 3% skew moves it by
# about 1e-2.
SPLIT_LIMITS = {**MODEL_LIMITS, "pages_rel": MODEL_LIMITS["logits_rel"],
                "prefix_rel": 5e-4}
SPLIT_CONTROL_BREAKS = ("prefix_rel",)


def kv_shard_spec(S: int):
    """An S-shard ``kv`` mesh whose every shard is this card."""
    from repro_torch.distributed.collectives import KVShardSpec
    from repro_torch.launch.mesh import make_kv_mesh
    return KVShardSpec(make_kv_mesh(S, devices=[DEVICE] * S), S)


def striped_tables(S: int, lens, page_size: int, n_pages: int):
    """Block tables from a real ``PagedKVAllocator(kv_shards=S)`` holding
    ``lens[b]`` tokens for row b: (allocator, tables [B, W] int32, stripe
    offsets [B] int32), the tensors on the card."""
    import numpy as np
    import torch

    from repro_torch.serving.kv_pool import PagedKVAllocator
    kv = PagedKVAllocator(n_pages, page_size, kv_shards=S)
    for rid, n in enumerate(lens):
        kv.allocate(rid, n)
    rids = list(range(len(lens)))
    W = max(kv.pages_for(max(lens)), 1)
    tables = torch.as_tensor(np.array(kv.batch_tables(rids, W)),
                             dtype=torch.int32, device=DEVICE)
    offs = torch.as_tensor(kv.stripe_offsets(rids), dtype=torch.int32,
                           device=DEVICE)
    return kv, tables, offs


def split_kernel_level(seed: int) -> list[dict]:
    """``split_kv_paged_partial`` at shape (a) for S in SPLIT_SHARDS, tables
    from a striped allocator, both layouts holding the same logical K/V:
    the combined output held against the unsharded kernel's, the plain
    version's and the plain split-KV version's (bf16 tolerance); a ctx-0
    row the exact empty partial, and a row whose every token sits on one
    shard bit-equal to that shard's own partial (the empty shards merge to
    a no-op).  CUDA-event times for S = 1, 2, 4 beside phase 3's bound."""
    import torch

    from repro_torch.distributed import collectives as coll
    from repro_torch.kernels import chunked_paged_attn as cpa
    from repro_torch.kernels.ops import combine_flash_partials

    name, B, c, H, KVH, D, ps, dtype, ctx = KERNEL_SHAPES[0]
    n_pages = B * -(-max(ctx) // ps) + 16
    b_ms, b_by = bound(B, c, H, KVH, D, ps, dtype, ctx)
    lens = torch.as_tensor(ctx, dtype=torch.int32, device=DEVICE)
    rows = []
    for S in (1,) + SPLIT_SHARDS:
        kv, tables, offs = striped_tables(S, ctx, ps, n_pages)
        g = torch.Generator(device=DEVICE).manual_seed(seed + S)
        q, kp, vp = (torch.randn(shape, generator=g, device=DEVICE)
                     .to(getattr(torch, dtype)) for shape in
                     ((B, c, H, D), (n_pages, ps, KVH, D),
                      (n_pages, ps, KVH, D)))
        if S == 1:
            def call():
                return cpa.paged_chunk_attention_kernel(q, kp, vp, tables,
                                                        lens)
        else:
            ks = kv_shard_spec(S)
            kb, vb = (coll.shard_pages(t, ks, dim=0) for t in (kp, vp))

            def call():
                return coll.split_kv_paged_partial(q, kb, vb, tables, lens,
                                                   offs, ks)
        before = (cpa.LAUNCHES, cpa.MERGE_LAUNCHES)
        got = call()
        torch.cuda.synchronize()
        launches = (cpa.LAUNCHES - before[0], cpa.MERGE_LAUNCHES - before[1])
        row = {"S": S, "shape": name, "ms": time_ms(call), "bound_ms": b_ms,
               "bound_by": b_by, "paged_launches_per_call": launches[0],
               "merge_launches_per_call": launches[1]}
        if launches[0] != S:
            raise AssertionError(f"split-KV (a), S {S}: {launches[0]} paged "
                                 f"launches in one call, not {S}")
        if S > 1:
            out = combine_flash_partials([got])
            refs = {"unsharded kernel": cpa.paged_chunk_attention_kernel(
                        q, kp, vp, tables, lens),
                    "plain": cpa.paged_chunk_ref(q, kp, vp, tables, lens),
                    "plain split-KV": coll.split_kv_paged_partial(
                        q, kb, vb, tables, lens, offs, ks, impl="ref")}
            for what, r in refs.items():
                want = combine_flash_partials([r])
                rel = float((out - want).abs().max() / want.abs().max())
                row[f"rel_err_vs_{what.replace(' ', '_')}"] = rel
                if not rel < BF16_TOL:
                    raise AssertionError(f"split-KV (a), S {S}: output vs "
                                         f"{what} {rel} >= {BF16_TOL}")
            acc, m, l = got
            for i in [i for i, x in enumerate(ctx) if x == 0]:
                if not (torch.all(acc[i] == 0) and torch.all(l[i] == 0)
                        and torch.all(m[i] == -1e30)):
                    raise AssertionError(f"split-KV S {S}: ctx-0 row {i} is "
                                         f"not the empty partial")
            one = [i for i, x in enumerate(ctx) if 0 < x <= ps]
            for i in one:
                sh = kv.shard_of(kv.block_table(i)[0])
                lt, lc = coll._local_slots(tables, lens, offs, sh,
                                           n_shards=S,
                                           pages_local=kv.pages_per_shard,
                                           page_size=ps)
                own = cpa.paged_chunk_attention_kernel(q, kb[sh], vb[sh],
                                                       lt, lc)
                if not all(torch.equal(a[i], b[i]) for a, b in
                           zip(got, own)):
                    raise AssertionError(f"split-KV S {S}: row {i} (every "
                                         f"token on shard {sh}) differs "
                                         f"from its shard's own partial")
            row["one_shard_rows_exact"] = one
        rows.append(row)
        log(f"split-KV kernel level (a), S {S}: {row['ms']:.4f} ms "
            f"({row['ms'] / b_ms:.1f}x the bound {b_ms:.5f} ms, {b_by}), "
            f"{launches[0]} paged + {launches[1]} merge launches a call"
            + "".join(f", rel err vs {k[11:]} {v:.3e}" for k, v in
                      row.items() if k.startswith("rel_err_vs_")))
        del q, kp, vp, got
    return rows


def split_dispatch_level(model, params, seed: int) -> dict:
    """One full-width ``decode_step_paged`` with the pool sharded over
    SPLIT_DECODE_SHARDS shards, against the same dispatch unsharded on the
    same weights and logical pool (both through the kernel), at
    SPLIT_LIMITS; the writes land where the unsharded dispatch's do, the
    first layer's bit-equal, and the rest of the pool is untouched."""
    import torch

    import repro_torch.models.transformer as tfm
    from repro_torch.distributed import collectives as coll
    from repro_torch.kernels.ops import combine_flash_partials

    cfg = model.cfg
    S, ps = SPLIT_DECODE_SHARDS, cfg.kv_page_size
    n_pages = MODEL_B * -(-(max(MODEL_CTX) + MODEL_C) // ps)
    kv, tables, offs = striped_tables(
        S, [x + MODEL_C for x in MODEL_CTX], ps, n_pages)
    ks = kv_shard_spec(S)
    flat = model.init_paged_cache(n_pages, ps, dtype=torch.bfloat16,
                                  device=DEVICE)
    g = torch.Generator(device=DEVICE).manual_seed(seed + 11)
    for t in flat.values():
        t.copy_(torch.randn(t.shape, generator=g, device=DEVICE))
    start_pool = {n: t.clone() for n, t in flat.items()}
    win, start, valid, _ = decode_inputs(model, MODEL_CTX, seed)
    n_adv = torch.full((MODEL_B,), 4, dtype=torch.int64, device=DEVICE)
    L, P, _, KVH, hd = flat["k_pages"].shape
    pos = start[:, None] + torch.arange(4, device=DEVICE)[None]
    dest = tfm._page_dest(tables, pos, torch.ones_like(pos, dtype=torch.bool),
                          ps, P).reshape(-1)
    live = [i for i, x in enumerate(MODEL_CTX) if x > 0]
    first = {}

    def catch(name, fn):
        def wrapped(*a, **k):
            out = fn(*a, **k)
            first.setdefault(name, out)
            return out
        return wrapped

    def dispatch(sharded: bool):
        first.clear()
        cache = ({n: coll.shard_pages(t, ks) for n, t in start_pool.items()}
                 if sharded else {n: t.clone() for n, t in
                                  start_pool.items()})
        kw = {"kv_shard": ks, "shard_offs": offs} if sharded else {}
        name = "split_kv_paged_partial" if sharded else \
            "paged_chunk_attention"
        keep = getattr(tfm, name)
        setattr(tfm, name, catch("prefix", keep))
        try:
            conf, tok, _ = model.decode_step_paged(
                params, cache, win, start, valid, tables, start, n_adv,
                impl="kernel", **kw)
        finally:
            setattr(tfm, name, keep)
        logits, _ = model.chunk_forward_paged(params, cache, win, start,
                                              valid, tables, start,
                                              impl="kernel", **kw)
        pools = {n: coll.unshard_pages(t) if sharded else t
                 for n, t in cache.items()}
        prefix = combine_flash_partials([first["prefix"]])[live]
        for t in (conf, logits):
            if not torch.isfinite(t).all():
                raise AssertionError(f"split-KV dispatch: non-finite output "
                                     f"(sharded {sharded})")
        return conf, tok, logits, pools, prefix

    cu, tu, lu, pu, ou = dispatch(False)
    sharded = dispatch(True)
    exact = coll.paged_chunk_attention
    calls = [0]

    def one_shard_skewed(*a, **k):
        acc, m, l = exact(*a, **k)
        calls[0] += 1
        if calls[0] % S == 1:              # shard 0 of every split-KV call
            acc = acc * (1 + CONTROL_SKEW)
        return acc, m, l

    coll.paged_chunk_attention = one_shard_skewed
    try:
        control = dispatch(True)
    finally:
        coll.paged_chunk_attention = exact
    torch.cuda.synchronize()

    written = lambda pools: torch.cat(  # noqa: E731
        [pools[n].view(L, P * ps, KVH, hd)[:, dest] for n in
         ("k_pages", "v_pages")]).float()
    wu = written(pu)
    wu_std = float(wu.std())
    readings, margin_of, gap, lu_std = decode_readings(cu, tu, lu)

    def all_readings(conf, tok, logits, pools, prefix):
        r = readings(conf, tok, logits)
        r["pages_rel"] = float((written(pools) - wu).abs().max()) / wu_std
        r["prefix_rel"] = float((prefix - ou).abs().max()
                                / ou.abs().max())
        return r

    sound, ctl = all_readings(*sharded), all_readings(*control)
    n_diff, max_gap, margin = margin_of(sharded[1])
    # the writes: layer 0's frozen K/V bit-equal (they depend on the
    # embeddings only), and outside the frozen rows nothing in either pool
    # moved
    def outside(t):
        t = t.view(L, P * ps, KVH, hd).clone()
        t[:, dest] = 0
        return t

    for n in ("k_pages", "v_pages"):
        a, b = (t.view(L, P * ps, KVH, hd) for t in (sharded[3][n], pu[n]))
        if not torch.equal(a[0, dest], b[0, dest]):
            raise AssertionError("split-KV dispatch: layer 0's frozen K/V "
                                 "differ from the unsharded dispatch's")
        if not (torch.equal(outside(a), outside(b))
                and torch.equal(outside(b), outside(start_pool[n]))):
            raise AssertionError("split-KV dispatch: a pool row outside the "
                                 "frozen ones changed")
    res = {"S": S, "B": MODEL_B, "c": MODEL_C, "ctx_lens": MODEL_CTX,
           "stripe_offsets": offs.tolist(), "tokens": tu.numel(),
           "tokens_differ": n_diff, "max_gap_where_differ": max_gap,
           "gap_margin": margin, "frozen_kv_rows": int(dest.numel()),
           "sharded_vs_unsharded": sound, "control_skew": CONTROL_SKEW,
           "control_one_shard_vs_unsharded": ctl, "limits": SPLIT_LIMITS,
           "control_breaks": SPLIT_CONTROL_BREAKS}
    log(f"split-KV dispatch (decode_step_paged, B {MODEL_B}, c {MODEL_C}, "
        f"ctx {MODEL_CTX}, S {S}, stripe offsets {res['stripe_offsets']}): "
        f"tokens differ {n_diff}/{tu.numel()} from the unsharded dispatch "
        f"(largest gap where they differ {max_gap:.4f}, least margin "
        f"{margin}); {res['frozen_kv_rows']} K/V rows frozen a layer, layer "
        f"0's bit-equal, the rest of the pool untouched")
    for key, lim in SPLIT_LIMITS.items():
        log(f"  {key}: sharded {sound[key]:.6g}  control (shard 0's acc x "
            f"{1 + CONTROL_SKEW}) {ctl[key]:.6g}  limit {lim}")
    if n_diff and not margin > 0:
        raise AssertionError("split-KV dispatch: a token differs where its "
                             "top-1/top-2 gap exceeds the bf16 tolerance")
    check_limits("split-KV dispatch", sound, ctl, SPLIT_LIMITS,
                 SPLIT_CONTROL_BREAKS)
    return res


def split_phase(model, params, seed: int, base: dict) -> dict:
    """Phase 7c: the kernel level, the dispatch level, then phase 7's
    elastic requests served with the pool sharded (SPLIT_SERVE); each
    serving run's committed tokens against phase 7's unsharded run of the
    same prefill mode (``base``): a reading, and the bf16 rule at each
    request's first differing dispatch (:func:`dispatch_divergence`), a
    check."""
    import torch

    t0 = time.perf_counter()
    kernel = split_kernel_level(seed)
    torch.cuda.empty_cache()
    dispatch = split_dispatch_level(model, params, seed)
    gc.collect()
    torch.cuda.empty_cache()
    runs, vs = [], {}
    for mode, S in SPLIT_SERVE:
        run = serve_twins(model, params, mode, lambda: make_requests(
            model.cfg, seed, 8, (128, 512), (64, 128)), max_len=1024,
            kv_shards=S)
        what = f"{mode}, {S} kv shards vs unsharded"
        vs[f"{mode}, S {S}"] = compare_runs(run, base[mode], what)
        vs[f"{mode}, S {S}"]["first_dispatch"] = dispatch_divergence(
            run, base[mode], what)
        del run["outputs"], run["gaps"], run["margins"], run["steps"]
        runs.append(run)
        gc.collect()
        torch.cuda.empty_cache()
    wall = time.perf_counter() - t0
    log(f"phase 7c: {wall:.3f} s wall")
    return {"kernel_level": kernel, "dispatch_level": dispatch,
            "runs": runs, "vs_unsharded": vs, "wall_s": wall}


# ---------------------------------------------------------------------------
# captured dispatches (phase 15): one CUDA graph per bucket against eager
# ---------------------------------------------------------------------------

GRAPH_B, GRAPH_C, GRAPH_T = 8, 32, 512
GRAPH_CTX = (512, 2048)            # the decode dispatch's contexts
GRAPH_ITERS, GRAPH_PROFILED = 5, 3


def graphs_phase(model, params, seed: int) -> dict:
    """Phase 15 (i)-(ii): SDAR-8B's three paged dispatches through a
    captured ``ModelBackend`` and its eager twin (``graphs=False``), each
    with its own bf16 pool holding the same random K/V and the same 8
    requests' pages: decode at B 8, c 32 with every context at 512 and at
    2048 (4 window tokens frozen a row), a chunked prefill of 512 tokens
    after 512, a wave prefill of [8, 512] at shape (e)'s lengths.  Each
    runs once on both sides (the captured side captures), then once more:
    conf and tok bit-equal, the pools bit-equal, the captured pool in
    place, the kernels' launches a replay as many as the eager call's
    (layers for the paged kernel in decode and chunked prefill, with the
    same merges; layers for the block-diffusion kernel in the wave).
    Then each side's wall (host clock around the dispatch and its conf/tok
    fetch, median of GRAPH_ITERS) and ``torch.profiler`` over
    GRAPH_PROFILED calls: device ms, kernels, busy share.  (ii) The
    captured side's graphs, capture seconds and graph-pool bytes."""
    import numpy as np
    import torch

    from repro_torch.analysis import rules
    from repro_torch.kernels import block_diffusion_attn as bda
    from repro_torch.kernels import chunked_paged_attn as cpa
    from repro_torch.serving import ModelBackend

    cfg = model.cfg
    B, c, T = GRAPH_B, GRAPH_C, GRAPH_T
    t0 = time.perf_counter()
    captures = dict(CAPTURES)
    max_len = max(GRAPH_CTX) + c
    sides = {side: ModelBackend(model, params, n_slots=B, max_len=max_len,
                                cache_dtype=torch.bfloat16, device=DEVICE,
                                graphs=side == "captured")
             for side in ("captured", "eager")}
    cap, eag = sides["captured"], sides["eager"]
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    for be in sides.values():
        for r in range(B):
            be.kv.allocate(r, max_len)
    for a, b in zip(rules.pool_tensors(cap.kv), rules.pool_tensors(eag.kv)):
        a.copy_(torch.randn(a.shape, generator=g, device=DEVICE))
        b.copy_(a)
    ptrs = rules.pool_ptrs(cap.kv)
    tables = {side: np.asarray(be.kv.batch_tables(list(range(B)),
                                                  be._table_width), np.int32)
              for side, be in sides.items()}
    if not np.array_equal(tables["captured"], tables["eager"]):
        raise AssertionError("phase 15: the two pools' tables differ")
    tables = tables["eager"]
    rng = np.random.default_rng(seed)
    V = cfg.vocab_size

    def window(ctx):
        w = np.full((B, c), cfg.mask_token_id, np.int64)
        w[:, :4] = rng.integers(4, V - 8, (B, 4))
        return dict(toks=w, start=np.full(B, ctx, np.int64),
                    valid=np.full(B, c, np.int64), tables=tables,
                    n_adv=np.full(B, 4, np.int64))

    prompts = rng.integers(4, V - 8, (B, T)).astype(np.int64)
    cases = [(f"decode, ctx {ctx}", "decode", "_decode", window(ctx))
             for ctx in GRAPH_CTX] + [
        ("prefill chunk, [8, 512] after 512", "chunk", "_chunk",
         dict(toks=prompts, offs=np.full(B, T, np.int64),
              valid=np.full(B, T, np.int64), tables=tables)),
        ("wave prefill, [8, 512]", "wave", "_wave",
         dict(toks=prompts, lens=np.asarray(WAVE_LENGTHS, np.int32),
              tables=tables))]

    def counts():
        return np.array([cpa.LAUNCHES, cpa.MERGE_LAUNCHES, bda.LAUNCHES])

    rows, launches = [], np.zeros(3, np.int64)
    for what, kind, fn, host in cases:
        def call(side):
            be = sides[side]
            conf, tok = be._dispatch(kind, getattr(be, fn), **host)
            return conf.cpu(), tok.cpu()

        n0 = counts()
        for side in sides:                 # the captured side captures
            call(side)
        per = {}
        out = {}
        for side in sides:
            c0 = counts()
            out[side] = call(side)
            per[side] = counts() - c0
        launches += counts() - n0
        paged, merges, bd = per["captured"]
        want = (0 if kind == "wave" else cfg.n_layers,
                cfg.n_layers if kind == "wave" else 0)
        checks = [
            (torch.equal(out["captured"][0], out["eager"][0])
             and torch.equal(out["captured"][1], out["eager"][1]),
             "conf/tok differ from the eager twin's"),
            (all(torch.equal(a, b) for a, b in zip(
                rules.pool_tensors(cap.kv), rules.pool_tensors(eag.kv))),
             "the pools differ from the eager twin's"),
            *pool_checks("phase 15 pool", cap.kv, ptrs),
            ((paged, bd) == want and np.array_equal(per["captured"],
                                                   per["eager"]),
             f"launches a replay {per['captured'].tolist()}, eager "
             f"{per['eager'].tolist()}, want paged/bd {want}"),
        ]
        raise_failed(f"phase 15 {what}", checks)
        row = {"dispatch": what, "kind": kind, "bit_equal": True,
               "launches_per_call": per["captured"].tolist()}
        kernel = "block_diffusion" if kind == "wave" else "paged_chunk_attn"
        for side in sides:
            c0 = counts()
            ts = []
            for _ in range(GRAPH_ITERS):
                t1 = time.perf_counter()
                call(side)
                ts.append((time.perf_counter() - t1) * 1e3)
            prof = device_profile(lambda: call(side), kernel, GRAPH_PROFILED,
                                  require=side == "eager")
            n = GRAPH_ITERS + GRAPH_PROFILED
            dl = counts() - c0
            launches += dl
            if not np.array_equal(dl, n * per[side]):
                raise AssertionError(f"phase 15 {what} {side}: launches "
                                     f"{dl.tolist()} over {n} calls of "
                                     f"{per[side].tolist()}")
            row[side] = {"wall_ms": ts, "wall_ms_median":
                         statistics.median(ts), **prof}
            log(f"phase 15 {what}, {side}: wall {statistics.median(ts):.2f}"
                f" ms (median of {GRAPH_ITERS}: "
                f"{', '.join(f'{t:.2f}' for t in ts)}); profiled wall "
                f"{prof['wall_ms_profiled']:.2f} ms, device "
                f"{prof['device_ms_per_dispatch']:.2f} ms (busy share "
                f"{prof['device_busy_share']:.3f}) in "
                f"{prof['device_kernels_per_dispatch']:.0f} kernels; "
                f"{kernel} {prof['kernel_ms_per_dispatch']:.3f} ms")
        rows.append(row)
    raise_failed("phase 15", pool_checks("phase 15 pool", cap.kv, ptrs))
    stats = graph_stats(cap, captures)
    res = {"dispatches": rows, "kernel_launches": int(launches[0]),
           "merge_launches": int(launches[1]),
           "bd_kernel_launches": int(launches[2]),
           "capture": stats, "wall_s": time.perf_counter() - t0}
    log(f"phase 15 (i): every dispatch bit-equal to its eager twin, pools "
        f"equal and in place; (ii) capture: {stats}; "
        f"{res['wall_s']:.3f} s wall")
    del sides, cap, eag
    gc.collect()
    torch.cuda.empty_cache()
    return res


def capture_totals(runs: list) -> dict:
    """Phase 15 (ii) over the serving runs: the captured backends' graphs,
    replays, graph-pool bytes and capture seconds, summed (a cluster run
    or drill keeps a list of its replicas' and its own seconds)."""
    stats, secs = [], 0.0
    for r in runs:
        many = isinstance(r["graphs"], list)
        stats += [g for g in (r["graphs"] if many else [r["graphs"]]) if g]
        secs += (r["capture_s"] if many else
                 (r["graphs"] or {}).get("capture_s")) or 0.0
    pools = [g["pool_bytes"] for g in stats]
    out = {"backends": len(stats), "graphs": sum(g["graphs"] for g in stats),
           "replays": sum(g["replays"] for g in stats), "capture_s": secs,
           "pool_bytes_max": None if None in pools else max(pools,
                                                            default=0),
           "pool_bytes_sum": None if None in pools else sum(pools)}
    log(f"phase 15 (ii), the captured serving runs: {out}")
    return out


# ---------------------------------------------------------------------------
# the recurrent families (ssm, hybrid) on the dense-slot path
# ---------------------------------------------------------------------------

SSM_ARCH = "rwkv6-1.6b"
HYBRID_ARCH = "jamba-1.5-large-398b"
# Jamba-1.5-Large does not fit one card even one 8-layer period deep at its
# 16 experts (90.48 GB of bf16 weights); with 10 experts (still more than 8,
# so the sorted path with grouped products, top-2) the period is 61.49 GB
HYBRID_CUTS = {"n_layers": 8, "n_experts": 10}
SLOT_LEN = 640            # the slot cache's max_len in phases 10 and 11
PROMPT_LEN = 417          # the padded [1, 640] prefill's prompt (shape (p))
SLOT_CTX_LEN = 512        # every slot's context in the hybrid window
SCANS = ("selective_scan", "wkv_scan")
# The hybrid phase holds each dispatch's attention layer at its call site in
# the model: ``attn_rel`` = max |out - out_plain| / max |out_plain| over the
# live rows, out the block-diffusion output (prefill) or the paged partial
# normalised as acc / l (chunk_forward), the MoE routing pinned to the plain
# path's experts.  A control run (the kernel's output or acc x (1 +
# CONTROL_SKEW)) moves it by 0.03; rounding a bf16 result moves it by at
# most 2^-8; the limit is half the skew.  The phase's first H100 run showed
# that downstream readings cannot tell the control from the kernel: the
# period's Mamba layers after the attention layer amplify bf16 rounding as
# far as a 3% error (prefill logits 0.062 vs 0.074 of their std,
# chunk_forward 0.094 vs 0.133), so logits, conf, tokens and states are
# readings, beside the gap check on tokens.  The prefill's K/V come from the
# attention layer's input, so they can differ only by the MoE's atomic
# scatter-add order (a reading, ``kv_max_abs_diff``).
HYBRID_LIMITS = {"attn_rel": 0.015}
HYBRID_BREAKS = ("attn_rel",)


def annotate_scans():
    """Wrap the two recurrences of ``models/ssm.py`` in
    ``torch.profiler.record_function`` ranges named as the functions, so a
    profile can give their device time; undo with the returned function."""
    import torch

    from repro_torch.models import ssm

    saved = {name: getattr(ssm, name) for name in SCANS}
    for name, fn in saved.items():
        def wrapped(*a, _fn=fn, _name=name):
            with torch.profiler.record_function(_name):
                return _fn(*a)
        setattr(ssm, name, wrapped)

    def undo():
        for name, fn in saved.items():
            setattr(ssm, name, fn)
    return undo


def padded_prompts(cfg, lengths, seed: int):
    """Prompts of ``lengths`` tokens padded with zeros to SLOT_LEN (the
    recurrent-slot admission's padding), on the card."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    toks = np.zeros((len(lengths), SLOT_LEN), np.int64)
    for i, n in enumerate(lengths):
        toks[i, :n] = rng.integers(4, cfg.vocab_size - 8, n)
    return (torch.as_tensor(toks, device=DEVICE),
            torch.as_tensor(lengths, dtype=torch.int32, device=DEVICE))


def ssm_phase(model, params, seed: int) -> dict:
    """Phase 10's dispatches: one ``prefill`` of a [1, 640] padded prompt and
    one AR ``advance_states`` at B 8, T 1 (from states a batched prefill
    left), each in bf16 and again with the same weights in fp32 (readings:
    the largest logit difference and top-1 agreement).  Phase 16 (i) times
    and profiles both through the backend, eager and captured."""
    import torch

    cfg = model.cfg
    m32 = type(model)(cfg.replace(param_dtype="float32",
                                  compute_dtype="float32"))
    p32 = {k: v.float() for k, v in params.items()}
    toks1, len1 = padded_prompts(cfg, [PROMPT_LEN], seed + 10)
    lens8 = [SLOT_LEN * (2 + i) // 10 for i in range(MODEL_B)]  # 128-576
    toks8, len8 = padded_prompts(cfg, lens8, seed + 11)
    step = torch.as_tensor(
        [[t] for t in range(5, 5 + MODEL_B)], device=DEVICE)
    ones = torch.ones(MODEL_B, dtype=torch.int32, device=DEVICE)

    def prefill(m, p, dtype):
        cache = m.init_cache(1, SLOT_LEN, dtype=dtype, device=DEVICE)
        logits, _ = m.prefill(p, toks1, len1, cache, head_mode="last")
        return logits[:, 0]

    def ar_cache(m, p, dtype):
        cache = m.init_cache(MODEL_B, SLOT_LEN, dtype=dtype, device=DEVICE)
        m.prefill(p, toks8, len8, cache, head_mode="none")
        return cache

    caches = {torch.bfloat16: ar_cache(model, params, torch.bfloat16),
              torch.float32: ar_cache(m32, p32, torch.float32)}

    def advance(m, p, dtype):
        cache = caches[dtype]
        logits, _ = m.advance_states(p, dict(cache, len=cache["len"].clone()),
                                     step, ones)
        return logits[:, 0]

    res = {"arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
           "prompt_len": PROMPT_LEN, "slot_len": SLOT_LEN, "ar_batch": MODEL_B,
           "ar_prompt_lens": lens8}
    for what, fn in (("prefill", prefill), ("advance_states", advance)):
        lb = fn(model, params, torch.bfloat16).float()
        lf = fn(m32, p32, torch.float32)
        torch.cuda.synchronize()
        for name, t in (("bf16", lb), ("fp32", lf)):
            if not torch.isfinite(t).all():
                raise AssertionError(f"ssm {what}: non-finite logits "
                                     f"({name})")
        res[what] = {"logits_max_abs_diff": float((lb - lf).abs().max()),
                     "logits_std_fp32": float(lf.std()),
                     "top1_agree": float((lb.argmax(-1) == lf.argmax(-1))
                                         .float().mean()),
                     "rows": lb.shape[0]}
        log(f"ssm {what} ({cfg.name}, {cfg.n_layers} layers, d_model "
            f"{cfg.d_model}): bf16 vs fp32 weights, logits max abs diff "
            f"{res[what]['logits_max_abs_diff']:.4f} (fp32 logits std "
            f"{res[what]['logits_std_fp32']:.4f}), top-1 agrees in "
            f"{res[what]['top1_agree']:.3f} of {lb.shape[0]} rows")
    del m32, p32, caches
    torch.cuda.empty_cache()
    return res


def attention_outputs(run, module=None, names=None):
    """``run()`` with the output of every attention call of the model
    recorded (the block-diffusion output, or the paged partial normalised as
    acc / l), whichever route, kernel or plain, the call takes: the calls of
    ``names`` (by default the kernels' and their plain versions') as
    ``module`` (by default ``models/transformer.py``) calls them.  Returns
    (run's result, outputs in call order)."""
    import torch

    import repro_torch.models.transformer as tfm

    module = module or tfm
    names = names or ("block_diffusion_attention", "block_diffusion_ref",
                      "paged_chunk_attention", "paged_chunk_ref")
    saved = {name: getattr(module, name) for name in names}
    outs = []

    def recorder(fn):
        def rec(*a, **k):
            out = fn(*a, **k)
            if isinstance(out, tuple):                    # (acc, m, l)
                acc, _, l = out
                outs.append(acc / torch.clamp(l, min=1e-30)[..., None])
            else:
                outs.append(out.float())
            return out
        return rec

    for name, fn in saved.items():
        setattr(module, name, recorder(fn))
    try:
        result = run()
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)
    return result, outs


def hybrid_phase(model, params, seed: int) -> dict:
    """Phase 11's dispatches, kernel path against plain path on the same
    weights: one ``prefill`` of a [1, 640] padded prompt (the
    block-diffusion kernel, shape (p)) and one ``chunk_forward`` at B 8,
    c 32 with every slot at ctx 512 (the paged kernel on the slot view,
    shape (o)), MoE routing pinned to the plain path's experts.  Each is
    held at HYBRID_LIMITS with its control; the downstream readings (logits,
    conf, tokens, states), free-running expert flips and the plain split
    version's are printed; then the ``chunk_forward`` is profiled."""
    import torch

    import repro_torch.models.transformer as tfm
    from repro_torch.kernels import chunked_paged_attn as cpa
    from repro_torch.kernels.ops import softmax_confidence_device

    cfg = model.cfg
    toks, ln = padded_prompts(cfg, [PROMPT_LEN], seed + 20)

    def attn_rel(outs, ref_outs, rows=None):
        a, b = outs[0], ref_outs[0]
        if rows is not None:
            a, b = a[:, :rows], b[:, :rows]
        return float((a - b).abs().max()) / float(b.abs().max())

    def pre(impl, pin=None):
        cache = model.init_cache(1, SLOT_LEN, dtype=torch.bfloat16,
                                 device=DEVICE)

        def run():
            logits, _ = model.prefill(params, toks, ln, cache,
                                      head_mode="last", impl=impl)
            return logits[:, 0]

        (logits, probs, ids), outs = attention_outputs(
            lambda: routed(run, pin))
        if len(outs) != model.paged_kv_dims()[0]:
            raise AssertionError(f"hybrid prefill: {len(outs)} attention "
                                 f"calls")
        conf, tok = softmax_confidence_device(logits)
        kv = torch.cat([cache[n][:, :, :PROMPT_LEN] for n in ("k", "v")])
        states = torch.cat([t.float().flatten() for st in
                            cache["states"].values() for t in st.values()])
        for t in (logits, kv, states, outs[0]):
            if not torch.isfinite(t).all():
                raise AssertionError(f"hybrid prefill: non-finite output "
                                     f"({impl})")
        return conf, tok, logits, kv, torch.stack(ids), states, outs

    p_plain = pre("ref")
    p_kernel = pre("kernel", pin=p_plain[4])
    p_free = pre("kernel")
    exact_bd = tfm.block_diffusion_attention
    tfm.block_diffusion_attention = \
        lambda *a, **k: exact_bd(*a, **k) * (1 + CONTROL_SKEW)
    try:
        p_control = pre("kernel", pin=p_plain[4])
    finally:
        tfm.block_diffusion_attention = exact_bd
    lr, sr = p_plain[2], p_plain[5]
    lr_std, s_std = float(lr.std()), float(sr.std())
    kv_diff = float((p_kernel[3].float() - p_plain[3].float()).abs().max())

    def pre_readings(run):
        return {"attn_rel": attn_rel(run[6], p_plain[6], PROMPT_LEN),
                "logits_rel": float((run[2] - lr).abs().max()) / lr_std,
                "states_rel": float((run[5] - sr).abs().max()) / s_std,
                "tokens_differ": int((run[1] != p_plain[1]).sum())}

    pre_sound, pre_ctl = pre_readings(p_kernel), pre_readings(p_control)
    free_flips = int((p_free[4][..., 0] != p_plain[4][..., 0]).sum())
    res = {"arch": cfg.name, "cuts": HYBRID_CUTS, "layers": cfg.n_layers,
           "d_model": cfg.d_model, "n_experts": cfg.n_experts,
           "limits": HYBRID_LIMITS, "control_breaks": HYBRID_BREAKS,
           "prefill": {"T": SLOT_LEN, "length": PROMPT_LEN,
                       "logits_std_plain": lr_std, "states_std_plain": s_std,
                       "kv_max_abs_diff": kv_diff,
                       "kernel_vs_plain": pre_sound,
                       "control_vs_plain": pre_ctl,
                       "own_routing_vs_plain": pre_readings(p_free),
                       "own_routing_expert_flips": free_flips,
                       "routed_pairs": p_plain[4][..., 0].numel()}}
    log(f"hybrid prefill ({cfg.name}: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_experts} experts; [1, {SLOT_LEN}], length "
        f"{PROMPT_LEN}; routing pinned to the plain path's): logits std "
        f"{lr_std:.4f}, states std {s_std:.4f}, K/V max abs diff {kv_diff};"
        f" own routing: top-1 expert differs in {free_flips} of "
        f"{res['prefill']['routed_pairs']} (token, MoE layer) pairs")
    for key in pre_sound:
        log(f"  {key}: kernel {pre_sound[key]}  control (out x "
            f"{1 + CONTROL_SKEW}) {pre_ctl[key]}  limit "
            f"{HYBRID_LIMITS.get(key, 'none (a reading)')}")
    del p_plain, p_kernel, p_free, p_control

    # every slot at ctx 512: KV and states from a plain prefill of 8 prompts
    cache = model.init_cache(MODEL_B, SLOT_LEN, dtype=torch.bfloat16,
                             device=DEVICE)
    toks8, len8 = padded_prompts(cfg, [SLOT_CTX_LEN] * MODEL_B, seed + 21)
    model.prefill(params, toks8, len8, cache, head_mode="none", impl="ref")
    win, start, valid, _ = decode_inputs(model, [SLOT_CTX_LEN] * MODEL_B,
                                         seed)
    ptr = cache["k"].data_ptr()

    def dispatch(impl, pin=None):
        def run():
            logits, _ = model.chunk_forward(params, cache, win, start, valid,
                                            impl=impl)
            return logits

        (logits, probs, ids), outs = attention_outputs(
            lambda: routed(run, pin))
        conf, tok = softmax_confidence_device(logits)
        for t in (conf, logits, outs[0]):
            if not torch.isfinite(t).all():
                raise AssertionError(f"hybrid chunk_forward: non-finite "
                                     f"output ({impl})")
        return (conf, tok, logits, torch.stack(probs), torch.stack(ids),
                outs)

    plain = dispatch("ref")
    free = dispatch("kernel")
    kernel = dispatch("kernel", pin=plain[4])
    plain_attn = tfm.paged_chunk_ref
    splits = cpa.pick_splits(MODEL_B, MODEL_C, cfg.n_heads, cfg.n_kv_heads,
                             SLOT_LEN, 1)
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
    base, margin_of, gap, lr_std = decode_readings(*plain[:3])

    def readings(run):
        return {"attn_rel": attn_rel(run[5], plain[5]), **base(*run[:3])}

    sound, ctl = readings(kernel), readings(control)
    pinned_margin = margin_of(kernel[1])
    p_plain, top_plain = plain[3], plain[4][..., 0]

    def own(run):
        """A run with its own routing against the plain path: readings,
        tokens that differ, and the (token, MoE layer) pairs whose top-1
        expert differs, with the largest plain router margin among them."""
        top = run[4][..., 0]
        flips = top != top_plain
        margin = (p_plain.gather(-1, top_plain[..., None].long())
                  - p_plain.gather(-1, top[..., None].long()))[..., 0]
        return {"vs_plain": readings(run),
                "tokens_differ": margin_of(run[1])[0],
                "expert_flips": int(flips.sum()),
                "routed_pairs": flips.numel(),
                "largest_router_margin_where_flipped":
                    float(margin[flips].max()) if flips.any() else None}

    res["chunk_forward"] = {
        "B": MODEL_B, "c": MODEL_C, "ctx": SLOT_CTX_LEN,
        "logits_std_plain": lr_std, "kernel_vs_plain": sound,
        "control_vs_plain": ctl,
        "routing": "pinned to the plain path's experts",
        "pinned_tokens_differ": pinned_margin[0],
        "pinned_gap_margin": pinned_margin[2],
        "own_routing": own(free),
        "plain_split_own_routing": {**own(reorder), "splits": splits}}
    cf = res["chunk_forward"]
    log(f"hybrid chunk_forward ({cfg.name}, B {MODEL_B}, c {MODEL_C}, every "
        f"slot at ctx {SLOT_CTX_LEN}, the paged kernel on the slot view): "
        f"logits std {lr_std:.4f}; pinned routing: tokens differ "
        f"{pinned_margin[0]} (gap check margin {pinned_margin[2]})")
    for what, o in (("kernel path", cf["own_routing"]),
                    (f"noise floor, the plain split version ({splits} "
                     f"splits)", cf["plain_split_own_routing"])):
        log(f"  {what}, own routing: tokens differ {o['tokens_differ']}, "
            f"top-1 expert differs in {o['expert_flips']} of "
            f"{o['routed_pairs']} pairs (largest plain router margin "
            f"{o['largest_router_margin_where_flipped']}), attn_rel "
            f"{o['vs_plain']['attn_rel']:.4f}, logits_rel "
            f"{o['vs_plain']['logits_rel']:.4f}")
    for key in sound:
        log(f"  {key} (pinned): kernel {sound[key]:.4f}  control (acc x "
            f"{1 + CONTROL_SKEW}) {ctl[key]:.4f}  limit "
            f"{HYBRID_LIMITS.get(key, 'none (a reading)')}")

    def head_only(impl):
        logits, _ = model.chunk_forward(params, cache, win, start, valid,
                                        impl=impl)
        return softmax_confidence_device(logits)[1].cpu()

    undo = annotate_scans()
    try:
        cf["profile"] = profile_dispatch(
            head_only, "paged_chunk_attn", 5, 3,
            ops=("aten::_grouped_mm", "selective_scan"))
    finally:
        undo()
    log_profile(f"hybrid chunk_forward ({cfg.name})", cf["profile"], "paged")
    if cache["k"].data_ptr() != ptr:
        raise AssertionError("hybrid: the slot cache moved")
    check_limits("hybrid prefill", pre_sound, pre_ctl, HYBRID_LIMITS,
                 HYBRID_BREAKS)
    if pinned_margin[0] and not pinned_margin[2] > 0:
        raise AssertionError("hybrid chunk_forward: with pinned routing a "
                             "token differs where its top-1/top-2 logit gap "
                             "exceeds the bf16 tolerance")
    check_limits("hybrid chunk_forward", sound, ctl, HYBRID_LIMITS,
                 HYBRID_BREAKS)
    return res


def slot_ptrs(cache) -> list[int]:
    from repro_torch.serving.backends import _slot_tensors
    return [t.data_ptr() for t in _slot_tensors(cache)]


# ---------------------------------------------------------------------------
# the reference's last jits captured (phase 17): the pool's page moves and
# the train step
# ---------------------------------------------------------------------------

POOL_PAGES, POOL_HOST = 128, 64    # (ii): pool and host-tier pages a side
POOL_N = (1, 3, 8, 33)             # pages a COW copy and a swap-in move
POOL_ITERS = 25


def pool_graphs_phase(model, params, seed: int) -> dict:
    """Phase 17 (ii): SDAR-8B's full-width pool (36 attention layers, KVH
    8, hd 128, page 16, bf16) in a captured ``ModelBackend`` and an eager
    twin, each of POOL_PAGES pages with a host tier of POOL_HOST, filled
    with the same seeded pages: a COW copy of n pages then a swap-in of n
    pages for each n of POOL_N, on both sides — the first captures, the
    second replays — the pools bit-equal after every operation and the
    captured pool in place; one graph a kind and pow-2 count used; each
    kind's wall a call (host clock to a synchronise, median of
    POOL_ITERS) on both sides."""
    import numpy as np
    import torch

    from repro_torch.analysis import rules
    from repro_torch.serving import ModelBackend

    t0 = time.perf_counter()
    captures = dict(CAPTURES)
    sides = {side: ModelBackend(model, params, n_slots=8, max_len=1024,
                                kv_pages=POOL_PAGES, host_kv_pages=POOL_HOST,
                                cache_dtype=torch.bfloat16, device=DEVICE,
                                graphs=side == "captured")
             for side in ("captured", "eager")}
    cap, eag = sides["captured"], sides["eager"]
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    for be in sides.values():
        be.kv._ensure_host_storage()
    pairs = list(zip(rules.pool_tensors(cap.kv)
                     + [cap.kv.host.k_host, cap.kv.host.v_host],
                     rules.pool_tensors(eag.kv)
                     + [eag.kv.host.k_host, eag.kv.host.v_host]))
    for a, b in pairs:
        x = torch.randn(a.shape, generator=g, device=DEVICE).to(a.dtype)
        a.copy_(x)
        b.copy_(x)
    del x
    ptrs = rules.pool_ptrs(cap.kv)
    page_bytes = cap.kv.page_bytes
    rng = np.random.default_rng(seed)

    def moves(n):
        pages = rng.permutation(POOL_PAGES)[:2 * n].tolist()
        slots = rng.permutation(POOL_HOST)[:n].tolist()
        return {"copy": lambda kv: kv._device_copy(pages[:n], pages[n:]),
                "swap_in": lambda kv: kv._swap_in_device(slots, pages[:n])}

    def equal():
        torch.cuda.synchronize()
        return all(torch.equal(a, b) for a, b in zip(
            rules.pool_tensors(cap.kv), rules.pool_tensors(eag.kv)))

    rows = []
    for n in POOL_N:
        for rep in range(2):                  # capture, then replay
            for kind, move in moves(n).items():
                for be in sides.values():
                    move(be.kv)
                raise_failed(f"phase 17 (ii) {kind} of {n} pages", [
                    (equal(), f"the pools differ after call {rep + 1}"),
                    *pool_checks("phase 17 (ii) pool", cap.kv, ptrs)])
        row = {"n": n, "bucket": len(cap.kv._pad_pow2(list(range(n)))),
               "bytes_moved": n * page_bytes}
        for kind, move in moves(n).items():
            for side, be in sides.items():
                ts = []
                for _ in range(POOL_ITERS):
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
                    move(be.kv)
                    torch.cuda.synchronize()
                    ts.append((time.perf_counter() - t1) * 1e3)
                row[f"{kind}_{side}_ms"] = statistics.median(ts)
        rows.append(row)
        log(f"phase 17 (ii) n {n} (bucket {row['bucket']}, "
            f"{row['bytes_moved'] / 1e6:.2f} MB of K+V): COW copy "
            f"{row['copy_captured_ms']:.4f} ms captured vs "
            f"{row['copy_eager_ms']:.4f} eager; swap-in "
            f"{row['swap_in_captured_ms']:.4f} ms captured vs "
            f"{row['swap_in_eager_ms']:.4f} eager (median of {POOL_ITERS})")
    kinds = {}
    for key in cap.graphs.entries:
        kinds.setdefault(key[0], []).append(key[2])
    buckets = sorted({r["bucket"] for r in rows})
    raise_failed("phase 17 (ii)", [
        (equal(), "the pools differ after the timed calls"),
        *pool_checks("phase 17 (ii) pool", cap.kv, ptrs),
        ({k: sorted(v) for k, v in kinds.items()}
         == {"copy": buckets, "swap_in": buckets},
         f"graphs {kinds}, want one a kind and bucket of {buckets}"),
        (not rules.check_pool_graph_churn(cap.graphs, cap.kv),
         "HLO005's pool bound")])
    res = {"rows": rows, "page_bytes": page_bytes,
           "capture": graph_stats(cap, captures),
           "wall_s": time.perf_counter() - t0}
    log(f"phase 17 (ii): pools bit-equal after every copy and swap-in and "
        f"in place; graphs {dict((k, sorted(v)) for k, v in kinds.items())}"
        f"; capture {res['capture']}; {res['wall_s']:.3f} s wall")
    del sides, cap, eag, pairs
    gc.collect()
    torch.cuda.empty_cache()
    return res


def train_leaves(state) -> dict:
    """A train state's params, moments and step counter by name."""
    out = dict(state["params"])
    for k, mu in state["opt"]["mu"].items():
        out.update({f"{k}@{n}": t for n, t in mu.items()})
    out["step"] = state["opt"]["step"]
    return out


TRAIN_HELD_AT = 3                  # (i): the state compared after 3 steps
TRAIN_SYNC_STEP = 4                # (i): the replay run under sync debug


def train_graphs_phase(seed: int, workdir: Path, phase12: dict) -> dict:
    """Phase 17 (i): SDAR-8B-4L (phase 12's ``TRAIN_*``) trained by an
    eager twin ``Trainer(graphs=False)`` and by a captured ``Trainer``
    from the same seed, step by step: per-step losses equal; the params,
    moments and step counter after TRAIN_HELD_AT steps (the capture's
    eager first step and two replays) bit-equal to the twin's (else a
    second eager run sets the floor the captured run is held to); the
    live tensors in place and ``memory_allocated`` flat over the replays;
    the replay of step TRAIN_SYNC_STEP under the sync debug mode (no host
    sync); step walls (median of steps 3-10, each to its loss on the
    host) on both sides; one more step of each profiled; the graph's node
    count, capture seconds and pool bytes; phase 12's restart drill, now
    captured, read back."""
    import torch

    from repro_torch.analysis import rules
    from repro_torch.configs import get_config
    from repro_torch.training import (AdamWConfig, DataConfig, Trainer,
                                      TrainerConfig)
    from repro_torch.training.train_loop import _state_ptrs

    t0 = time.perf_counter()
    cfg = get_config(TRAIN_ARCH).replace(**TRAIN_CUTS)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_T,
                    global_batch=TRAIN_B)
    opt_cfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=2,
                          total_steps=TRAIN_STEPS)

    def drive(graphs):
        """One run of TRAIN_STEPS steps: its readings and the state after
        TRAIN_HELD_AT steps, on the host; the trainer is freed."""
        captures = dict(CAPTURES)
        tr = Trainer(cfg, dc, opt_cfg, TrainerConfig(
            total_steps=TRAIN_STEPS, ckpt_every=0, ckpt_dir=str(workdir),
            log_every=TRAIN_STEPS + 1, seed=seed), device=DEVICE,
            graphs=graphs)
        state, _ = tr.start(resume=False)
        out = {"losses": [], "walls_s": [], "mem": [], "syncs": None}
        held, ptrs = {}, None
        for step in range(TRAIN_STEPS):
            if step == TRAIN_HELD_AT:
                held = {k: t.cpu() for k, t in train_leaves(state).items()}
            torch.cuda.synchronize()
            if step >= 1:                   # step 0 ran eagerly (captured)
                NODES["on"] = False
                ptrs = ptrs or _state_ptrs(state)
                if _state_ptrs(state) != ptrs:
                    raise AssertionError(f"phase 17 (i): the params or "
                                         f"moments moved before step {step}")
                out["mem"].append(torch.cuda.memory_allocated())
            t1 = time.perf_counter()
            if step == TRAIN_SYNC_STEP:
                out["syncs"], m = rules.count_syncs(
                    lambda: tr.train_step(state, step), DEVICE)
            else:
                m = tr.train_step(state, step)
            out["losses"].append(float(m["loss"]))
            out["walls_s"].append(time.perf_counter() - t1)
            # the eager step's metrics are its own tensors: let them go
            # before memory is read
            del m
        torch.cuda.synchronize()
        out["mem"].append(torch.cuda.memory_allocated())
        out["profile"] = device_profile(
            lambda: tr.train_step(state, TRAIN_STEPS), None, 1)
        out["median_step_s"] = statistics.median(out["walls_s"][2:])
        out["capture"] = graph_stats(tr, captures)
        del tr, state
        gc.collect()
        torch.cuda.empty_cache()
        return out, held

    def diff(a, b) -> tuple:
        """max |a - b| over the leaves of two host states (0.0: bit-equal)
        and the leaves that differ."""
        worst, bad = 0.0, []
        for k, t in a.items():
            if not torch.equal(t, b[k]):
                bad.append(k)
                worst = max(worst, float((t.float() - b[k].float()).abs()
                                         .max()))
        return worst, bad

    eager, e_held = drive(False)
    NODES["on"] = True
    n_nodes = len(NODES["counts"])
    try:
        run, c_held = drive(None)
    finally:
        NODES["on"] = False
    stats = run["capture"]
    stats["nodes"] = NODES["counts"][n_nodes:]
    worst, bad = diff(c_held, e_held)
    res = {"arch": cfg.name, "cuts": TRAIN_CUTS, "B": TRAIN_B, "T": TRAIN_T,
           "eager": eager, "captured": run, "capture": stats,
           "held_at_step": TRAIN_HELD_AT, "leaves": len(c_held),
           "captured_vs_eager_max_abs": worst,
           "captured_vs_eager_leaves_differ": bad[:8]}
    floor = 0.0
    if bad or run["losses"] != eager["losses"]:
        again, e2_held = drive(False)
        floor, bad2 = diff(e2_held, e_held)
        res.update({"eager_vs_eager_max_abs": floor,
                    "eager_vs_eager_leaves_differ": bad2[:8],
                    "eager2_losses": again["losses"]})
    del c_held, e_held
    drill = phase12["drill"]
    res["drill"] = drill
    log(f"phase 17 (i) {cfg.name} ({cfg.n_layers} layers, B {TRAIN_B} x "
        f"{TRAIN_T}): losses captured {run['losses']} vs eager "
        f"{eager['losses']}; after {TRAIN_HELD_AT} steps {len(bad)} of "
        f"{res['leaves']} leaves differ (max |diff| {worst!r}"
        + (f"; eager vs eager {res['eager_vs_eager_max_abs']!r}"
           if "eager_vs_eager_max_abs" in res else "") + ")")
    log(f"  step wall (median of steps 3-{TRAIN_STEPS}): captured "
        f"{run['median_step_s'] * 1e3:.2f} ms vs eager "
        f"{eager['median_step_s'] * 1e3:.2f} ms; first step captured "
        f"{run['walls_s'][0]:.3f} s, eager {eager['walls_s'][0]:.3f} s")
    for side, r in (("captured", run), ("eager", eager)):
        p = r["profile"]
        log(f"  profiled step, {side}: wall {p['wall_ms_profiled']:.2f} ms, "
            f"device {p['device_ms_per_dispatch']:.2f} ms (busy share "
            f"{p['device_busy_share']:.3f}) in "
            f"{p['device_kernels_per_dispatch']:.0f} kernels")
    log(f"  capture: {stats}; memory_allocated over the replays "
        f"{sorted(set(run['mem']))}; host syncs in the step-"
        f"{TRAIN_SYNC_STEP} replay {run['syncs']}")
    log(f"  phase 12's restart drill, captured: final loss "
        f"{drill['resumed_losses'][-1]!r} vs {phase12['losses'][-1]!r} "
        f"(|diff| {drill['final_loss_abs_diff']:.3e}, rtol {RESUME_RTOL}); "
        f"resumed trainer {drill['graphs']}")
    equal_losses = run["losses"] == eager["losses"]
    raise_failed("phase 17 (i)", [
        (worst <= floor, f"after {TRAIN_HELD_AT} steps the captured state "
         f"differs from the eager twin's by {worst} (leaves {bad[:8]}), "
         f"above the eager-vs-eager floor {floor}"),
        (equal_losses or floor > 0, f"losses {run['losses']} vs "
         f"{eager['losses']} with a bit-equal eager floor"),
        (len(set(run["mem"])) == 1,
         f"memory_allocated moved over the replays: {run['mem']}"),
        (run["syncs"] == 0, f"{run['syncs']} host syncs in a replay"),
        (stats["graphs"] == 1 and stats["replays"] == TRAIN_STEPS,
         f"graphs {stats}"),
        (drill["graphs"] is not None
         and drill["graphs"]["replays"] == len(drill["resumed_losses"]) - 1,
         f"the resumed drill was not captured: {drill['graphs']}")])
    res["wall_s"] = time.perf_counter() - t0
    log(f"phase 17 (i): {res['wall_s']:.3f} s wall")
    return res


# ---------------------------------------------------------------------------
# the slot path captured (phase 16): the recurrent-slot dispatches as graphs
# ---------------------------------------------------------------------------

SLOT_GRAPH_SLOTS = (0, 5)                 # (i): the two admissions' slots
SLOT_GRAPH_LENS = (PROMPT_LEN, 300)       # and their prompts
SLOT_COMMIT_T = 5                         # (i): the hybrid block commit's T
SLOT_PROFILED = {"slot_prefill": 1, "window": 3, "advance": 3}
# The eager slot prefill is timed, not profiled: on an H100 80GB HBM3 (700
# W) profiling one took 136.3 s (RWKV6-1.6B, 94,242 kernels) and 55.2 s
# (Jamba) of the script's time limit, and its kernels are the captured
# prefill's, which is profiled (PERF.md section 5 keeps the eager
# readings).
EAGER_UNPROFILED = ("slot_prefill",)
SLOT_KINDS = ("slot_prefill", "window", "advance")
# the nodes of the graphs captured while NODES["on"] (keep_graph and
# libcuda's cuGraphGetNodes: the graph's own count, kernels and copies)
NODES = {"on": False, "counts": []}


def count_nodes():
    """Make every ``torch.cuda.CUDAGraph`` keep its ``cudaGraph_t`` and,
    while ``NODES["on"]``, append its node count to ``NODES["counts"]`` at
    ``capture_end``, then instantiate it there (as a graph that does not
    keep it does), so capture seconds still include instantiation."""
    import ctypes

    import torch

    cuda = ctypes.CDLL("libcuda.so.1")
    get_nodes = cuda.cuGraphGetNodes
    get_nodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.POINTER(ctypes.c_size_t)]
    get_nodes.restype = ctypes.c_int
    base = torch.cuda.CUDAGraph

    class Counted(base):
        def __init__(self, keep_graph=False):
            super().__init__(NODES["on"] or keep_graph)

        def capture_end(self):
            super().capture_end()
            if NODES["on"]:
                n = ctypes.c_size_t()
                rc = get_nodes(ctypes.c_void_p(self.raw_cuda_graph()), None,
                               ctypes.byref(n))
                if rc != 0:
                    raise RuntimeError(f"cuGraphGetNodes returned {rc}")
                NODES["counts"].append(n.value)
                self.instantiate()

    torch.cuda.CUDAGraph = Counted


def slot_counts():
    """The counters a slot dispatch moves: paged launches, their merges,
    block-diffusion launches, grouped products."""
    import numpy as np

    from repro_torch.kernels import block_diffusion_attn as bda
    from repro_torch.kernels import chunked_paged_attn as cpa
    from repro_torch.models import moe
    return np.array([cpa.LAUNCHES, cpa.MERGE_LAUNCHES, bda.LAUNCHES,
                     moe.GROUPED_CALLS])


def slot_layers(model) -> tuple[int, int]:
    """(attention layers, MoE layers on the sorted path) of a slot model."""
    from repro_torch.models import moe
    n_attn = model.paged_kv_dims()[0] if model.has_kv else 0
    n_moe = sum(ffn == "moe" for _, ffn in model._positions()) \
        * model.n_periods if moe.takes_sorted_path(model.cfg) else 0
    return n_attn, n_moe


def slot_graphs_phase(model, params, seed: int) -> dict:
    """Phase 16 (i): a recurrent family's slot dispatches through a
    captured recurrent-slot ``ModelBackend`` and its eager twin
    (``graphs=False``), 8 slots of SLOT_LEN, bf16: a slot prefill of a
    padded [SLOT_LEN] prompt into slot 0 (the captured side captures) and
    into slot 5 (it replays the one graph), then the RWKV6 AR step (T 1),
    or the hybrid's window (c = block) and a block commit (T
    SLOT_COMMIT_T), each twice (capture, replay) on both live slots.
    After every call: logits bit-equal, every slot tensor (KV rows, len,
    states) bit-equal, the kernels' launches, merges and grouped products
    a call the same on both sides and as many as the model's layers ask.
    Then each kind's wall (host clock around the dispatch and its logits'
    fetch, median of GRAPH_ITERS) and ``torch.profiler`` over
    SLOT_PROFILED calls, on both sides but for EAGER_UNPROFILED (the eager
    side's with the scans' and grouped products' device time); the slot
    prefill's graph nodes and capture seconds."""
    import numpy as np
    import torch

    from repro_torch.serving import ModelBackend
    from repro_torch.serving.backends import _slot_tensors

    cfg = model.cfg
    ar = cfg.family == "ssm"
    t0 = time.perf_counter()
    captures = dict(CAPTURES)
    sides = {side: ModelBackend(model, params, n_slots=MODEL_B,
                                max_len=SLOT_LEN,
                                decode_mode="ar" if ar else "elastic",
                                cache_dtype=torch.bfloat16, device=DEVICE,
                                graphs=side == "captured")
             for side in ("captured", "eager")}
    cap = sides["captured"]
    ptrs = cap.graphs.pool_ptrs()
    rng = np.random.default_rng(seed)
    V, B, c = cfg.vocab_size, MODEL_B, cfg.block_size
    n_attn, n_moe = slot_layers(model)
    mask = np.zeros(B, bool)
    mask[list(SLOT_GRAPH_SLOTS)] = True

    def prefill(slot, n):
        toks = np.zeros(SLOT_LEN, np.int64)
        toks[:n] = rng.integers(4, V - 8, n)
        return dict(toks=toks, lens=np.array([n], np.int32),
                    slot=np.array([slot], np.int64))

    cases = [(f"slot prefill [{SLOT_LEN}], length {n}, slot {slot}",
              "slot_prefill", "_slot_prefill", prefill(slot, n), 1)
             for slot, n in zip(SLOT_GRAPH_SLOTS, SLOT_GRAPH_LENS)]
    if ar:
        cases.append((f"AR step, B {B}, T 1", "advance", "_advance",
                      dict(toks=rng.integers(4, V - 8, (B, 1)),
                           lens=mask.astype(np.int32), mask=mask), 2))
    else:
        start = np.zeros(B, np.int64)
        start[list(SLOT_GRAPH_SLOTS)] = SLOT_GRAPH_LENS
        cases.append((f"window, B {B}, c {c}", "window", "_window",
                      dict(toks=rng.integers(4, V - 8, (B, c)), start=start,
                           valid=np.where(mask, c, 0)), 2))
        cases.append((f"block commit, B {B}, T {SLOT_COMMIT_T}", "advance",
                      "_advance",
                      dict(toks=rng.integers(4, V - 8, (B, SLOT_COMMIT_T)),
                           lens=(mask * SLOT_COMMIT_T).astype(np.int32),
                           mask=mask), 2))

    def call(side, kind, fn, host):
        be = sides[side]
        (logits,) = be._dispatch(kind, getattr(be, fn), **host)
        return logits.cpu()

    def want(kind):
        """(paged, merges ≤ paged, block-diffusion, grouped) a call."""
        return (0 if kind == "slot_prefill" else n_attn,
                n_attn if kind == "slot_prefill" else 0, 3 * n_moe)

    rows, launches, prefill_capture = [], np.zeros(4, np.int64), None
    for what, kind, fn, host, n_calls in cases:
        for _ in range(n_calls):
            per, out = {}, {}
            for side in sides:
                c0, k0 = slot_counts(), dict(CAPTURES)
                first = side == "captured" and kind == "slot_prefill" \
                    and prefill_capture is None
                NODES["on"] = first
                try:
                    out[side] = call(side, kind, fn, host)
                finally:
                    NODES["on"] = False
                per[side] = slot_counts() - c0
                if first:
                    prefill_capture = {
                        "nodes": NODES["counts"][-1],
                        "capture_s": CAPTURES["s"] - k0["s"],
                        "captures": CAPTURES["n"] - k0["n"]}
            launches += per["captured"] + per["eager"]
            paged, merges, bd, grouped = per["captured"]
            raise_failed(f"phase 16 {cfg.name} {what}", [
                (torch.equal(out["captured"], out["eager"]),
                 "logits differ from the eager twin's"),
                (bool(torch.isfinite(out["captured"]).all()),
                 "non-finite logits"),
                (all(torch.equal(a, b) for a, b in zip(
                    _slot_tensors(cap.cache),
                    _slot_tensors(sides["eager"].cache))),
                 "the slot caches differ from the eager twin's"),
                (cap.graphs.pool_ptrs() == ptrs, "the slot cache moved"),
                ((paged, bd, grouped) == want(kind) and merges <= paged
                 and np.array_equal(per["captured"], per["eager"]),
                 f"launches a call {per['captured'].tolist()}, eager "
                 f"{per['eager'].tolist()}, want paged/bd/grouped "
                 f"{want(kind)}")])
        rows.append({"dispatch": what, "kind": kind, "bit_equal": True,
                     "calls": n_calls,
                     "launches_per_call": per["captured"].tolist()})
    graphs_by_kind = [k[0] for k in cap.graphs.entries]
    if graphs_by_kind.count("slot_prefill") != 1 \
            or cap.graphs.replays != sum(r["calls"] for r in rows) \
            - len(graphs_by_kind):
        raise AssertionError(f"phase 16 {cfg.name}: graphs "
                             f"{list(cap.graphs.entries)}, "
                             f"{cap.graphs.replays} replays")
    log(f"phase 16 (i) {cfg.name}: every slot dispatch bit-equal to its "
        f"eager twin (logits, KV rows, len, states); one slot_prefill graph "
        f"served slots {SLOT_GRAPH_SLOTS}: {prefill_capture['nodes']} nodes,"
        f" {prefill_capture['capture_s']:.3f} s capturing; "
        f"{time.perf_counter() - t0:.1f} s so far")

    # the eager side's profile reads the scans' (and grouped products')
    # device time through ``annotate_scans``; a replay runs no range
    ops = ("wkv_scan",) if ar else ("selective_scan",) + (
        ("aten::_grouped_mm",) if n_moe else ())
    first = {}                           # each kind's first case
    for case, row in zip(cases, rows):
        first.setdefault(case[1], (case, row))
    for (what, kind, fn, host, _), row in first.values():
        per = {}
        for side in sides:
            c0, t0s = slot_counts(), time.perf_counter()
            ts = []
            for _ in range(GRAPH_ITERS):  # warm: both sides ran it above
                t1 = time.perf_counter()
                call(side, kind, fn, host)
                ts.append((time.perf_counter() - t1) * 1e3)
            n, prof = 0, {}
            if side == "captured" or kind not in EAGER_UNPROFILED:
                n = SLOT_PROFILED[kind]
                undo = annotate_scans() if side == "eager" \
                    else (lambda: None)
                try:
                    prof = device_profile(
                        lambda: call(side, kind, fn, host), None, n,
                        ops=ops if side == "eager" else ())
                finally:
                    undo()
            dl = slot_counts() - c0
            launches += dl
            if not np.array_equal(dl, (GRAPH_ITERS + n)
                                  * np.array(row["launches_per_call"])):
                raise AssertionError(f"phase 16 {cfg.name} {what} {side}: "
                                     f"launches {dl.tolist()}")
            per[side] = {"wall_ms": ts, "wall_ms_median":
                         statistics.median(ts), **prof,
                         "timing_s": time.perf_counter() - t0s}
            log(f"phase 16 {cfg.name} {what}, {side}: wall "
                f"{statistics.median(ts):.2f} ms (median of {GRAPH_ITERS}: "
                f"{', '.join(f'{t:.2f}' for t in ts)})" + (
                    f"; profiled wall {prof['wall_ms_profiled']:.2f} ms, "
                    f"device {prof['device_ms_per_dispatch']:.2f} ms (busy "
                    f"share {prof['device_busy_share']:.3f}) in "
                    f"{prof['device_kernels_per_dispatch']:.0f} kernels"
                    + "".join(f"; {op} {r['ms_per_dispatch']:.3f} ms (share "
                              f"of device {r['share_of_device']:.3f})"
                              for op, r in prof["ops"].items())
                    if prof else "; not profiled")
                + f"; {per[side]['timing_s']:.1f} s timing and profiling")
        row.update(per)
    raise_failed(f"phase 16 {cfg.name}",
                 [(cap.graphs.pool_ptrs() == ptrs, "the slot cache moved")])
    stats = graph_stats(cap, captures)
    res = {"arch": cfg.name, "layers": cfg.n_layers, "dispatches": rows,
           "slot_prefill_graph": prefill_capture,
           "kernel_launches": int(launches[0]),
           "merge_launches": int(launches[1]),
           "bd_kernel_launches": int(launches[2]),
           "grouped_mm_calls": int(launches[3]), "capture": stats,
           "wall_s": time.perf_counter() - t0}
    log(f"phase 16 (i) {cfg.name}: capture {stats}; {res['wall_s']:.3f} s "
        f"wall")
    del sides, cap
    gc.collect()
    torch.cuda.empty_cache()
    return res


SLOT_TWIN_KEYS = ("tokens_sha1", "calls", "kernel_launches",
                  "merge_launches", "bd_kernel_launches", "grouped_mm_calls")


def serve_recurrent(model, params, reqs, graphs: bool = True) -> dict:
    """Phase 16 (ii): one serving run of a recurrent family through the
    recurrent-slot ``ModelBackend`` (8 slots, max_len SLOT_LEN, bf16): rwkv
    AR under ``FixedScheduler(1)``, the hybrid block-pinned under the
    elastic scheduler as ``launch/serve.py`` builds it, each serve on
    ``reqs()``.  ``graphs``: the slot dispatches replay captured graphs
    (the backend's default on the card), served twice on the one backend —
    cold (with its captures) and warm; or they run eagerly (the eager
    twin), served once: it captures nothing, so a second serve would repeat
    the first (26.851 and 26.623 s for RWKV6-1.6B on an H100 80GB HBM3 at
    700 W).  The
    backend counts no dispatches in this mode (the reference's
    ``telemetry_counters``), so the run counts each kind's calls, and
    checks its logits finite, at the backend's ``_dispatch``, which sees
    every call, replayed or not; the launch counters are read per serve."""
    import hashlib

    import torch

    from repro_torch.analysis import rules
    from repro_torch.core.latency_model import CPU_HOST, AnalyticDeviceModel
    from repro_torch.core.scheduler import ElasticScheduler, FixedScheduler
    from repro_torch.kernels import block_diffusion_attn as bda
    from repro_torch.kernels import chunked_paged_attn as cpa
    from repro_torch.models import moe
    from repro_torch.serving import DATASETS, ModelBackend, ServingEngine
    from repro_torch.serving import backends

    cfg = model.cfg
    ar = cfg.family == "ssm"
    be = ModelBackend(model, params, n_slots=MODEL_B, max_len=SLOT_LEN,
                      decode_mode="ar" if ar else "elastic",
                      cache_dtype=torch.bfloat16, device=DEVICE,
                      graphs=graphs)
    calls = dict.fromkeys(SLOT_KINDS, 0)
    advance_T, finite = set(), {}
    dispatch = be._dispatch

    def counted(kind, fn, **host):
        calls[kind] += 1
        if kind == "advance":
            advance_T.add(host["toks"].shape[1])
        out = dispatch(kind, fn, **host)
        ok = torch.isfinite(out[0]).all()      # on the device: no sync
        finite[kind] = ok if kind not in finite else finite[kind] & ok
        return out

    be._dispatch = counted
    # host seconds in the backend's sampler (softmax over each live row's
    # fetched [c, V] logits): a reading of the host work between dispatches
    sampler, sampled = backends.softmax_confidence, {"s": 0.0, "n": 0}

    def timed_sampler(logits):
        t1 = time.perf_counter()
        try:
            return sampler(logits)
        finally:
            sampled["s"] += time.perf_counter() - t1
            sampled["n"] += 1

    outs = {}
    release = be.release

    def spy(rid):
        outs[rid] = be.state(rid).output_tokens
        release(rid)

    be.release = spy
    ptrs = slot_ptrs(be.cache)
    leaves = [t for st in be.cache.get("states", {}).values()
              for t in st.values()]
    n_attn, n_moe = slot_layers(model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    serves = []
    for which in ("cold", "warm") if graphs else ("cold",):
        rs = reqs()
        sched = FixedScheduler(1) if ar else ElasticScheduler.from_analytic(
            AnalyticDeviceModel(cfg, CPU_HOST),
            prior_tokens_per_step=DATASETS["sharegpt"].tokens_per_step_bd32,
            batches=(1, 2, 4, 8), ctx=128.0)
        eng = ServingEngine(be, sched, max_batch=MODEL_B)
        outs.clear()
        c0, captures = dict(calls), dict(CAPTURES)
        cpa.LAUNCHES = cpa.MERGE_LAUNCHES = bda.LAUNCHES = 0
        moe.GROUPED_CALLS = 0
        sampled.update(s=0.0, n=0)
        backends.softmax_confidence = timed_sampler
        t0 = time.perf_counter()
        try:
            rep = eng.run(list(rs))
            torch.cuda.synchronize()
        finally:
            backends.softmax_confidence = sampler
        wall = time.perf_counter() - t0
        tokens = [list(map(int, outs[r.rid])) for r in rs]
        n = sum(map(len, tokens))
        sc = {k: calls[k] - c0[k] for k in SLOT_KINDS}
        n_dec = sc["window"] + sc["advance"]
        sv = {"serve": which, "requests": len(rep.metrics),
              "tokens_committed": n, "wall_s": wall, "tok_per_s": n / wall,
              "token_utilization": rep.token_utilization, "calls": sc,
              "kernel_launches": cpa.LAUNCHES,
              "merge_launches": cpa.MERGE_LAUNCHES,
              "bd_kernel_launches": bda.LAUNCHES,
              "grouped_mm_calls": moe.GROUPED_CALLS,
              "host_sampling_s": sampled["s"],
              "host_samplings": sampled["n"],
              "tokens_sha1": hashlib.sha1(json.dumps(tokens).encode())
              .hexdigest(), "graphs": graph_stats(be, captures)}
        serves.append(sv)
        log(f"serve {cfg.name} ({cfg.n_layers} layers) "
            f"{'ar' if ar else 'block_pinned'}, "
            f"{'captured' if graphs else 'eager'}, {which}: "
            f"{sv['requests']} requests finished, {n} tokens committed, "
            f"calls {sc}, {sv['kernel_launches']} paged ("
            f"{sv['merge_launches']} with a split merge) + "
            f"{sv['bd_kernel_launches']} block-diffusion kernel launches, "
            f"{sv['grouped_mm_calls']} grouped products, token utilization "
            f"{rep.token_utilization:.3f}, {wall:.3f} s wall, "
            f"{sv['tok_per_s']:.2f} committed tok/s, {sampled['s']:.3f} s "
            f"in {sampled['n']} host samplings; graphs {sv['graphs']}; "
            f"tokens sha1 {sv['tokens_sha1']}")
        raise_failed(f"serve {cfg.name} {which}", [
            (len(rep.metrics) == len(rs), "not every request finished"),
            (all(len(t) == r.max_new_tokens for t, r in zip(tokens, rs)),
             "a request committed the wrong number of tokens"),
            (all(0 <= t < cfg.vocab_size for v in tokens for t in v),
             "a committed token is outside the vocabulary"),
            (sc["slot_prefill"] == len(rs), "slot prefills != admissions"),
            (not ar or rep.token_utilization == 1.0,
             f"AR token utilization {rep.token_utilization} != 1.0"),
            (not ar or sc["window"] == 0, "an AR run ran a window"),
            (sv["bd_kernel_launches"] == n_attn * sc["slot_prefill"],
             f"{sv['bd_kernel_launches']} block-diffusion launches != "
             f"{n_attn} x {sc['slot_prefill']} slot prefills"),
            (sv["kernel_launches"] == n_attn * n_dec,
             f"{sv['kernel_launches']} paged launches != {n_attn} x {n_dec} "
             f"window + advance dispatches"),
            (sv["merge_launches"] <= sv["kernel_launches"],
             "more merge launches than paged launches"),
            (sv["grouped_mm_calls"] == 3 * n_moe * (sc["slot_prefill"]
                                                    + n_dec),
             f"{sv['grouped_mm_calls']} grouped products != 3 x {n_moe} MoE "
             f"layers x {sc['slot_prefill'] + n_dec} dispatches"),
            (not be.cache["len"].any() and not any(t.any() for t in leaves),
             "a released slot's len or states are not zero")])
    res = {"arch": cfg.name, "layers": cfg.n_layers,
           "mode": "ar" if ar else "block_pinned",
           "path": "captured" if graphs else "eager", "serves": serves,
           "advance_lengths": sorted(advance_T),
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "graphs": graph_stats(be)}
    for k in ("requests", "tokens_committed", "wall_s", "kernel_launches",
              "merge_launches", "bd_kernel_launches", "grouped_mm_calls"):
        res[k] = sum(sv[k] for sv in serves)
    res["tok_per_s"] = res["tokens_committed"] / res["wall_s"]
    bad = sorted(k for k, ok in finite.items() if not bool(ok))
    churn = rules.check_slot_graph_churn(be.graphs, advance_T,
                                         target=f"serve {cfg.name}") \
        if graphs else []
    log(f"serve {cfg.name} {res['path']}: {len(advance_T)} distinct advance "
        f"lengths {sorted(advance_T)}, max_memory_allocated "
        f"{res['max_memory_allocated']} B; graphs {res['graphs']}")
    raise_failed(f"serve {cfg.name}", [
        (not bad, f"non-finite logits from {bad}"),
        (slot_ptrs(be.cache) == ptrs, "the slot cache moved"),
        (not churn, "; ".join(f.message for f in churn)),
        (be.telemetry_counters() == {"decode_dispatches": 0,
                                     "prefill_dispatches": 0,
                                     "host_transfer_bytes": 0},
         f"slot-mode telemetry counters {be.telemetry_counters()} are not "
         f"the reference's zeros")])
    return res


def serve_recurrent_twins(model, params, reqs) -> dict:
    """Phase 16 (ii): :func:`serve_recurrent` eagerly (one serve), then
    captured (cold and warm), each serve on ``reqs()``: every captured
    serve must commit the eager serve's tokens (sha1) with its calls of
    each kind, launches, merges and grouped products.  Returns the
    captured run with the eager one under "eager"."""
    import torch

    eager = serve_recurrent(model, params, reqs, graphs=False)
    gc.collect()
    torch.cuda.empty_cache()
    run = serve_recurrent(model, params, reqs)
    gc.collect()
    torch.cuda.empty_cache()
    (base,) = eager["serves"]
    for sv in run["serves"]:
        differ = [k for k in SLOT_TWIN_KEYS if sv[k] != base[k]]
        log(f"serve {model.cfg.name} {run['mode']} {sv['serve']}: captured "
            f"{sv['wall_s']:.3f} s against eager {base['wall_s']:.3f} s "
            f"wall; the same {list(SLOT_TWIN_KEYS)}: {not differ}")
        if differ:
            raise AssertionError(f"serve {model.cfg.name} {sv['serve']}: "
                                 f"the captured serve differs from its "
                                 f"eager twin in {differ}")
    run["eager"] = eager
    return run


# ---------------------------------------------------------------------------
# training on the card (phase 12)
# ---------------------------------------------------------------------------

TRAIN_ARCH = "sdar-8b"
TRAIN_CUTS = {"n_layers": 4}     # full width, 4 of 36 layers: 2.016B params
TRAIN_B, TRAIN_T, TRAIN_STEPS, TRAIN_LR = 4, 1024, 10, 1e-3
DRILL_CKPT, DRILL_FAIL = 5, 7    # checkpoint at step 5, failure at step 7
# The training phase holds: 1 and 2 microbatches' gradients of one step
# within the bf16 tolerance of one another (max |g2 - g1| / max |g1| a leaf;
# the one-microbatch gradients are bf16, the accumulated ones fp32); the
# resumed run's final loss within RESUME_RTOL of the uninterrupted run's
# (not under deterministic algorithms: the exact difference is printed);
# the training route's forward against the block-diffusion kernel's under
# no_grad at TRAIN_LIMITS, which the control (the kernel's output x (1 +
# CONTROL_SKEW) in every layer) must break.  ``attn_rel`` is the first
# layer's attention output at its call site, as in phase 11; ``logits_rel``
# is max |logits - logits_train| / std(logits_train).  The first H100 run
# read attn_rel 0.0045 and logits_rel 0.047 for the kernel, 0.0315 and
# 0.153 for the control: the logits limit sits between the two.
MB_TOL = BF16_TOL
RESUME_RTOL = 2e-3
TRAIN_LIMITS = {"attn_rel": 0.015, "logits_rel": 0.1}
TRAIN_BREAKS = ("attn_rel", "logits_rel")
GEMM_KERNELS = ("gemm", "nvjet", "xmma", "cutlass", "sm90_")
ENC_TRAIN_B, ENC_TRAIN_S, ENC_TRAIN_T = 4, 512, 256
ENC_TRAIN_LENS = [512, 400, 130, 17]
# the launcher's flags; --lr 1e-3 because at the default 3e-4, 20 steps
# move the block-diffusion loss less than its batch-to-batch noise (its
# final loss came out above its first in an fp32 run of these 20 steps)
LAUNCHER_ARGS = ["--arch", "smollm-135m", "--steps", "20", "--seq", "256",
                 "--batch", "8", "--lr", "1e-3"]


class GradsOut:
    """An optimizer that leaves the params alone and returns the step's
    gradients as its metrics."""

    def update(self, grads, state, params):
        return params, state, {"grads": grads}


class NormsThenAdamW:
    """AdamW that first records every leaf's gradient norm."""

    def __init__(self, opt):
        self.opt, self.norms = opt, []

    def update(self, grads, state, params):
        self.norms.append({k: float(g.float().norm())
                           for k, g in grads.items()})
        return self.opt.update(grads, state, params)


def profile_train_step(step, n: int = 1) -> dict:
    """Where one train step's time goes: wall (host clock around
    ``torch.cuda.synchronize``), device time and busy share from
    ``torch.profiler``, and the share of the product kernels (cuBLAS and
    CUTLASS GEMMs by name, the attention's products among them)."""
    import torch

    step()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = torch.autograd.DeviceType.CUDA
    kern = sorted(((e.key, e.self_device_time_total, e.count)
                   for e in prof.key_averages() if e.device_type == dev
                   and not getattr(e, "is_user_annotation", False)),
                  key=lambda r: -r[1])
    busy = sum(t for _, t, _ in kern)
    gemm = sum(t for k, t, _ in kern
               if any(s in k.lower() for s in GEMM_KERNELS))
    return {"wall_ms_profiled": wall_us / n / 1e3,
            "device_ms_per_step": busy / n / 1e3,
            "device_busy_share": busy / wall_us,
            "gemm_ms_per_step": gemm / n / 1e3,
            "gemm_share_of_device": gemm / max(busy, 1e-9),
            "device_kernels_per_step": sum(c for *_, c in kern) / n,
            "top": [{"name": k[:90], "ms_per_step": t / n / 1e3,
                     "calls_per_step": c / n} for k, t, c in kern[:8]]}


def train_phase(seed: int, workdir: Path) -> dict:
    """Phase 12 (a): SDAR-8B at full width, 4 layers, trained by
    ``Trainer`` (B 4 x 1024 tokens, block-diffusion loss, remat, fp32 AdamW
    moments) on the card: one step's gradients (every leaf's norm above 0;
    2 microbatches against 1), the training forward against the kernel's,
    the 10-step run, the restart drill, and one step profiled."""
    import numpy as np
    import torch

    import repro_torch.models.transformer as tfm
    from repro_torch.configs import get_config
    from repro_torch.kernels import block_diffusion_attn as bda
    from repro_torch.kernels import chunked_paged_attn as cpa
    from repro_torch.models import layers
    from repro_torch.training import (AdamWConfig, DataConfig,
                                      FailureInjector, SimulatedFailure,
                                      Trainer, TrainerConfig)
    from repro_torch.training.objectives import diffusion_masks
    from repro_torch.training.train_loop import (make_train_step,
                                                 step_generator)

    cfg = get_config(TRAIN_ARCH).replace(**TRAIN_CUTS)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_T,
                    global_batch=TRAIN_B)
    opt_cfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=2,
                          total_steps=TRAIN_STEPS)

    def trainer(ckpt_every, sub, inj=None):
        return Trainer(cfg, dc, opt_cfg, TrainerConfig(
            total_steps=TRAIN_STEPS, ckpt_every=ckpt_every,
            ckpt_dir=str(workdir / sub), log_every=5, seed=seed),
            failure_injector=inj, device=DEVICE)

    # one step's gradients from the trainer's first state, batch and masks
    tr = trainer(0, "a")
    state = tr.init_state()
    params = state.pop("params")
    del state
    n_params = sum(t.numel() for t in params.values())
    batch = {"tokens": torch.as_tensor(tr.data.batch(0), device=DEVICE)}
    masks = diffusion_masks(step_generator(seed, 0, DEVICE), TRAIN_B,
                            TRAIN_T, cfg.block_size)
    grads, losses1 = {}, {}
    for mb in (1, 2):
        _, _, out = make_train_step(tr.model, GradsOut(), microbatches=mb)(
            params, None, batch, masks=masks)
        grads[mb], losses1[mb] = out["grads"], float(out["loss"])
    norms = {k: float(g.float().norm()) for k, g in grads[1].items()}
    mb_rel = {k: float((grads[2][k].float() - g.float()).abs().max())
              / max(float(g.float().abs().max()), 1e-30)
              for k, g in grads[1].items()}
    del grads
    worst = sorted(mb_rel, key=mb_rel.get)[-3:]
    res = {"arch": cfg.name, "cuts": TRAIN_CUTS, "params": n_params,
           "B": TRAIN_B, "T": TRAIN_T, "lr": TRAIN_LR,
           "step1_loss_mb1": losses1[1], "step1_loss_mb2": losses1[2],
           "grad_norm_min": min(norms.values()),
           "grad_norm_min_leaf": min(norms, key=norms.get),
           "zero_grad_leaves": [k for k, n in norms.items() if not n > 0],
           "mb2_vs_mb1_rel_max": max(mb_rel.values()),
           "mb2_vs_mb1_worst_leaves": {k: mb_rel[k] for k in worst},
           "mb_tol": MB_TOL}
    log(f"train {cfg.name} ({cfg.n_layers} layers, full width, {n_params} "
        f"params, B {TRAIN_B} x T {TRAIN_T}): step-1 loss {losses1[1]:.5f} "
        f"(2 microbatches {losses1[2]:.5f}); least leaf gradient norm "
        f"{res['grad_norm_min']:.3e} ({res['grad_norm_min_leaf']}); 2 "
        f"microbatches vs 1, max rel diff by leaf (largest three) "
        f"{res['mb2_vs_mb1_worst_leaves']}, limit {MB_TOL}")

    # the training route's forward against the kernel's, under no_grad
    inputs = torch.where(masks["masked"], cfg.mask_token_id, batch["tokens"])

    def forward(impl, names):
        with torch.no_grad():
            return attention_outputs(lambda: tr.model.apply(
                params, inputs, mask_mode="block_causal", impl=impl),
                names=names)

    lt, at = forward("train", ("combine_partials",))
    lk, ak = forward("kernel", ("block_diffusion_attention",))
    exact = tfm.block_diffusion_attention
    tfm.block_diffusion_attention = \
        lambda *a, **k: exact(*a, **k) * (1 + CONTROL_SKEW)
    try:
        lc, ac = forward("kernel", ("block_diffusion_attention",))
    finally:
        tfm.block_diffusion_attention = exact
    torch.cuda.synchronize()
    lt_std = float(lt.std())

    def fwd_readings(logits, outs):
        return {"attn_rel": float((outs[0] - at[0]).abs().max())
                / float(at[0].abs().max()),
                "logits_rel": float((logits - lt).abs().max()) / lt_std,
                "tokens_differ_share": float(
                    (logits.argmax(-1) != lt.argmax(-1)).float().mean())}

    fwd_sound, fwd_ctl = fwd_readings(lk, ak), fwd_readings(lc, ac)
    finite = all(bool(torch.isfinite(t).all()) for t in (lt, lk))
    res["forward"] = {"kernel_vs_train": fwd_sound,
                      "control_vs_train": fwd_ctl, "limits": TRAIN_LIMITS,
                      "logits_std_train": lt_std, "finite": finite,
                      "attention_calls": [len(at), len(ak)]}
    log(f"  forward, training route vs apply(impl='kernel'): logits std "
        f"{lt_std:.4f}")
    for key in fwd_sound:
        log(f"    {key}: kernel {fwd_sound[key]:.5f}  control (out x "
            f"{1 + CONTROL_SKEW}) {fwd_ctl[key]:.5f}  limit "
            f"{TRAIN_LIMITS.get(key, 'none (a reading)')}")
    del lt, lk, lc, at, ak, ac, params
    torch.cuda.empty_cache()

    # the 10-step run; the training route launches no hand kernel
    torch.cuda.reset_peak_memory_stats()
    cpa.LAUNCHES = cpa.MERGE_LAUNCHES = bda.LAUNCHES = 0
    t0 = time.perf_counter()
    losses = tr.run(resume=False)
    wall = time.perf_counter() - t0
    # the run's graph cache holds its state (the replays write it in
    # place): read it, then let both go
    res["graphs"] = graph_stats(tr)
    tr.graphs = None
    gc.collect()
    torch.cuda.empty_cache()
    kernel_launches = cpa.LAUNCHES + bda.LAUNCHES
    times = list(tr.monitor._times[0])
    med = statistics.median(times)
    res.update({"losses": losses, "step_s": times, "median_step_s": med,
                "tokens_per_s": TRAIN_B * TRAIN_T / med, "run_wall_s": wall,
                "max_memory_allocated": torch.cuda.max_memory_allocated(),
                "hand_kernel_launches_while_training": kernel_launches})
    log(f"  {TRAIN_STEPS} steps: losses {[round(x, 4) for x in losses]}; "
        f"median step {med:.4f} s ({res['tokens_per_s']:.0f} tokens/s), "
        f"first step {times[0]:.3f} s; max_memory_allocated "
        f"{res['max_memory_allocated']} B; hand kernel launches "
        f"{kernel_launches}")

    # the restart drill: checkpoint at 5, failure at 7, resume
    drill = trainer(DRILL_CKPT, "drill",
                    FailureInjector(fail_at_steps=(DRILL_FAIL,)))
    failed = False
    try:
        drill.run(resume=False)
    except SimulatedFailure:
        failed = True
    del drill
    gc.collect()
    torch.cuda.empty_cache()
    resumer = trainer(0, "drill")
    resumed = resumer.run(resume=True)
    diff = abs(resumed[-1] - losses[-1])
    res["drill"] = {"failed_at": DRILL_FAIL, "checkpoint_at": DRILL_CKPT,
                    "injected_failure_raised": failed,
                    "resumed_losses": resumed,
                    "final_loss_abs_diff": diff,
                    "bit_exact": resumed[-1] == losses[-1],
                    "resumed_matches_steps": resumed == losses[DRILL_CKPT:],
                    "rtol": RESUME_RTOL, "graphs": graph_stats(resumer)}
    del resumer
    log(f"  restart drill: failure at step {DRILL_FAIL} raised {failed}; "
        f"resumed from the step-{DRILL_CKPT} checkpoint, losses "
        f"{[round(x, 4) for x in resumed]}; final loss {resumed[-1]!r} vs "
        f"uninterrupted {losses[-1]!r} (|diff| {diff:.3e}, bit-exact "
        f"{res['drill']['bit_exact']})")

    # one step profiled; the plain attention and the LM head with its cross
    # entropy timed alone (forward and backward; CUDA events, median of 5),
    # and the AdamW update (median of 3)
    state = tr.init_state()
    gen = step_generator(seed, 0, DEVICE)

    def one_step():
        tr._step_fn(state["params"], state["opt"], batch, gen=gen)

    prof = profile_train_step(one_step)
    H, KVH, D = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    q = torch.randn((TRAIN_B, TRAIN_T, H, D), generator=g,
                    device=DEVICE).to(cfg.cdt).requires_grad_()
    k, v = (torch.randn((TRAIN_B, TRAIN_T, KVH, D), generator=g,
                        device=DEVICE).to(cfg.cdt).requires_grad_()
            for _ in range(2))
    lens = torch.full((TRAIN_B,), TRAIN_T, dtype=torch.int32, device=DEVICE)

    def attn(backward):
        with torch.enable_grad():
            part = layers.flash_partial_aligned(
                q, k, v, lengths=lens, kind="block_causal",
                block_size=cfg.block_size)
            out = layers.combine_partials([part], cfg.cdt)
            if backward:
                torch.autograd.grad(out.float().sum(), (q, k, v))

    x = torch.randn((TRAIN_B, TRAIN_T, cfg.d_model), generator=g,
                    device=DEVICE).to(cfg.cdt).requires_grad_()

    def head_ce():
        with torch.enable_grad():
            logits = tr.model.head(state["params"], x)
            nll = torch.nn.functional.cross_entropy(
                logits.float().flatten(0, 1), batch["tokens"].flatten().long())
            torch.autograd.grad(nll, (x,))

    attn_fb, attn_f = time_ms(lambda: attn(True), iters=5), time_ms(
        lambda: attn(False), iters=5)
    head_ms = time_ms(head_ce, iters=5)
    zeros = {k: torch.zeros_like(p) for k, p in state["params"].items()}
    adamw_ms = time_ms(lambda: tr.opt.update(zeros, state["opt"],
                                             state["params"]),
                       iters=3, warmup=1)
    del zeros
    # per layer, the step runs the attention forward three times (forward,
    # the layer's remat recompute, each scan step's recompute) and its
    # backward once: one forward and backward, and one more forward
    attn_step = cfg.n_layers * (attn_fb + attn_f)
    dev = prof["device_ms_per_step"]
    prof.update({"plain_attention_fwd_bwd_ms_per_layer": attn_fb,
                 "plain_attention_fwd_ms_per_layer": attn_f,
                 "plain_attention_share_of_device": attn_step / dev,
                 "lm_head_ce_fwd_bwd_ms": head_ms,
                 "lm_head_ce_share_of_device": head_ms / dev,
                 "adamw_update_ms": adamw_ms,
                 "adamw_share_of_device": adamw_ms / dev})
    res["profile"] = prof
    log(f"  profile, one step: wall {prof['wall_ms_profiled']:.2f} ms, "
        f"device {dev:.2f} ms (busy share {prof['device_busy_share']:.3f}) "
        f"in {prof['device_kernels_per_step']:.0f} kernels; products "
        f"{prof['gemm_ms_per_step']:.2f} ms (share "
        f"{prof['gemm_share_of_device']:.3f}); plain attention, timed alone,"
        f" {attn_fb:.3f} ms fwd+bwd + {attn_f:.3f} ms fwd a layer (share "
        f"{prof['plain_attention_share_of_device']:.3f}); LM head + cross "
        f"entropy fwd+bwd {head_ms:.3f} ms (share "
        f"{prof['lm_head_ce_share_of_device']:.3f}); AdamW update "
        f"{adamw_ms:.3f} ms (share {prof['adamw_share_of_device']:.3f})")
    for r in prof["top"]:
        log(f"    {r['ms_per_step']:8.3f} ms {r['calls_per_step']:6.1f}x  "
            f"{r['name']}")
    del state, q, k, v, x
    shutil.rmtree(workdir, ignore_errors=True)

    checks = [
        (all(np.isfinite(losses)) and all(np.isfinite(resumed)),
         "a non-finite loss"),
        (losses[-1] < losses[0], f"the loss did not fall: {losses}"),
        (not res["zero_grad_leaves"],
         f"leaves without a gradient: {res['zero_grad_leaves']}"),
        (res["mb2_vs_mb1_rel_max"] < MB_TOL,
         f"2 microbatches vs 1: {res['mb2_vs_mb1_rel_max']} >= {MB_TOL}"),
        (failed, "the injected failure did not raise"),
        (len(resumed) == TRAIN_STEPS - DRILL_CKPT,
         f"the resumed run took {len(resumed)} steps"),
        (diff <= RESUME_RTOL * abs(losses[-1]),
         f"resumed final loss {resumed[-1]} vs {losses[-1]}"),
        (kernel_launches == 0, "the training route launched a hand kernel"),
        (res["graphs"] is not None
         and res["graphs"]["replays"] == TRAIN_STEPS - 1,
         f"the 10-step run did not replay its step: {res['graphs']}"),
        (finite, "non-finite logits in the forward check"),
        (res["forward"]["attention_calls"] == [cfg.n_layers] * 2,
         f"attention calls {res['forward']['attention_calls']}"),
    ]
    for ok, msg in checks:
        if not ok:
            raise AssertionError(f"train {cfg.name}: {msg}")
    check_limits("train forward", fwd_sound, fwd_ctl, TRAIN_LIMITS,
                 TRAIN_BREAKS)
    return res


def launcher_phase(workdir: Path) -> dict:
    """Phase 12 (b): ``python -m repro_torch.launch.train`` at full width
    and depth in a subprocess; its final loss must be below its first."""
    args = [sys.executable, "-m", "repro_torch.launch.train",
            *LAUNCHER_ARGS, "--ckpt-dir", str(workdir / "launcher")]
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    t0 = time.perf_counter()
    out = subprocess.run(args, env=env, cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    wall = time.perf_counter() - t0
    shutil.rmtree(workdir / "launcher", ignore_errors=True)
    if out.returncode != 0:
        raise AssertionError(f"launch.train failed (rc {out.returncode}):\n"
                             f"{out.stderr[-4000:]}")
    lines = out.stdout.strip().splitlines()
    first = float(next(x for x in lines if x.startswith("first loss:"))
                  .split()[2])
    final = float(next(x for x in lines if x.startswith("final loss:"))
                  .split()[2])
    res = {"args": LAUNCHER_ARGS, "first_loss": first, "final_loss": final,
           "wall_s": wall, "stdout_tail": lines[-4:]}
    log(f"launch.train {' '.join(LAUNCHER_ARGS)}: first loss {first}, final "
        f"loss {final}, {wall:.2f} s of wall (start-up included)")
    if not final < first:
        raise AssertionError(f"launch.train: final loss {final} is not below "
                             f"the first {first}")
    return res


def encdec_train_phase(model, params, seed: int) -> dict:
    """Phase 12 (c): 2 steps of ``encdec_loss`` on SeamlessM4T-large-v2 at
    full width and depth (B 4, a ragged prefix source mask over 512
    frames, 256 target tokens, remat): finite losses, every leaf's gradient
    norm above 0."""
    import numpy as np
    import torch

    from repro_torch.training import AdamW, AdamWConfig
    from repro_torch.training.train_loop import make_train_step

    cfg = model.cfg
    g = torch.Generator(device=DEVICE).manual_seed(seed + 40)
    batch = {"src_embeds": torch.randn(
        (ENC_TRAIN_B, ENC_TRAIN_S, cfg.d_model), generator=g,
        device=DEVICE).to(cfg.cdt),
        "src_mask": torch.arange(ENC_TRAIN_S, device=DEVICE)[None]
        < torch.as_tensor(ENC_TRAIN_LENS, device=DEVICE)[:, None],
        "tgt_tokens": torch.randint(4, cfg.vocab_size - 8,
                                    (ENC_TRAIN_B, ENC_TRAIN_T), generator=g,
                                    device=DEVICE)}
    opt = NormsThenAdamW(AdamW(AdamWConfig(lr=TRAIN_LR, warmup_steps=1,
                                           total_steps=2)))
    step = make_train_step(model, opt)
    state = opt.opt.init(params)
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for i in range(2):
        t0 = time.perf_counter()
        gen = torch.Generator(device=DEVICE).manual_seed(seed + i)
        _, _, m = step(params, state, batch, gen=gen)
        losses.append(float(m["loss"]))
        times.append(time.perf_counter() - t0)
    least = min(min(n.values()) for n in opt.norms)
    zero = sorted({k for n in opt.norms for k, v in n.items() if not v > 0})
    res = {"arch": cfg.name, "B": ENC_TRAIN_B, "S_src": ENC_TRAIN_S,
           "T": ENC_TRAIN_T, "src_lens": ENC_TRAIN_LENS, "losses": losses,
           "step_s": times, "grad_norm_min": least, "zero_grad_leaves": zero,
           "max_memory_allocated": torch.cuda.max_memory_allocated()}
    log(f"train {cfg.name} (encdec, {cfg.n_enc_layers} + {cfg.n_layers} "
        f"layers, B {ENC_TRAIN_B}, S_src {ENC_TRAIN_S} lengths "
        f"{ENC_TRAIN_LENS}, T {ENC_TRAIN_T}): losses {losses}, steps "
        f"{[round(t, 3) for t in times]} s, least leaf gradient norm "
        f"{least:.3e}, max_memory_allocated {res['max_memory_allocated']} B")
    del state
    if not all(np.isfinite(losses)):
        raise AssertionError(f"encdec training: non-finite loss {losses}")
    if zero:
        raise AssertionError(f"encdec training: leaves without a gradient: "
                             f"{zero}")
    return res


# ---------------------------------------------------------------------------
# the encoder-decoder family decoding (phase 13)
# ---------------------------------------------------------------------------

ENCDEC_ARCH = "seamless-m4t-large-v2"
ENC_LENS = [1024, 17, 512, 700, 1, 333, 900, 256]
ENC_S, DEC_LEN, DEC_C, DEC_WINDOWS = 1024, 256, 32, 8
# The decoding phase holds the kernel path against the plain path (the
# reference's flash_partial) at each attention call site of the first
# layer, as in phase 11: the encoder's block-diffusion output, and the
# decoder's self read and cross read (paged partials normalised as acc / l),
# each under a limit its control (the kernel's output or acc x (1 +
# CONTROL_SKEW)) must break.
ENCDEC_LIMITS = {"enc_attn_rel": 0.015, "self_attn_rel": 0.015,
                 "cross_attn_rel": 0.015}


def encdec_phase(model, params, seed: int) -> dict:
    """Phase 13: SeamlessM4T-large-v2 at full width and depth: ``admit`` 8
    requests of random source frames (ENC_LENS, padded to 1024) through the
    block-diffusion kernel, then DEC_WINDOWS block-pinned windows
    (``chunk_forward`` at c 32 on mask tokens, the argmax committed,
    ``freeze(n_adv = 32)``) reading the slot and cross caches through the
    paged kernel; launch counts, the caches in place, finite logits; the
    call-site checks and one window profiled."""
    import torch

    import repro_torch.models.encdec as encdec
    from repro_torch.kernels import block_diffusion_attn as bda
    from repro_torch.kernels import chunked_paged_attn as cpa

    cfg = model.cfg
    B = len(ENC_LENS)
    g = torch.Generator(device=DEVICE).manual_seed(seed + 30)
    src = torch.randn((B, ENC_S, cfg.d_model), generator=g,
                      device=DEVICE).to(cfg.cdt)
    mask = torch.arange(ENC_S, device=DEVICE)[None] < torch.as_tensor(
        ENC_LENS, device=DEVICE)[:, None]
    cache = model.init_cache(B, DEC_LEN, ENC_S, dtype=torch.bfloat16,
                             device=DEVICE)
    names = ("k", "v", "cross_k", "cross_v")
    ptrs = [cache[n].data_ptr() for n in names]
    full = torch.full((B,), DEC_C, dtype=torch.int64, device=DEVICE)
    win = torch.full((B, DEC_C), cfg.mask_token_id, dtype=torch.int64,
                     device=DEVICE)

    torch.cuda.synchronize()
    cpa.LAUNCHES = cpa.MERGE_LAUNCHES = bda.LAUNCHES = 0
    t0 = time.perf_counter()
    model.admit(params, cache, src, mask, impl="kernel")
    torch.cuda.synchronize()
    admit_ms = (time.perf_counter() - t0) * 1e3
    bd_launches = bda.LAUNCHES
    finite = torch.ones((), dtype=torch.bool, device=DEVICE)
    committed = []
    t0 = time.perf_counter()
    for _ in range(DEC_WINDOWS):
        start = cache["len"].long()
        logits, kv = model.chunk_forward(params, cache, win, start, full,
                                         impl="kernel")
        finite &= torch.isfinite(logits).all()
        committed.append(logits.argmax(-1))
        model.freeze(cache, kv, start, full)
    torch.cuda.synchronize()
    windows_s = time.perf_counter() - t0
    launches, merges = cpa.LAUNCHES, cpa.MERGE_LAUNCHES
    finite = bool(finite)
    res = {"arch": cfg.name, "layers": [cfg.n_enc_layers, cfg.n_layers],
           "d_model": cfg.d_model, "heads": [cfg.n_heads, cfg.n_kv_heads],
           "head_dim": cfg.hd, "src_lens": ENC_LENS, "src_len": ENC_S,
           "slot_len": DEC_LEN, "c": DEC_C, "windows": DEC_WINDOWS,
           "admit_wall_ms": admit_ms, "windows_wall_s": windows_s,
           "bd_kernel_launches": bd_launches, "kernel_launches": launches,
           "merge_launches": merges, "finite_logits": finite,
           "tokens_committed": B * DEC_C * DEC_WINDOWS}
    log(f"encdec {cfg.name} ({cfg.n_enc_layers} + {cfg.n_layers} layers, "
        f"d_model {cfg.d_model}): admission of {B} sources (lengths "
        f"{ENC_LENS}, padded to {ENC_S}) {admit_ms:.2f} ms wall, "
        f"{bd_launches} block-diffusion launches; {DEC_WINDOWS} windows of "
        f"c {DEC_C} in {windows_s:.3f} s, {launches} paged launches ({merges}"
        f" with a split merge); logits finite {finite}")

    # the call-site checks: the encoder's first layer, and the first
    # layer's self and cross reads of one more window (ctx 256) on the
    # filled caches
    enc_names = ("block_diffusion_attention", "flash_partial")
    dec_names = ("paged_chunk_attention", "flash_partial")

    def encode(impl):
        return attention_outputs(lambda: model.encode(params, src, mask,
                                                      impl=impl),
                                 module=encdec, names=enc_names)

    def window(impl):
        return attention_outputs(lambda: model.chunk_forward(
            params, cache, win, cache["len"].long(), full, impl=impl)[0],
            module=encdec, names=dec_names)

    with torch.no_grad():
        e_plain, e_kernel = encode("ref"), encode("kernel")
        w_plain, w_kernel = window("ref"), window("kernel")
        exact_bd, exact_pa = encdec.block_diffusion_attention, \
            encdec.paged_chunk_attention
        encdec.block_diffusion_attention = \
            lambda *a, **k: exact_bd(*a, **k) * (1 + CONTROL_SKEW)

        def skewed(*a, **k):
            acc, m, l = exact_pa(*a, **k)
            return acc * (1 + CONTROL_SKEW), m, l

        encdec.paged_chunk_attention = skewed
        try:
            e_ctl, w_ctl = encode("kernel"), window("kernel")
        finally:
            encdec.block_diffusion_attention = exact_bd
            encdec.paged_chunk_attention = exact_pa
    torch.cuda.synchronize()

    def rel(a, b):
        return float((a - b).abs().max()) / float(b.abs().max())

    def readings(enc, win_run):
        return {"enc_attn_rel": rel(enc[1][0], e_plain[1][0]),
                "self_attn_rel": rel(win_run[1][0], w_plain[1][0]),
                "cross_attn_rel": rel(win_run[1][1], w_plain[1][1]),
                "enc_out_rel": float((enc[0].float() - e_plain[0].float())
                                     .abs().max())
                / float(e_plain[0].float().std()),
                "logits_rel": float((win_run[0] - w_plain[0]).abs().max())
                / float(w_plain[0].std()),
                "tokens_differ_share": float(
                    (win_run[0].argmax(-1) != w_plain[0].argmax(-1))
                    .float().mean())}

    sound, ctl = readings(e_kernel, w_kernel), readings(e_ctl, w_ctl)
    res.update({"limits": ENCDEC_LIMITS, "kernel_vs_plain": sound,
                "control_vs_plain": ctl})
    for key in sound:
        log(f"  {key}: kernel {sound[key]:.5f}  control (x "
            f"{1 + CONTROL_SKEW}) {ctl[key]:.5f}  limit "
            f"{ENCDEC_LIMITS.get(key, 'none (a reading)')}")

    def dispatch(impl):
        logits, _ = model.chunk_forward(params, cache, win,
                                        cache["len"].long(), full, impl=impl)
        return logits.argmax(-1).cpu()

    res["profile"] = profile_dispatch(dispatch, "paged_chunk_attn", 5, 3)
    log_profile(f"encdec window ({cfg.name}, B {B}, c {DEC_C}, ctx "
                f"{DEC_LEN})", res["profile"], "paged")
    n_attn = cfg.n_enc_layers
    checks = [
        (bd_launches == n_attn, f"{bd_launches} block-diffusion launches != "
         f"{n_attn} encoder layers x 1 admission"),
        (launches == 2 * cfg.n_layers * DEC_WINDOWS,
         f"{launches} paged launches != 2 x {cfg.n_layers} x {DEC_WINDOWS} "
         f"windows"),
        (merges <= launches, f"{merges} merges > {launches} launches"),
        (finite, "non-finite logits"),
        ([cache[n].data_ptr() for n in names] == ptrs,
         "the slot or cross cache moved"),
        (bool((cache["len"] == DEC_LEN).all()), "a slot's len is not 256"),
        (len(e_kernel[1]) == len(e_plain[1]) == cfg.n_enc_layers
         and len(w_kernel[1]) == len(w_plain[1]) == 2 * cfg.n_layers,
         "attention call counts disagree"),
    ]
    for ok, msg in checks:
        if not ok:
            raise AssertionError(f"encdec {cfg.name}: {msg}")
    check_limits("encdec", sound, ctl, ENCDEC_LIMITS, tuple(ENCDEC_LIMITS))
    return res


# ---------------------------------------------------------------------------
# phase 14: the static analyzer and the dry run
# ---------------------------------------------------------------------------

# (ii): SDAR-8B's dispatches at full width, every row live
AUDIT_SHAPE = dict(B=8, c=32, T=512, ctx=512, max_len=1024)
# (iii): cells one card holds, each on a 1 x 1 mesh: SDAR-8B decode at full
# width cut to 2 layers (128 x 32,800 tokens of bf16 KV, 34.4 GB), and
# SmolLM-135M's training step cut to 2 layers, 16 microbatches of 16 x 4096
# tokens (the dry run predicts a 39.6 GB peak; at 8 it predicts 78.8 GB)
DRYRUN_CELLS = [("sdar-8b", "decode_32k", {"n_layers": 2}),
                ("smollm-135m", "train_4k",
                 {"n_layers": 2, "microbatches": 16})]
# the caching allocator rounds a block up to 512 B, and leaves the rest of
# a large-pool segment (blocks above 1 MiB) in the block when under 1 MiB
ALLOC_ROUND, ALLOC_LARGE = 512, 1 << 20


def start_dryrun(workdir: Path):
    """The dry run of DRYRUN_CELLS on ``meta`` (the CLI, once a cell) in a
    subprocess started now: it needs no card, and its trace is host work
    that runs beside the phases before 14."""
    code = ("import json, sys\n"
            "from repro_torch.launch import dryrun\n"
            f"for arch, shape, over in {DRYRUN_CELLS!r}:\n"
            "    rc = dryrun.main(['--arch', arch, '--shape', shape,\n"
            "                      '--devices', '1', '--force', '--out',\n"
            f"                      {str(workdir)!r}, '--cfg-override',\n"
            "                      json.dumps(over)])\n"
            "    if rc:\n"
            "        sys.exit(rc)\n")
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    return subprocess.Popen([sys.executable, "-c", code], env=env,
                            cwd=str(ROOT), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def analysis_cli_phase() -> dict:
    """(i) The audit as the CLI runs it — on the audit model, on the card,
    at 1 and 2 shards of it — then each seeded dispatch fixture on CUDA
    tensors, which must fire exactly its rule; and the sync counter against
    a dispatch that does sync (``.item()``), which it must see."""
    import torch

    from repro_torch.analysis import check, fixtures, hlo, optrace, rules

    t0 = time.perf_counter()
    rc = check.main(["--device", DEVICE, "--kv-shards", "1,2", "--verbose"])
    if rc != 0:
        raise AssertionError(f"phase 14 (i): the analyzer's CLI exited {rc}")
    fired = {}
    fn, (cache, x) = fixtures.undonated_pool_step(DEVICE)
    ptrs = rules.pool_ptrs(cache)
    out, tr = optrace.trace(fn, cache, x)
    fired["HLO001"] = rules.check_pool_donation(out, ptrs, tr)
    fn, args = fixtures.vocab_escaping_step(DEVICE)
    syncs, (_, tr) = rules.count_syncs(lambda: optrace.trace(fn, *args),
                                       DEVICE)
    fired["HLO002"] = rules.check_vocab_escape(
        tr.outputs, vocab_size=fixtures.FIXTURE_VOCAB)
    fired["HLO003"] = rules.check_host_budget(
        tr.outputs, budget_bytes=8 * fixtures.FIXTURE_B * fixtures.FIXTURE_C,
        syncs=syncs)
    fn, args, expected = fixtures.missing_collective_step(DEVICE)
    _, tr = hlo.traced(fn, *args)
    fired["HLO004"] = rules.check_collectives(tr.collectives,
                                              expected=expected)
    fn, makers = fixtures.unbucketed_grid_step(DEVICE)
    fired["HLO005"] = rules.check_recompile_churn(fn, makers,
                                                  declared_buckets=3)
    control, _ = rules.count_syncs(
        lambda: torch.ones(1, device=DEVICE).sum().item(), DEVICE)
    res = {"cli_rc": rc, "fixture_syncs": syncs, "sync_control": control,
           "fired": {k: sorted({f.rule for f in v})
                     for k, v in fired.items()},
           "wall_s": time.perf_counter() - t0}
    log(f"phase 14 (i): CLI rc {rc}; fixtures fired {res['fired']}; "
        f"syncs counted in the vocab fixture {syncs}, in the .item() "
        f"control {control}; {res['wall_s']:.3f} s")
    checks = [(v == [k], f"fixture {k} fired {v}")
              for k, v in res["fired"].items()]
    checks.append((control and control > 0, "the sync counter saw no sync "
                   "in a dispatch that syncs"))
    checks.append((syncs == 0, f"the vocab fixture synced {syncs} times"))
    raise_failed("phase 14 (i)", checks)
    return res


def analysis_model_phase(model, params) -> dict:
    """(ii) Pass 1 at full width: the inventory's entries built on
    SDAR-8B (phase 7's weights drawn again from the seed) with every row
    live — decode at B 8, c 32, ctx 512 and a chunked prefill of 512
    tokens after 512 through the paged kernel, the wave at B 8, T 512
    through the block-diffusion kernel, ``copy_pages`` and
    ``write_pages`` — at 1 shard and at 2 shards of this card.  HLO001-005
    give no finding (HLO003 with the dispatch's sync count), and each
    kernel's launches equal layers x its dispatches (S x for a sharded
    read)."""
    import torch

    from repro_torch.analysis import check, inventory
    from repro_torch.kernels import block_diffusion_attn as bda
    from repro_torch.kernels import chunked_paged_attn as cpa

    t0 = time.perf_counter()
    L = model.cfg.n_layers
    findings, rows = [], []
    cpa.LAUNCHES = cpa.MERGE_LAUNCHES = bda.LAUNCHES = 0
    want_paged = want_bd = 0
    for S in (1, 2):
        entries = inventory.build_entries(
            S, DEVICE, model=model, params=params,
            cache_dtype=torch.bfloat16, **AUDIT_SHAPE)
        for e in entries:
            st = {}
            fs = check.audit_entry(e, DEVICE, stats=st)
            findings += fs
            runs = st["runs"]            # a warm-up, the audited one, churn
            if e.name in ("decode_step_paged", "prefill_chunk_paged"):
                want_paged += S * L * runs
            if e.name == "prefill_paged":
                want_bd += L * runs
            census = st["vocab_intermediates"]
            row = {"target": e.target, "findings": len(fs),
                   "syncs": st["syncs"], "ops": st["ops"],
                   "trace_flops": st["flops"], "trace_bytes": st["bytes"],
                   "kernel_ops": st["kernels"],
                   "grown_bytes": st["grown_bytes"],
                   "vocab_intermediates": len(census),
                   "vocab_shapes": sorted({str(list(s)) for _, s in census})}
            rows.append(row)
            log(f"phase 14 (ii): {e.target}: {len(fs)} findings, "
                f"{st['syncs']} syncs, {st['ops']} ops, "
                f"{st['flops']:.4e} FLOPs, {st['bytes']:.4e} B, kernels "
                f"{st['kernels']}, memory grown {st['grown_bytes']} B, "
                f"{len(census)} vocab-axis intermediates "
                f"{row['vocab_shapes']}")
        del entries
        torch.cuda.empty_cache()
    findings += inventory.audit_registration()
    torch.cuda.synchronize()
    res = {"rows": rows, "findings": [f.to_dict() for f in findings],
           "kernel_launches": cpa.LAUNCHES,
           "merge_launches": cpa.MERGE_LAUNCHES,
           "bd_kernel_launches": bda.LAUNCHES,
           "want_paged_launches": want_paged, "want_bd_launches": want_bd,
           "wall_s": time.perf_counter() - t0}
    log(f"phase 14 (ii): {len(findings)} findings; paged launches "
        f"{cpa.LAUNCHES} (want {want_paged}), merge {cpa.MERGE_LAUNCHES}, "
        f"block-diffusion {bda.LAUNCHES} (want {want_bd}); "
        f"{res['wall_s']:.3f} s")
    raise_failed("phase 14 (ii)", [
        (not findings, "; ".join(f"{f.rule} {f.target}: {f.message}"
                                 for f in findings[:4])),
        (cpa.LAUNCHES == want_paged,
         f"{cpa.LAUNCHES} paged launches != {want_paged}"),
        (bda.LAUNCHES == want_bd,
         f"{bda.LAUNCHES} block-diffusion launches != {want_bd}")])
    return res


def dryrun_phase(proc, workdir: Path, seed: int) -> list[dict]:
    """(iii) The dry run's prediction for DRYRUN_CELLS (the subprocess of
    :func:`start_dryrun`) set against the same step run on the card with
    real tensors: the argument bytes against ``memory_allocated()`` once
    the arguments are placed (equal within the allocator's rounding: up to
    ALLOC_ROUND a leaf, ALLOC_LARGE a leaf above it), the predicted peak
    (arguments + the trace's peak of live bytes) against
    ``max_memory_allocated()`` during the step, and the roofline time of
    the trace's FLOPs and device-memory traffic (``hbm_bytes``) beside the
    step's wall (readings)."""
    import torch

    from repro_torch.launch import dryrun, specs
    from repro_torch.launch.mesh import Mesh

    out, _ = proc.communicate(timeout=600)
    log(out.rstrip())
    if proc.returncode != 0:
        raise AssertionError(f"phase 14 (iii): the dry run exited "
                             f"{proc.returncode}")
    mesh = Mesh(("data", "model"), (1, 1), (torch.device("meta"),))
    rows = []
    for arch, shape, over in DRYRUN_CELLS:
        rec = json.loads((workdir / "pod_16x16" /
                          f"{arch}__{shape}.json").read_text())
        meta = specs.build_cell(arch, shape, mesh, cfg_overrides=over)
        leaves = [t.numel() * t.element_size()
                  for t, _ in dryrun._leaves(meta.args, meta.in_shardings)]
        rounded = sum(-(-n // ALLOC_ROUND) * ALLOC_ROUND for n in leaves)
        slack = sum(ALLOC_LARGE if n > ALLOC_LARGE else ALLOC_ROUND
                    for n in leaves)
        del meta
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        cell = specs.build_cell(arch, shape, mesh, cfg_overrides=over,
                                device=DEVICE, seed=seed)
        torch.cuda.synchronize()
        placed = torch.cuda.memory_allocated() - base
        walls, peaks = [], []
        for _ in range(2 if cell.kind != "train" else 1):
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res = cell.fn(*cell.args)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            peaks.append(torch.cuda.max_memory_allocated() - base)
            del res
        tr = rec["trace"]
        pred_peak = rec["arg_bytes_per_device"] + tr["peak_live_bytes"]
        roof_ms, roof_by = roofline(tr["flops"], tr["hbm_bytes"],
                                    "bfloat16")
        row = {"arch": arch, "shape": shape, "overrides": over,
               "kind": cell.kind, "leaves": len(leaves),
               "pred_arg_bytes": rec["arg_bytes_per_device"],
               "pred_arg_bytes_rounded": rounded, "rounding_slack": slack,
               "placed_bytes": placed,
               "pred_peak_bytes": pred_peak, "measured_peak_bytes":
               peaks[-1], "peak_ratio": peaks[-1] / pred_peak,
               "trace_flops": tr["flops"], "trace_bytes": tr["bytes"],
               "trace_hbm_bytes": tr["hbm_bytes"],
               "trace_ops": tr["ops"], "kernel_ops": tr["kernel_ops"],
               "trace_s": rec["trace_s"], "model_flops": rec["model_flops"],
               "roofline_ms": roof_ms, "roofline_by": roof_by,
               "wall_ms": [w * 1e3 for w in walls],
               "wall_over_roofline": walls[-1] * 1e3 / roof_ms}
        rows.append(row)
        log(f"phase 14 (iii): {arch} {shape} {over}: arguments predicted "
            f"{row['pred_arg_bytes']} B ({rounded} B at the allocator's "
            f"{ALLOC_ROUND} B over {len(leaves)} leaves), placed {placed} "
            f"B; peak predicted {pred_peak} B, measured {peaks[-1]} B "
            f"(ratio {row['peak_ratio']:.4f}); trace {tr['flops']:.4e} "
            f"FLOPs, {tr['hbm_bytes']:.4e} B of traffic ({tr['bytes']:.4e} "
            f"operand + result B, {tr['ops']} ops, "
            f"{rec['trace_s']} s on meta) -> roofline {roof_ms:.3f} ms "
            f"({roof_by}); wall {', '.join(f'{w * 1e3:.3f}' for w in walls)}"
            f" ms ({row['wall_over_roofline']:.2f}x)")
        raise_failed(f"phase 14 (iii) {arch} {shape}", [
            (rec["status"] == "ok", "the dry run failed"),
            (row["pred_arg_bytes"] <= placed
             <= row["pred_arg_bytes"] + slack,
             f"placed {placed} B is not the predicted "
             f"{row['pred_arg_bytes']} B within the allocator's rounding "
             f"({slack} B)")])
        del cell
        gc.collect()
        torch.cuda.empty_cache()
    return rows



# ---------------------------------------------------------------------------
# phase 18: the examples on the card
# ---------------------------------------------------------------------------

EXAMPLE_SERVE_ARGS = ["--tight-pool"]        # (i), at the script's defaults
EXAMPLE_TRAIN_ARGS = ["--full", "--steps", "40"]     # (iii): smollm-135m


def load_example(name: str):
    """``examples/<name>_torch.py`` as a module (the folder is no
    package)."""
    import importlib.util

    path = ROOT / "examples" / f"{name}_torch.py"
    spec = importlib.util.spec_from_file_location(f"{name}_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_example(what: str, fn, *a, **kw):
    """``fn(*a, **kw)`` with what it prints logged under ``what``; returns
    (its result, its seconds of wall)."""
    import contextlib
    import io

    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            res = fn(*a, **kw)
    finally:
        for line in buf.getvalue().splitlines():
            log(f"  [{what}] {line}")
    return res, time.perf_counter() - t0


def record_ar_margins(be, margins: dict, rel_tol: float = FP32_TOL):
    """An AR run on the CPU: for each committed token, the op rule's margin
    at the logits that chose it (``rel_tol`` x max(|top-1|, 1) - the
    top-1/top-2 gap; below 0 the gap exceeds the op tolerance, so a token
    that differs there is a fault):
    ``margins[rid][output index]``.  An AR request's first token comes
    from its last prefill chunk, the others from its AR steps.  Wraps the
    sampler and the backend's AR step and chunked-prefill tick; undo with
    the returned function."""
    import repro_torch.models.transformer as tfm

    sampler = tfm.softmax_confidence_device
    step, tick = be._step_ar_paged, be._chunked_prefill_tick
    last = {}

    def sample(logits):
        top2 = logits.float().topk(2, dim=-1).values
        top2 = top2.reshape(top2.shape[0], -1, 2)[:, 0]
        last["margin"] = (rel_tol * top2[:, 0].abs().clamp(min=1.0)
                          - (top2[:, 0] - top2[:, 1])).cpu().numpy()
        return sampler(logits)

    def ar_step(rids, infos):
        before = {r: be.state(r).frozen for r in rids}
        step(rids, infos)
        for i, r in enumerate(rids):
            margins.setdefault(r, {})[before[r]] = float(last["margin"][i])

    def prefill_tick(live_bc=0):
        fresh = tick(live_bc)
        for i, (rid, _, _) in enumerate(be.last_prefill_plan):
            if rid in fresh:
                margins.setdefault(rid, {})[0] = float(last["margin"][i])
        return fresh

    tfm.softmax_confidence_device = sample
    be._step_ar_paged, be._chunked_prefill_tick = ar_step, prefill_tick

    def undo():
        tfm.softmax_confidence_device = sampler
    return undo


def serve_example(se, device: str, params=None, base: bool = False) -> dict:
    """``serve_elastic_torch.main(EXAMPLE_SERVE_ARGS)`` on ``device``: for
    each of its five runs the committed tokens by request and every
    diffusion dispatch's commit record (:func:`dispatch_divergence`'s);
    as the ``base`` (the CPU run: every dispatch samples on the host) with
    the fp32 rule's gaps and the AR run's margins, else (the card run,
    captured) with the checks of phase 18 (i).  Returns the runs, the
    main's result, the params it served (on the CPU), its launches and
    its wall."""
    import torch

    from repro_torch.analysis import rules
    from repro_torch.kernels import block_diffusion_attn as bda
    from repro_torch.kernels import chunked_paged_attn as cpa

    card = not base
    argv = [*EXAMPLE_SERVE_ARGS, "--torch-device", device]
    a = se.parse_args(argv)
    steps, runs, host = {}, {}, {}
    failed = []

    def on_backend(name, be):
        if "params" not in host:
            host["params"] = {k: v.detach().cpu()
                              for k, v in be.params.items()}
        run = runs[name] = {"outputs": {}, "steps": {}, "ar_margins": {},
                            "ptrs": rules.pool_ptrs(be.kv),
                            "launches0": (cpa.LAUNCHES, bda.LAUNCHES)}
        release = be.release

        def spy(rid):
            st = be.state(rid)
            run["outputs"][rid] = st.output_tokens
            run["steps"][rid] = steps.pop(id(st), [])
            release(rid)

        be.release = spy
        run["undo"] = record_ar_margins(be, run["ar_margins"]) \
            if not card and name == "ar" else None

    def on_served(name, be, rep):
        run = runs[name]
        undo_ar = run.pop("undo")
        if undo_ar is not None:
            undo_ar()
        p0, b0 = run.pop("launches0")
        run.update(requests=len(rep.metrics), preemptions=rep.preemptions,
                   kernel_launches=cpa.LAUNCHES - p0,
                   bd_kernel_launches=bda.LAUNCHES - b0,
                   chunks=[int(c) for _, _, c in rep.chunk_history],
                   graphs=graph_stats(be))
        checks = [
            (len(rep.metrics) == a.requests
             and all(m.n_tokens == a.out for m in rep.metrics),
             "a request did not complete in full"),
            (be.kv.free_pages == be.kv.n_pages, "the pool did not drain"),
            *pool_checks(name, be.kv, run.pop("ptrs"))]
        if card:
            checks += [
                (be.device.type == torch.device(DEVICE).type
                 and all(t.device == be.device for t in be.params.values())
                 and all(t.device == be.device
                         for t in rules.pool_tensors(be.kv)),
                 "the params or the pool are not on the card"),
                (be.graphs is not None and be.graphs.replays > 0,
                 "the backend's graph cache did not replay")]
        failed.extend(f"{name}: {msg}" for ok, msg in checks if not ok)

    cpa.LAUNCHES = cpa.MERGE_LAUNCHES = bda.LAUNCHES = 0
    undo = record_gaps(None, {}, steps=steps, rel_tol=FP32_TOL,
                       sampled=not card)
    try:
        res, wall = run_example(f"serve_elastic {device}", se.main, argv,
                                params=params, on_backend=on_backend,
                                on_served=on_served)
    finally:
        for run in runs.values():           # a run that raised mid-serve
            if run.get("undo") is not None:
                run.pop("undo")()
        undo()
    launches = {"kernel_launches": cpa.LAUNCHES,
                "merge_launches": cpa.MERGE_LAUNCHES,
                "bd_kernel_launches": bda.LAUNCHES}
    if card:
        torch.cuda.synchronize()
    if failed:
        raise AssertionError(f"serve_elastic_torch on {device}: {failed}")
    return {"runs": runs, "result": res, "params": host["params"],
            "wall_s": wall, **launches}


def ar_divergence(run, base, what: str) -> dict:
    """Each request's first AR token where ``run`` and ``base`` differ:
    up to it both committed the same tokens, so its logits differ only by
    rounding, and ``base``'s fp32 rule margin there (its recorded
    ``ar_margins``) must not be below 0."""
    out, faults = {}, []
    for rid, want in base["outputs"].items():
        got = run["outputs"][rid]
        i = next((i for i, (x, y) in enumerate(zip(got, want)) if x != y),
                 None)
        if i is None:
            continue
        out[rid] = {"index": i, "margin": base["ar_margins"][rid][i]}
        if out[rid]["margin"] < 0:
            faults.append((rid, out[rid]))
    log(f"{what}: first differing token by request {out}")
    if faults:
        raise AssertionError(f"{what}: a first differing token breaks the "
                             f"fp32 rule: {faults}")
    return out


def closest_decision(run) -> float | None:
    """A base run's largest fp32 rule margin over its decisions (every
    committed token's top-1/top-2 gap, every uncommitted position's
    distance from the threshold): at or above 0, rounding within the op
    tolerance could flip that decision.  A reading."""
    import numpy as np

    vals = [m for r in run["ar_margins"].values() for m in r.values()]
    for recs in run["steps"].values():
        for s in recs:
            vals += list((s["tol"] - s["gap"])[s["commit"]])
            unc = ~s["cai"]
            vals += list(2 * s["tol"][unc] - np.abs(
                np.log(np.maximum(s["conf"][unc], 1e-300))
                - np.log(s["threshold"])))
    return float(max(vals)) if vals else None


def example_serve_phase() -> dict:
    """Phase 18 (i): ``serve_elastic_torch --tight-pool`` on the card at
    its defaults, then on the CPU from the same params; the AR and fixed-8
    runs' tokens held by the fp32 rule, the elastic run's chunks logged."""
    from collections import Counter

    import torch

    se = load_example("serve_elastic")
    card = serve_example(se, DEVICE)
    gc.collect()
    torch.cuda.empty_cache()
    cpu = serve_example(se, "cpu", params=card.pop("params"), base=True)
    cpu.pop("params")
    cr, br = card["runs"], cpu["runs"]
    res = {"card": card, "cpu": cpu, "compare": {}}
    for name in ("ar", "fixed8"):
        differ = sum(x != y for rid, want in br[name]["outputs"].items()
                     for x, y in zip(cr[name]["outputs"][rid], want))
        what = f"phase 18 (i) serve_elastic {name}, card vs CPU"
        first = ar_divergence(cr[name], br[name], what) if name == "ar" \
            else dispatch_divergence(cr[name], br[name], what, rule="fp32")
        res["compare"][name] = {"tokens_differ": differ, "first": first,
                                "closest": closest_decision(br[name])}
        total = sum(map(len, br[name]["outputs"].values()))
        log(f"{what}: {differ} of {total} committed tokens differ; the CPU "
            f"run's largest fp32 rule "
            f"margin over its decisions {res['compare'][name]['closest']}")
    hist = {side: dict(sorted(Counter(runs["elastic"]["chunks"]).items()))
            for side, runs in (("card", cr), ("cpu", br))}
    log(f"phase 18 (i) elastic chunk history (chunk: ticks): card, H100_SXM "
        f"profile {hist['card']}; CPU, CPU_HOST profile {hist['cpu']}; the "
        f"same sequence: {cr['elastic']['chunks'] == br['elastic']['chunks']}")
    tight = card["result"]["tight"]
    if tight["preemptions"] < 1:
        raise AssertionError("phase 18 (i): the tight pool did not preempt")
    if card["kernel_launches"] <= 0:
        raise AssertionError("phase 18 (i): no paged kernel launch")
    log(f"phase 18 (i): card {card['wall_s']:.3f} s, CPU {cpu['wall_s']:.3f} "
        f"s wall; paged launches {card['kernel_launches']} "
        f"({card['merge_launches']} with a split merge), block-diffusion "
        f"{card['bd_kernel_launches']}; tight pool {tight['pages']} pages, "
        f"{tight['preemptions']} preemptions; graphs by run "
        f"{ {n: r['graphs'] for n, r in cr.items()} }")
    for side in (card, cpu):
        for run in side["runs"].values():
            del run["steps"]
        side["result"] = {n: {k: v for k, v in r.items() if k != "report"}
                          for n, r in side["result"].items()}
    return res


def example_quickstart_phase() -> dict:
    """Phase 18 (ii): ``quickstart_torch`` on the card (60 training steps,
    then the decode at chunks 2, 4, 8), the kernels' launches counted over
    it; then each chunk's decode again on the card and on the CPU from the
    card-trained params, held by the fp32 rule."""
    import numpy as np

    from repro_torch.kernels import block_diffusion_attn as bda
    from repro_torch.kernels import chunked_paged_attn as cpa

    qs = load_example("quickstart")
    cpa.LAUNCHES = cpa.MERGE_LAUNCHES = bda.LAUNCHES = 0
    out, wall = run_example("quickstart", qs.main,
                            ["--torch-device", DEVICE])
    res = {"wall_s": wall, "kernel_launches": cpa.LAUNCHES,
           "merge_launches": cpa.MERGE_LAUNCHES,
           "bd_kernel_launches": bda.LAUNCHES, "losses": out["losses"],
           "decode": out["decode"], "agreement": out["agreement"],
           "compare": {}}
    losses = out["losses"]
    checks = [(losses[59] < losses[19], f"loss at step 60 {losses[59]} is "
               f"not below step 20's {losses[19]}"),
              (all(len(out["outputs"][c]) == 32 for c in qs.CHUNKS),
               "a chunk did not commit 32 tokens"),
              (res["kernel_launches"] > 0, "no paged kernel launch")]
    raise_failed("phase 18 (ii) quickstart", checks)
    model = qs.build_model(qs.CFG)
    host = {k: v.cpu() for k, v in out["params"].items()}
    for chunk in qs.CHUNKS:
        on_card, on_cpu = [], []
        st_card = qs.decode(model, out["params"], out["prompt"], chunk,
                            steps=on_card)
        st_cpu = qs.decode(model, host, out["prompt"], chunk, steps=on_cpu)
        for s in on_cpu:
            s["tol"] = FP32_TOL * np.maximum(np.abs(s["top1"]), 1.0)
        what = f"phase 18 (ii) quickstart decode chunk {chunk}, card vs CPU"
        first = dispatch_divergence({"steps": {chunk: on_card}},
                                    {"steps": {chunk: on_cpu}}, what,
                                    rule="fp32")
        base = {"ar_margins": {}, "steps": {chunk: on_cpu}}
        res["compare"][chunk] = {
            "tokens_differ": sum(x != y for x, y in zip(
                st_card.output_tokens, st_cpu.output_tokens)),
            "card_repeat_equal":
                st_card.output_tokens == out["outputs"][chunk],
            "first": first, "closest": closest_decision(base)}
        log(f"{what}: {res['compare'][chunk]}")
    log(f"phase 18 (ii): {wall:.3f} s wall; losses at 20/40/60 "
        f"{losses[19]:.4f} / {losses[39]:.4f} / {losses[59]:.4f}; paged "
        f"launches {res['kernel_launches']} ({res['merge_launches']} with a "
        f"split merge), block-diffusion {res['bd_kernel_launches']}")
    return res


def example_train_phase(workdir: Path) -> dict:
    """Phase 18 (iii): ``train_diffusion_lm_torch --full --steps 40``
    (smollm-135m at full width and depth, fp32, captured): the failure
    at step 25, the restart from the checkpoint after 20 steps to step 40,
    and its losses bit-equal to an uninterrupted run resumed from the same
    checkpoint (run just before the restart, saving nothing)."""
    import dataclasses

    import torch

    from repro_torch.training import Trainer

    tl = load_example("train_diffusion_lm")
    argv = [*EXAMPLE_TRAIN_ARGS, "--ckpt", str(workdir / "example_ckpt"),
            "--torch-device", DEVICE]
    seen = {}

    def before_restart(tr):
        cfg, dc, opt, tc = tl.configs(tl.parse_args(argv))
        twin = Trainer(cfg, dc, opt, dataclasses.replace(tc, ckpt_every=0),
                       device=DEVICE)
        seen["from"] = tr.ckpt.latest_step()
        seen["losses"], seen["wall_s"] = run_example(
            "uninterrupted twin", twin.run, resume=True)
        seen["replays"] = twin.graphs.replays
        twin.graphs = None
        gc.collect()
        torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()     # what earlier phases left
    out, wall = run_example("train_diffusion_lm", tl.main, argv,
                            before_restart=before_restart)
    peak = torch.cuda.max_memory_allocated()
    a = tl.parse_args(argv)
    every = a.steps // 4
    resume = (a.steps // 2 + 5) // every * every     # the last save before
    res = {"arch": out["arch"], "failed_at": out["failed_at"],
           "resumed_from": out["resumed_from"], "losses": out["losses"],
           "p50_step_ms": out["p50_step_s"] * 1e3,
           "graph_replays": out["graph_replays"],
           "max_memory_allocated": peak, "allocated_before": held,
           "wall_s": wall,
           "twin": {k: seen.get(k) for k in ("from", "losses", "replays",
                                             "wall_s")}}
    checks = [
        (out["failed_at"] == a.steps // 2 + 5, "the failure was not raised"),
        (out["resumed_from"] == seen.get("from") == resume,
         f"resumed from {out['resumed_from']}, not {resume}"),
        (len(out["losses"]) == a.steps - resume,
         "the restart did not reach the last step"),
        (out["losses"] == seen.get("losses"),
         "the resumed losses differ from the uninterrupted run's"),
        (out["graph_replays"] and seen["replays"],
         "the train step did not replay")]
    log(f"phase 18 (iii) {out['arch']}: failure at step {out['failed_at']}, "
        f"resumed from {out['resumed_from']}, {len(out['losses'])} steps to "
        f"{a.steps}; median step {res['p50_step_ms']:.3f} ms; graph replays "
        f"{out['graph_replays']} (twin {seen['replays']}); "
        f"max_memory_allocated {peak} B ({peak - held} B above the {held} B "
        f"allocated before); losses equal to the uninterrupted "
        f"run's: {out['losses'] == seen.get('losses')}; {wall:.3f} s wall")
    raise_failed("phase 18 (iii) train_diffusion_lm", checks)
    return res


def example_host_phase() -> dict:
    """Phase 18 (iv): the host-only twins, for the record."""
    ss, cs = load_example("scheduler_sim"), load_example("cluster_sim")
    sched, ws = run_example("scheduler_sim", ss.main,
                            ["--device", "h100-sxm"])
    cluster, wc = run_example("cluster_sim", cs.main, [])
    return {"scheduler_sim": {**sched, "wall_s": ws},
            "cluster_sim": {**cluster, "wall_s": wc}}


def examples_phase() -> dict:
    """Phase 18: the five example twins driven in-process on the card."""
    import torch

    t0 = time.perf_counter()
    res = {"serve": example_serve_phase()}
    gc.collect()
    torch.cuda.empty_cache()
    res["quickstart"] = example_quickstart_phase()
    gc.collect()
    torch.cuda.empty_cache()
    workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_examples_"))
    try:
        res["train"] = example_train_phase(workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    res["host"] = example_host_phase()
    for k in ("kernel_launches", "merge_launches", "bd_kernel_launches"):
        res[k] = res["serve"]["card"][k] + res["quickstart"][k]
    res["wall_s"] = time.perf_counter() - t0
    log(f"phase 18: {res['wall_s']:.3f} s wall")
    return res


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

    from repro_torch.kernels import build

    time_captures()
    count_nodes()
    t0 = time.perf_counter()
    libs = build.build(build.all_sources())
    build_s = time.perf_counter() - t0
    log(f"built {sorted(libs)} in {build_s:.2f} s")
    ptxas = [r for path in libs.values()
             for r in ptxas_report(Path(str(path) + ".log").read_text())]
    for r in ptxas:
        log(f"  ptxas: {r['kernel']}: {r['registers']} registers, "
            f"{r['spill_bytes']} bytes spilled")

    # phase 14's dry run on meta runs beside the phases before it
    dry_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_dryrun_"))
    dry_proc = start_dryrun(dry_dir)
    try:
        return run_phases(args, card, build_s, ptxas, dry_proc, dry_dir)
    finally:
        if dry_proc.poll() is None:
            dry_proc.kill()
            dry_proc.wait()
        shutil.rmtree(dry_dir, ignore_errors=True)


def run_phases(args, card, build_s, ptxas, dry_proc, dry_dir) -> int:
    """Phases 3-18, then the result lines."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    log_phase("3: kernels")
    kern_rows = kernel_phase(args.seed)
    merge_res = merge_phase(args.seed)
    bd_rows = bd_kernel_phase(args.seed)
    torch.cuda.empty_cache()
    log_phase("3b: MoE layer")
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

    log_phase("4-7: SDAR-8B")
    cfg = get_config("sdar-8b")
    model, params = draw(cfg)
    pool = make_pool(model, args.seed)
    model_res = model_phase(model, params, pool, args.seed)
    profile_res = profile_phase(model, params, pool, args.seed)
    prefill_res = prefill_model_phase(model, params, pool, args.seed)
    del pool
    torch.cuda.empty_cache()

    # phase 7 (and 7b, 7c) captured, each run held to its eager twin
    runs = [serve_twins(model, params, "elastic", lambda: elastic_reqs(cfg),
                        max_len=1024)]
    torch.cuda.empty_cache()
    runs.append(serve_twins(model, params, "ar", lambda: make_requests(
        cfg, args.seed + 1, 4, (128, 256), (16, 32)), max_len=512))
    torch.cuda.empty_cache()
    runs.append(serve_twins(model, params, "wave", lambda: elastic_reqs(cfg),
                            max_len=1024))
    wave_vs_chunked = {"sdar-8b": compare_runs(runs[2], runs[0])}
    torch.cuda.empty_cache()
    log_phase("7b: SDAR-8B cluster")
    cluster_res = cluster_phase(model, params, args.seed, runs[0])
    torch.cuda.empty_cache()
    log_phase("7c: SDAR-8B sharded page pool")
    split_res = split_phase(model, params, args.seed,
                            {"elastic": runs[0], "wave": runs[2]})
    torch.cuda.empty_cache()
    log_phase("15: SDAR-8B captured dispatches")
    graphs_res = graphs_phase(model, params, args.seed)
    graphs_res["serving"] = capture_totals(
        runs + cluster_res["runs"] + [cluster_res["drill"]]
        + split_res["runs"])
    torch.cuda.empty_cache()
    log_phase("17 (ii): SDAR-8B page moves captured")
    jit_res = {"pool": pool_graphs_phase(model, params, args.seed)}
    del model, params
    free("sdar-8b")

    log_phase("8: Llama-4 Scout")
    # Llama-4 Scout at full width, MOE_LAYERS deep (the card's 80 GB)
    cfg = get_config(MOE_ARCH).replace(n_layers=MOE_LAYERS)
    model, params = draw(cfg)
    pool = make_pool(model, args.seed)
    moe_model_res = moe_model_phase(model, params, pool, args.seed)
    del pool
    torch.cuda.empty_cache()
    runs.append(serve_run(model, params, "elastic", elastic_reqs(cfg),
                          max_len=1024))
    torch.cuda.empty_cache()
    log_phase("8b: Llama-4 Scout expert-parallel")
    t0 = time.perf_counter()
    ep_res = {"block": ep_block_level(cfg, params, args.seed, moe_rows),
              "model": ep_model_level(model, params, args.seed,
                                      moe_model_res)}
    layer0 = ep_layer_params(params)
    del model, params
    free(cfg.name)
    workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_ep_"))
    try:
        ep_res["train"] = ep_train_level(
            cfg.replace(n_layers=1, capacity_factor=0.0), layer0, args.seed,
            workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    del layer0
    free(f"{cfg.name} 1-layer training")
    ep_res["wall_s"] = time.perf_counter() - t0
    log(f"phase 8b: {ep_res['wall_s']:.3f} s wall")

    log_phase("9: Qwen2-VL-2B")
    # Qwen2-VL-2B at full width and depth, text only
    cfg = get_config("qwen2-vl-2b")
    model, params = draw(cfg)
    runs.append(serve_run(model, params, "elastic", elastic_reqs(cfg),
                          max_len=1024))
    torch.cuda.empty_cache()
    # eager: its logit gaps are the readings of compare_runs
    runs.append(serve_run(model, params, "wave", elastic_reqs(cfg),
                          max_len=1024, graphs=False))
    wave_vs_chunked[cfg.name] = compare_runs(runs[-1], runs[-2])
    del model, params
    free(cfg.name)
    for r in runs:
        del r["outputs"], r["gaps"], r["steps"]

    log_phase("10: RWKV6-1.6B")
    # RWKV6-1.6B at full width and depth (the ssm family, AR)
    cfg = get_config(SSM_ARCH)
    model, params = draw(cfg)
    ssm_res = ssm_phase(model, params, args.seed)
    torch.cuda.empty_cache()
    log_phase("16: RWKV6-1.6B, the slot path captured")
    slot_res = {cfg.name: slot_graphs_phase(model, params, args.seed)}
    runs.append(serve_recurrent_twins(model, params,
                                      lambda: elastic_reqs(cfg)))
    del model, params
    free(cfg.name)

    log_phase("11: Jamba")
    # Jamba at full width, one period with 10 experts (the hybrid family)
    cfg = get_config(HYBRID_ARCH).replace(**HYBRID_CUTS)
    log(f"{cfg.name}: full width (d_model {cfg.d_model}, {cfg.n_heads}/"
        f"{cfg.n_kv_heads} heads, d_ff {cfg.d_ff}), cut to {cfg.n_layers} "
        f"of 72 layers (one period) and {cfg.n_experts} of 16 experts: the "
        f"card's 80 GB")
    model, params = draw(cfg)
    log_phase("16: Jamba, the slot path captured")
    runs.append(serve_recurrent_twins(model, params,
                                      lambda: elastic_reqs(cfg)))
    slot_res[cfg.name] = slot_graphs_phase(model, params, args.seed)
    hybrid_res = hybrid_phase(model, params, args.seed)
    del model, params
    free(cfg.name)

    log_phase("12: training")
    # phase 12: training on the card (SDAR-8B-4L, the launcher, encdec)
    workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    try:
        train_res = train_phase(args.seed, workdir)
        free(f"{TRAIN_ARCH} training")
        log_phase("17 (i): the train step captured")
        jit_res["train"] = train_graphs_phase(args.seed, workdir, train_res)
        free(f"{TRAIN_ARCH} captured training")
        launcher_res = launcher_phase(workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    cfg = get_config(ENCDEC_ARCH)
    model, params = draw(cfg)
    enc_train_res = encdec_train_phase(model, params, args.seed)
    del model, params
    free(f"{cfg.name} training")

    log_phase("13: SeamlessM4T decoding")
    # phase 13: SeamlessM4T-large-v2 decoding at full width and depth
    model, params = draw(cfg)
    encdec_res = encdec_phase(model, params, args.seed)
    del model, params
    free(cfg.name)

    log_phase("14: analysis")
    t14 = time.perf_counter()
    analysis_res = {"cli": analysis_cli_phase()}
    cfg = get_config("sdar-8b")
    model, params = draw(cfg)
    analysis_res["model"] = analysis_model_phase(model, params)
    del model, params
    free("sdar-8b")
    analysis_res["dryrun"] = dryrun_phase(dry_proc, dry_dir, args.seed)
    analysis_res["wall_s"] = time.perf_counter() - t14
    log(f"phase 14: {analysis_res['wall_s']:.3f} s wall")
    a_model = analysis_res["model"]

    log_phase("18: the examples")
    examples_res = examples_phase()

    log_phase("done")
    cluster_runs = cluster_res["runs"] + [cluster_res["drill"]]
    split_runs = split_res["runs"]
    twins = [r["eager"] for r in runs + cluster_runs + split_runs
             if "eager" in r]
    slot_rows = list(slot_res.values())
    head = kern_rows[0]
    kernels = [{
        "name": "paged_chunk_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/chunked_paged_attn.cu",
        "replaces": "src/repro/kernels/chunked_paged_attn.py:85",
        "launches": sum(r["kernel_launches"]
                        for r in runs + cluster_runs + split_runs)
        + encdec_res["kernel_launches"] + ep_res["model"]["kernel_launches"]
        + a_model["kernel_launches"] + graphs_res["kernel_launches"]
        + sum(r["kernel_launches"] for r in twins + slot_rows)
        + examples_res["kernel_launches"],
        "merge_launches": sum(r["merge_launches"]
                              for r in runs + cluster_runs + split_runs
                              + twins + slot_rows)
        + encdec_res["merge_launches"] + ep_res["model"]["merge_launches"]
        + a_model["merge_launches"] + graphs_res["merge_launches"]
        + examples_res["merge_launches"],
        "launches_by_site": {"serving runs": sum(r["kernel_launches"]
                                                 for r in runs),
                             "cluster runs": sum(r["kernel_launches"]
                                                 for r in cluster_runs),
                             "sharded pool runs": sum(
                                 r["kernel_launches"] for r in split_runs),
                             "expert-parallel runs":
                                 ep_res["model"]["kernel_launches"],
                             "encdec decoder reads":
                                 encdec_res["kernel_launches"],
                             "analysis (phase 14)":
                                 a_model["kernel_launches"],
                             "captured dispatches (phase 15)":
                                 graphs_res["kernel_launches"],
                             "captured slot dispatches (phase 16 (i))": sum(
                                 r["kernel_launches"] for r in slot_rows),
                             "eager twins (phases 15, 16)": sum(
                                 r["kernel_launches"] for r in twins),
                             "examples (phase 18)":
                                 examples_res["kernel_launches"]},
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
        "launches": sum(r["bd_kernel_launches"]
                        for r in runs + cluster_runs + split_runs + twins
                        + slot_rows)
        + encdec_res["bd_kernel_launches"] + a_model["bd_kernel_launches"]
        + graphs_res["bd_kernel_launches"]
        + examples_res["bd_kernel_launches"],
        "launches_by_site": {"serving runs": sum(r["bd_kernel_launches"]
                                                 for r in runs),
                             "cluster runs": sum(r["bd_kernel_launches"]
                                                 for r in cluster_runs),
                             "sharded pool runs": sum(
                                 r["bd_kernel_launches"] for r in split_runs),
                             "encdec encoder":
                                 encdec_res["bd_kernel_launches"],
                             "analysis (phase 14)":
                                 a_model["bd_kernel_launches"],
                             "captured dispatches (phase 15)":
                                 graphs_res["bd_kernel_launches"],
                             "captured slot dispatches (phase 16 (i))": sum(
                                 r["bd_kernel_launches"] for r in slot_rows),
                             "eager twins (phases 15, 16)": sum(
                                 r["bd_kernel_launches"] for r in twins),
                             "examples (phase 18)":
                                 examples_res["bd_kernel_launches"]},
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
             "expert_parallel": ep_res,
             "cluster": cluster_res, "split_kv": split_res,
             "ssm": ssm_res, "hybrid": hybrid_res, "serve": runs,
             "wave_vs_chunked": wave_vs_chunked, "train": train_res,
             "launcher": launcher_res, "encdec_train": enc_train_res,
             "encdec": encdec_res, "analysis": analysis_res,
             "graphs": graphs_res, "slot_graphs": slot_res,
             "jit_graphs": jit_res, "examples": examples_res}, indent=1))
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
