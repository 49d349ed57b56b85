#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed N] [--out results.json]

Phases, in order (any failed check raises and the script exits non-zero):

1. the card's name and power limit (nvidia-smi); TF32 off;
2. build every CUDA kernel of the port from ``src/repro_torch/kernels/csrc``
   with nvcc for sm_90a (one compile per source, all at once);
3. kernel phase: each kernel's wrapper on CUDA tensors against its plain
   PyTorch version on the same inputs, at the serving path's shapes, with
   times (CUDA events) under both row tilings and the card's least time for
   the same work;
4. model phase: one ``decode_step_paged`` dispatch of SDAR-8B at full width
   and depth in bf16, through the kernel and through the plain version, on
   the same weights and pool, held at limits that a control run (the
   kernel's acc skewed by ``CONTROL_SKEW``) must break;
5. profile phase: the same dispatch at B 8, c 32 with every context at 512
   and at 2048 tokens, timed through the kernel and the plain version, and
   split by kernel with ``torch.profiler``: the device's busy share of the
   wall time and the paged kernel's share of the device time;
6. serving phase (the main path): SDAR-8B (36 layers, d_model 4096, bf16,
   seeded random weights drawn on the card) served by the paged
   ``ModelBackend`` through ``ServingEngine`` — an elastic run of 8
   requests and a shorter AR run — with the kernels' launch counts set to 0
   before each run and read after it.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Without CUDA, or without the repository
beside this file, it prints no result and exits non-zero.
"""

from __future__ import annotations

import argparse
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

KERNEL_SHAPES = [
    # name, B, c, H, KVH, D, ps, dtype, ctx_lens
    ("a_decode_sdar8b", 8, 32, 32, 8, 128, 16, "bfloat16",
     [0, 1, 15, 16, 17, 2048, 700, 1333]),
    ("a_decode_sdar8b_ctx2048", 8, 32, 32, 8, 128, 16, "bfloat16",
     [2048] * 8),
    ("b_ar_sdar8b", 8, 1, 32, 8, 128, 16, "bfloat16",
     [0, 1, 15, 16, 17, 2048, 700, 1333]),
    ("c_prefill_chunk", 2, 256, 32, 8, 128, 16, "bfloat16", [0, 768]),
    ("d_fp32_d64", 4, 8, 8, 2, 64, 16, "float32", [0, 33, 100, 300]),
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


def kernel_phase(seed: int) -> list[dict]:
    import numpy as np
    import torch

    from repro_torch.kernels import chunked_paged_attn as cpa

    rows = []
    for name, B, c, H, KVH, D, ps, dtype, ctx in KERNEL_SHAPES:
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
        args = (q, kp, vp, tables, lens)
        acc_r, m_r, l_r = cpa.paged_chunk_ref(*args)
        tol = BF16_TOL if dtype == "bfloat16" else FP32_TOL
        err = rel = 0.0
        for rpw in (0, 1, 8):   # the tiling the wrapper picks, then each
            acc, m, l = cpa.paged_chunk_attention_kernel(
                *args, rows_per_warp=rpw)
            torch.cuda.synchronize()
            e = float((acc - acc_r).abs().max())
            r = e / (float(acc_r.abs().max()) + 1e-9)
            torch.testing.assert_close(m, m_r, rtol=1e-5, atol=1e-4)
            torch.testing.assert_close(l, l_r, rtol=tol, atol=1e-5)
            if not r < tol:
                raise AssertionError(f"{name} (rows per warp {rpw}): acc max "
                                     f"relative error {r} >= {tol}")
            for i in [i for i, x in enumerate(ctx) if x == 0]:
                if not (torch.all(acc[i] == 0) and torch.all(l[i] == 0)
                        and torch.all(m[i] == -1e30)):
                    raise AssertionError(f"{name}: ctx-0 row {i} is not the "
                                         f"empty partial")
            err, rel = max(err, e), max(rel, r)
        ms = time_ms(lambda: cpa.paged_chunk_attention_kernel(*args))
        by_rpw = {rpw: time_ms(lambda: cpa.paged_chunk_attention_kernel(
            *args, rows_per_warp=rpw)) for rpw in (1, 8)}
        plain_ms = time_ms(lambda: cpa.paged_chunk_ref(*args))
        b_ms, b_by = bound(B, c, H, KVH, D, ps, dtype, ctx)
        picked = 1 if (H // KVH) * c <= 8 else 8
        row = {"shape": name, "B": B, "c": c, "H": H, "KVH": KVH, "D": D,
               "page_size": ps, "dtype": dtype, "ctx_lens": ctx,
               "max_abs_err": err, "max_rel_err": rel, "ms": ms,
               "rows_per_warp": picked, "ms_rows_per_warp_1": by_rpw[1],
               "ms_rows_per_warp_8": by_rpw[8],
               "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by}
        rows.append(row)
        log(f"kernel {name}: max_abs_err {err:.3e} rel {rel:.3e} | kernel "
            f"{ms:.4f} ms (rows per warp {picked}; forced 1: "
            f"{by_rpw[1]:.4f} ms, forced 8: {by_rpw[8]:.4f} ms)  plain "
            f"{plain_ms:.4f} ms  bound {b_ms:.4f} ms ({b_by})")
        del q, kp, vp, acc, m, l, acc_r, m_r, l_r
    return rows


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


def model_phase(model, params, pool, seed: int) -> dict:
    import torch

    import repro_torch.models.transformer as tfm
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
    torch.cuda.synchronize()

    lr_std = float(lr.std())

    def readings(conf, tok, logits):
        return {"logits_rel": float((logits - lr).abs().max()) / lr_std,
                "tokens_differ_share": float((tok != tr).float().mean()),
                "conf_rel": float(((conf - cr).abs() / cr).max())}

    sound, ctl = readings(*kernel), readings(*control)
    ck, tk, lk = kernel
    top2 = lr.topk(2, dim=-1).values
    gap = top2[..., 0] - top2[..., 1]
    tol = BF16_TOL * top2[..., 0].abs().clamp(min=1.0)
    diff = tk != tr
    n_diff = int(diff.sum())
    # tokens may differ only where the plain path's top-1/top-2 gap is
    # under the bf16 tolerance; the margin is the least (tolerance - gap)
    margin = float((tol - gap)[diff].min()) if n_diff else None
    res = {"B": MODEL_B, "c": MODEL_C, "ctx_lens": MODEL_CTX,
           "tokens": tk.numel(), "tokens_differ": n_diff,
           "max_gap_where_differ": float(gap[diff].max()) if n_diff else 0.0,
           "min_gap": float(gap.min()), "gap_margin": margin,
           "logits_std_plain": lr_std,
           "logits_max_abs_err": float((lk - lr).abs().max()),
           "conf_max_abs_err": float((ck - cr).abs().max()),
           "conf_plain_max": float(cr.max()), "kernel_vs_plain": sound,
           "control_skew": CONTROL_SKEW, "control_vs_plain": ctl,
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
            f"{1 + CONTROL_SKEW}) {ctl[key]:.4f}  limit {lim}")
    if n_diff and not margin > 0:
        raise AssertionError("model: a token differs where its top-1/top-2 "
                             "logit gap exceeds the bf16 tolerance")
    for key, lim in MODEL_LIMITS.items():
        if not sound[key] < lim:
            raise AssertionError(f"model: kernel path {key} {sound[key]} >= "
                                 f"{lim}")
        if key in CONTROL_BREAKS and not ctl[key] >= lim:
            raise AssertionError(f"model: the control run's {key} "
                                 f"{ctl[key]} stays under {lim}, so this "
                                 f"limit cannot see a {CONTROL_SKEW:.0%} "
                                 f"error")
    return res


# ---------------------------------------------------------------------------
# profile phase
# ---------------------------------------------------------------------------

def profile_phase(model, params, pool, seed: int) -> list[dict]:
    """Where one decode dispatch's time goes: wall per dispatch (host clock
    around ``torch.cuda.synchronize``) through the kernel and the plain
    version, then ``torch.profiler`` over 3 kernel-path dispatches."""
    import torch

    cache, tables = pool
    out = []
    for ctx in PROFILE_CTX:
        win, start, valid, n_adv = decode_inputs(model, [ctx] * MODEL_B, seed)

        def dispatch(impl):
            conf, tok, _ = model.decode_step_paged(
                params, cache, win, start, valid, tables, start, n_adv,
                impl=impl)
            return conf.cpu(), tok.cpu()

        def wall_ms(impl, iters=5):
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
        n = 3
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
        paged = sum(t for k, t, _ in kern if "paged_chunk_attn" in k)
        row = {"B": MODEL_B, "c": MODEL_C, "ctx": ctx,
               "wall_ms_kernel": walls["kernel"], "wall_ms_plain": walls["ref"],
               "profiled_dispatches": n,
               "wall_ms_profiled": wall_us / n / 1e3,
               "device_ms_per_dispatch": busy / n / 1e3,
               "device_busy_share": busy / wall_us,
               "paged_kernel_ms_per_dispatch": paged / n / 1e3,
               "paged_kernel_share_of_device": paged / max(busy, 1e-9),
               "device_kernels_per_dispatch": sum(c for *_, c in kern) / n,
               "top": [{"name": k[:90], "ms_per_dispatch": t / n / 1e3,
                        "calls_per_dispatch": c / n}
                       for k, t, c in kern[:8]]}
        if not paged > 0:
            raise AssertionError(f"profile ctx {ctx}: the paged kernel shows "
                                 f"no device time")
        out.append(row)
        log(f"profile ctx {ctx} (B {MODEL_B}, c {MODEL_C}): wall ms kernel "
            f"{walls['kernel'][0]:.2f}, {walls['kernel'][1]:.2f}, plain "
            f"{walls['ref'][0]:.2f}; profiled wall "
            f"{row['wall_ms_profiled']:.2f} ms, device "
            f"{row['device_ms_per_dispatch']:.2f} ms (busy share "
            f"{row['device_busy_share']:.3f}) in "
            f"{row['device_kernels_per_dispatch']:.0f} kernels; paged kernel "
            f"{row['paged_kernel_ms_per_dispatch']:.3f} ms (share of device "
            f"{row['paged_kernel_share_of_device']:.3f})")
        for r in row["top"]:
            log(f"  {r['ms_per_dispatch']:8.3f} ms {r['calls_per_dispatch']:6.1f}x"
                f"  {r['name']}")
    return out


# ---------------------------------------------------------------------------
# serving phase (the main path)
# ---------------------------------------------------------------------------

def serve_run(model, params, mode: str, reqs, max_len: int) -> dict:
    import torch

    from repro_torch.core.latency_model import CPU_HOST, AnalyticDeviceModel
    from repro_torch.core.scheduler import ElasticScheduler, FixedScheduler
    from repro_torch.kernels import chunked_paged_attn as cpa
    from repro_torch.serving import DATASETS, ModelBackend, ServingEngine

    cfg = model.cfg
    be = ModelBackend(model, params, n_slots=8, max_len=max_len,
                      decode_mode="ar" if mode == "ar" else "elastic",
                      cache_dtype=torch.bfloat16, device=DEVICE)
    if mode == "elastic":       # as launch/serve.py builds it
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

    model.decode_step_paged = record("decode", type(model).decode_step_paged
                                     .__get__(model))
    model.prefill_chunk_paged = record("prefill", type(model)
                                       .prefill_chunk_paged.__get__(model))
    outs = {}
    release = be.release

    def spy(rid):
        outs[rid] = be.state(rid).output_tokens
        release(rid)

    be.release = spy
    ptrs = (be.kv.k_pages.data_ptr(), be.kv.v_pages.data_ptr())
    eng = ServingEngine(be, sched, max_batch=8)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cpa.LAUNCHES = 0
    t0 = time.perf_counter()
    rep = eng.run(list(reqs))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = cpa.LAUNCHES
    del model.decode_step_paged, model.prefill_chunk_paged

    n_dec, n_pre = be.decode_dispatches, be.prefill_dispatches
    tokens = sum(len(v) for v in outs.values())
    dec_bytes = sum(8 * b * c for b, c in shapes["decode"])
    pre_bytes = sum(8 * b for b, _ in shapes["prefill"])
    res = {"mode": mode, "requests": len(rep.metrics),
           "tokens_committed": tokens, "decode_dispatches": n_dec,
           "prefill_dispatches": n_pre, "kernel_launches": launches,
           "host_bytes_per_decode_dispatch": dec_bytes / max(n_dec, 1),
           "wall_s": wall, "tok_per_s": tokens / wall,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "chunks": sorted({c for _, c in shapes["decode"]}),
           "batches": sorted({b for b, _ in shapes["decode"]})}
    log(f"serve {mode}: {res['requests']} requests finished, {tokens} "
        f"tokens committed, {n_dec} decode + {n_pre} prefill dispatches, "
        f"{launches} kernel launches, {res['host_bytes_per_decode_dispatch']:.1f}"
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
        (launches == cfg.n_layers * (n_dec + n_pre),
         f"{launches} kernel launches != {cfg.n_layers} x {n_dec + n_pre} "
         f"dispatches"),
        (be.host_transfer_bytes == dec_bytes + pre_bytes,
         "host bytes != 8·Bp·c per decode + 8·Bp per prefill dispatch"),
        ((be.kv.k_pages.data_ptr(), be.kv.v_pages.data_ptr()) == ptrs,
         "the page pool moved"),
        (be.kv.free_pages == be.kv.n_pages, "pages leaked"),
    ]
    for ok, msg in checks:
        if not ok:
            raise AssertionError(f"serve {mode}: {msg}")
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

    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models import build_model

    t0 = time.perf_counter()
    libs = build.build(build.all_sources())
    build_s = time.perf_counter() - t0
    log(f"built {sorted(libs)} in {build_s:.2f} s")
    for path in libs.values():
        for line in Path(str(path) + ".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")

    kern_rows = kernel_phase(args.seed)

    cfg = get_config("sdar-8b")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init_params(
        torch.Generator(device=DEVICE).manual_seed(args.seed), device=DEVICE)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in params.values())
    log(f"sdar-8b params: {n_params} ({cfg.param_dtype}) drawn on the card "
        f"in {time.perf_counter() - t0:.2f} s")
    pool = make_pool(model, args.seed)
    model_res = model_phase(model, params, pool, args.seed)
    profile_res = profile_phase(model, params, pool, args.seed)
    del pool
    torch.cuda.empty_cache()

    runs = [serve_run(model, params, "elastic",
                      make_requests(cfg, args.seed, 8, (128, 512), (64, 128)),
                      max_len=1024)]
    torch.cuda.empty_cache()
    runs.append(serve_run(model, params, "ar",
                          make_requests(cfg, args.seed + 1, 4, (128, 256),
                                        (16, 32)), max_len=512))

    head = kern_rows[0]
    kernels = [{
        "name": "paged_chunk_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/chunked_paged_attn.cu",
        "replaces": "src/repro/kernels/chunked_paged_attn.py:85",
        "launches": sum(r["kernel_launches"] for r in runs),
        "max_abs_err": max(r["max_abs_err"] for r in kern_rows),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": None,
        "shape": head["shape"],
        "shapes": kern_rows,
    }]
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"card": card, "build_s": build_s, "kernels": kernels,
             "model": model_res, "profile": profile_res, "serve": runs},
            indent=1))
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
