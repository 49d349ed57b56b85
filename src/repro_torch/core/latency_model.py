"""Latency modeling (paper §5.2).

Two models:

* :class:`AnalyticDeviceModel` — first-principles roofline latency for a
  (model config, device) pair: ``overhead + max(compute, memory)`` where the
  memory term reads the active weights once per step plus the per-request KV;
  this is the ground truth for the virtual-clock serving simulator and
  naturally produces the paper's three regimes (weight-read-bound plateau,
  transition, compute-bound linear growth in ``b·c``).

* :class:`PiecewiseAffineLatencyModel` — the paper's runtime estimator: a
  3-segment piecewise-affine fit over ``bc`` obtained from (offline)
  profiling samples, used by the elastic scheduler at serving time.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np

from repro_torch.models.common import ArchConfig


@dataclass(frozen=True)
class DeviceSpec:
    name: str
    peak_flops: float          # FLOP/s (bf16 / fp16 tensor)
    hbm_bw: float              # bytes/s
    link_bw: float             # bytes/s per ICI/NVLink link
    overhead_s: float          # fixed per-step launch/dispatch overhead
    hbm_bytes: float
    host_bw: float = 16e9      # host<->device bytes/s (PCIe/DMA proxy)


TPU_V5E = DeviceSpec("tpu-v5e", 197e12, 819e9, 50e9, 25e-6, 16 * 2**30)
A100_80G = DeviceSpec("a100-80g", 312e12, 2.0e12, 300e9, 40e-6, 80 * 2**30,
                      host_bw=25e9)
CPU_HOST = DeviceSpec("cpu-host", 1e11, 3e10, 1e10, 1e-4, 32 * 2**30,
                      host_bw=3e10)
# H100 SXM5 datasheet: 989 TFLOP/s dense bf16, 3.35 TB/s HBM3, 80 GiB.  The
# NVLink rate, the host (PCIe 5 x16) rate and the per-step overhead are
# placeholders until a latency model is fitted from steps measured on the
# card (PiecewiseAffineLatencyModel.fit with profile_wall_clock).
H100_SXM = DeviceSpec("h100-sxm", 989e12, 3.35e12, 450e9, 40e-6, 80 * 2**30,
                      host_bw=64e9)

DEVICES = {d.name: d for d in (TPU_V5E, A100_80G, CPU_HOST, H100_SXM)}


# ---------------------------------------------------------------------------
# Analytic workload model
# ---------------------------------------------------------------------------

def active_param_count(cfg: ArchConfig) -> float:
    """Matmul-visible parameters touched per token (MoE counts top_k experts
    + router; embeddings excluded from FC FLOPs, lm_head included)."""
    d, hd = cfg.d_model, cfg.hd
    attn = 2 * d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd
    n_mats = 3 if cfg.gated_mlp else 2
    mlp_dense = n_mats * d * cfg.d_ff
    moe_active = 3 * d * cfg.moe_ff * max(cfg.top_k, 1) + d * cfg.n_experts
    n = 0.0
    for i in range(cfg.n_layers):
        if cfg.family == "ssm":
            di = cfg.d_model  # rwkv time-mix ≈ 5 d² (+ lora) + channel-mix
            n += 5 * d * d + 2 * d * cfg.rwkv_lora_rank + 2 * d * cfg.d_ff + d * d
            continue
        if cfg.is_attn_layer(i):
            n += attn
        else:  # mamba mixer
            di = cfg.mamba_expand * d
            dtr = max(1, int(np.ceil(d / 16)))
            n += 2 * d * di + di * (dtr + 2 * cfg.d_state) + dtr * di + di * d
        n += moe_active if cfg.is_moe_layer(i) else mlp_dense
    n += d * cfg.vocab_size            # lm head
    if cfg.family == "encdec":
        enc = cfg.n_enc_layers * (attn + mlp_dense)
        cross = cfg.n_layers * (2 * d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd)
        n += enc + cross
    return float(n)


def total_param_count(cfg: ArchConfig) -> float:
    """All parameters resident in memory (full expert set + embeddings)."""
    d = cfg.d_model
    n = active_param_count(cfg)
    if cfg.n_experts:
        moe_layers = sum(1 for i in range(cfg.n_layers) if cfg.is_moe_layer(i))
        n += moe_layers * 3 * d * cfg.moe_ff * (cfg.n_experts - max(cfg.top_k, 1))
    n += cfg.vocab_size * d            # embedding table
    return float(n)


def swap_cost_s(n_pages: int, page_bytes: float,
                device: DeviceSpec) -> float:
    """Round-trip host<->device transfer time for ``n_pages`` KV pages.

    The tiered KV pool compares this against the analytic re-prefill
    latency (``AnalyticDeviceModel.step_latency`` over the tokens the
    pages hold) when deciding whether a preemption victim is worth
    spilling to host memory: short prompts are cheaper to recompute,
    long ones cheaper to swap back in."""
    return 2.0 * n_pages * page_bytes / device.host_bw


def kv_bytes_per_token(cfg: ArchConfig, dtype_bytes: int = 2) -> float:
    n_attn = sum(1 for i in range(cfg.n_layers) if cfg.is_attn_layer(i))
    if cfg.family == "ssm":
        return 0.0
    return 2.0 * n_attn * cfg.n_kv_heads * cfg.hd * dtype_bytes


class AnalyticDeviceModel:
    """Roofline latency for one decode step of ``b`` requests × chunk ``c``
    against mean context length ``ctx`` on ``n_chips`` chips."""

    def __init__(self, cfg: ArchConfig, device: DeviceSpec = TPU_V5E,
                 n_chips: int = 1, dtype_bytes: int = 2):
        self.cfg = cfg
        self.device = device
        self.n_chips = n_chips
        self.dtype_bytes = dtype_bytes
        self._active = active_param_count(cfg)
        self._total = total_param_count(cfg)
        self._kv_tok = kv_bytes_per_token(cfg, dtype_bytes)

    def step_latency(self, b: int, c: int, ctx: float = 1024.0) -> float:
        dev, cfg = self.device, self.cfg
        tokens = b * c
        # FC compute: 2 FLOPs per active param per token
        flops = 2.0 * self._active * tokens
        # attention compute over context: 2·(QK + PV) per layer
        n_attn = sum(1 for i in range(cfg.n_layers) if cfg.is_attn_layer(i))
        flops += 4.0 * n_attn * cfg.n_heads * cfg.hd * (ctx + c) * tokens
        compute_t = flops / (dev.peak_flops * self.n_chips)
        # memory: weights streamed once per step + per-request KV read
        bytes_w = self._total * self.dtype_bytes
        bytes_kv = b * (ctx + c) * self._kv_tok
        bytes_act = 2.0 * tokens * cfg.d_model * self.dtype_bytes * cfg.n_layers
        mem_t = (bytes_w + bytes_kv + bytes_act) / (dev.hbm_bw * self.n_chips)
        return dev.overhead_s + max(compute_t, mem_t)

    def saturation_ew(self, ctx: float = 1024.0) -> float:
        """Effective workload b·c at which compute overtakes memory (the
        saturation point; ≈512 for the paper's A100/8B setup)."""
        lo, hi = 1.0, 1e6
        for _ in range(60):
            mid = (lo + hi) / 2
            if self._compute_t(mid, ctx) >= self._mem_t(mid, ctx):
                hi = mid
            else:
                lo = mid
        return (lo + hi) / 2

    def _compute_t(self, tokens, ctx):
        cfg = self.cfg
        n_attn = sum(1 for i in range(cfg.n_layers) if cfg.is_attn_layer(i))
        f = 2.0 * self._active * tokens + \
            4.0 * n_attn * cfg.n_heads * cfg.hd * ctx * tokens
        return f / (self.device.peak_flops * self.n_chips)

    def _mem_t(self, tokens, ctx):
        bw = self._total * self.dtype_bytes + tokens / 8 * ctx * self._kv_tok
        return bw / (self.device.hbm_bw * self.n_chips)


# ---------------------------------------------------------------------------
# The paper's piecewise-affine estimator
# ---------------------------------------------------------------------------

class PiecewiseAffineLatencyModel:
    """T(bc) ≈ β1^(k)·bc + β0^(k) over 3 regimes fitted from profiling."""

    def __init__(self, breakpoints, coefs):
        self.breakpoints = tuple(breakpoints)      # (b1, b2)
        self.coefs = tuple(tuple(c) for c in coefs)  # 3 × (slope, intercept)

    def predict(self, b: int, c: int) -> float:
        return self.predict_bc(b * c)

    def predict_bc(self, bc: float) -> float:
        b1, b2 = self.breakpoints
        k = 0 if bc <= b1 else (1 if bc <= b2 else 2)
        s, i = self.coefs[k]
        return max(s * bc + i, 1e-9)

    # ------------------------------------------------------------------
    @staticmethod
    def _ls(x, y):
        if len(x) == 0:
            return 0.0, 0.0, 0.0
        if len(x) == 1 or np.ptp(x) == 0:
            return 0.0, float(np.mean(y)), float(np.sum((y - np.mean(y)) ** 2))
        A = np.stack([x, np.ones_like(x)], 1)
        sol, *_ = np.linalg.lstsq(A, y, rcond=None)
        r = y - A @ sol
        return float(sol[0]), float(sol[1]), float(r @ r)

    @classmethod
    def fit(cls, samples):
        """samples: iterable of (b, c, latency_s).  Grid-search the two
        breakpoints over observed bc values, least squares per segment."""
        pts = sorted((b * c, t) for b, c, t in samples)
        x = np.array([p[0] for p in pts], float)
        y = np.array([p[1] for p in pts], float)
        uniq = np.unique(x)
        if len(uniq) < 3:
            s, i, _ = cls._ls(x, y)
            return cls((np.inf, np.inf), ((s, i), (s, i), (s, i)))
        best = None
        for a in range(len(uniq) - 1):
            for b_ in range(a + 1, len(uniq)):
                b1, b2 = uniq[a], uniq[b_]
                m1, m2 = x <= b1, (x > b1) & (x <= b2)
                m3 = x > b2
                if m1.sum() < 1 or m2.sum() < 1 or m3.sum() < 1:
                    continue
                f1 = cls._ls(x[m1], y[m1])
                f2 = cls._ls(x[m2], y[m2])
                f3 = cls._ls(x[m3], y[m3])
                sse = f1[2] + f2[2] + f3[2]
                if best is None or sse < best[0]:
                    best = (sse, (b1, b2), ((f1[0], f1[1]), (f2[0], f2[1]),
                                            (f3[0], f3[1])))
        _, bps, coefs = best
        return cls(bps, coefs)

    @classmethod
    def fit_analytic(cls, analytic: AnalyticDeviceModel, bs=None, cs=None,
                     ctx: float = 1024.0):
        """Profile the analytic device model (offline-profiling stand-in)."""
        bs = bs or [1, 2, 4, 8, 16, 32, 64, 128, 256]
        cs = cs or [2, 4, 8, 16, 32]
        samples = [(b, c, analytic.step_latency(b, c, ctx))
                   for b in bs for c in cs]
        return cls.fit(samples)


def profile_wall_clock(step_fn, bs, cs, *, warmup: int = 1, iters: int = 3):
    """Wall-clock profiling of a jitted chunk step (real-model path)."""
    samples = []
    for b in bs:
        for c in cs:
            for _ in range(warmup):
                step_fn(b, c)
            t0 = time.perf_counter()
            for _ in range(iters):
                step_fn(b, c)
            samples.append((b, c, (time.perf_counter() - t0) / iters))
    return samples
