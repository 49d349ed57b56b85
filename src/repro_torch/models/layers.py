"""Core neural-net layers: RMSNorm, RoPE, GQA attention partials, gated MLP.

Plain functions on tensors; parameters come from the flat param dict
(one layer's slice, keyed by the name under ``mixer/`` or ``ffn/``).  The
math, dtypes and rounding points follow the JAX package's layers exactly,
so the same inputs give the same outputs within float error.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.common import ArchConfig, dense_init

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Normalization
# ---------------------------------------------------------------------------

def rms_norm(x, scale, eps: float):
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def init_norm(gen, cfg: ArchConfig, device, n: int | None = None):
    """Unit scales, ``[n, d_model]`` for a layer stack or ``[d_model]``."""
    shape = (cfg.d_model,) if n is None else (n, cfg.d_model)
    if torch.device(device).type == "meta":
        return {"scale": torch.empty(shape, dtype=cfg.pdt, device="meta")}
    return {"scale": torch.ones(shape, dtype=cfg.pdt, device=device)}


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def _rope_angles(positions, dim: int, theta: float):
    """positions [..., T] → cos/sin [..., T, dim//2] (float32); ``inv`` is
    the JAX package's float32 numpy vector, so the angles match bitwise."""
    inv = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float32) / dim))
    inv = torch.from_numpy(np.asarray(inv, np.float32)).to(positions.device)
    ang = positions[..., None].float() * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, positions, theta: float):
    """x [B, T, H, D], positions [B, T] → x rotated by split halves (the
    first D/2 dims pair with the last D/2, not interleaved pairs)."""
    d = x.shape[-1]
    cos, sin = _rope_angles(positions, d, theta)          # [B, T, d/2]
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def rope_for(cfg: ArchConfig, x, positions):
    if cfg.mrope_sections:
        raise NotImplementedError("M-RoPE (vlm family) is not ported yet")
    return apply_rope(x, positions, cfg.rope_theta)


# ---------------------------------------------------------------------------
# Attention masks
# ---------------------------------------------------------------------------

def causal_mask(q_pos, k_pos):
    """bool[..., Tq, Tk]: k may be attended iff k_pos <= q_pos."""
    return k_pos[..., None, :] <= q_pos[..., :, None]


def block_causal_mask(q_pos, k_pos, block_size: int):
    """Block-diffusion mask: bidirectional within a block, causal across.
    Allowed iff block(k) <= block(q)."""
    qb = torch.div(q_pos, block_size, rounding_mode="floor")
    kb = torch.div(k_pos, block_size, rounding_mode="floor")
    return kb[..., None, :] <= qb[..., :, None]


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------

def init_attention(gen, cfg: ArchConfig, device, n: int):
    d, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    pd = cfg.pdt
    return {
        "wq": dense_init(gen, (n, d, h * hd), pd, device, fan_in=d),
        "wk": dense_init(gen, (n, d, kvh * hd), pd, device, fan_in=d),
        "wv": dense_init(gen, (n, d, kvh * hd), pd, device, fan_in=d),
        "wo": dense_init(gen, (n, h * hd, d), pd, device, fan_in=h * hd),
    }


def qkv_project(p, cfg: ArchConfig, x, positions):
    """x [B,T,d] → q [B,T,H,D], k/v [B,T,KVH,D], RoPE applied to q and k."""
    B, T, _ = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    cd = cfg.cdt
    q = (x @ p["wq"].to(cd)).reshape(B, T, h, hd)
    k = (x @ p["wk"].to(cd)).reshape(B, T, kvh, hd)
    v = (x @ p["wv"].to(cd)).reshape(B, T, kvh, hd)
    q = rope_for(cfg, q, positions)
    k = rope_for(cfg, k, positions)
    return q, k, v


def sdpa_partial(q, k, v, mask, *, scale: float | None = None):
    """Unnormalized flash-style partial attention.

    Returns ``(acc, m, l)`` with ``acc = Σ_j e^{logit_j - m} v_j``,
    ``m = max_j logit_j`` and ``l = Σ_j e^{logit_j - m}``.  Shapes: q
    [B,T,H,D], k/v [B,S,KVH,D], mask bool[B,1,T,S]; acc [B,T,H,D], m/l
    [B,T,H] (fp32).  Products accumulate in fp32 (the JAX
    ``preferred_element_type``), and ``e`` is rounded to v's dtype before PV.
    """
    B, T, H, D = q.shape
    KVH = k.shape[2]
    G = H // KVH
    scale = scale if scale is not None else 1.0 / np.sqrt(D)
    qg = q.reshape(B, T, KVH, G, D)
    logits = torch.einsum("btkgd,bskd->bkgts", qg.float(), k.float()) * scale
    msk = mask[:, :, None, :, :]
    logits = torch.where(msk, logits, NEG_INF)
    m = logits.amax(dim=-1)                                  # [B,KVH,G,T]
    e = torch.exp(logits - m[..., None])
    e = torch.where(msk, e, 0.0)
    l = e.sum(dim=-1)
    acc = torch.einsum("bkgts,bskd->btkgd", e.to(v.dtype).float(), v.float())
    acc = acc.reshape(B, T, H, D)
    m = m.permute(0, 3, 1, 2).reshape(B, T, H)
    l = l.permute(0, 3, 1, 2).reshape(B, T, H)
    return acc, m, l


def combine_partials(parts, out_dtype):
    """Combine flash partials [(acc, m, l), ...] into normalized output
    (shared implementation: :func:`repro_torch.kernels.ops.combine_flash_partials`)."""
    from repro_torch.kernels.ops import combine_flash_partials
    return combine_flash_partials(parts, out_dtype=out_dtype)


def attn_output(p, cfg: ArchConfig, out):
    B, T = out.shape[:2]
    return out.reshape(B, T, -1) @ p["wo"].to(cfg.cdt)


# ---------------------------------------------------------------------------
# Gated MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------

def _act(name: str):
    # jax.nn.gelu defaults to the tanh approximation
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh")}[name]


def init_mlp(gen, cfg: ArchConfig, device, n: int):
    d, f = cfg.d_model, cfg.d_ff
    pd = cfg.pdt
    out = {
        "w_up": dense_init(gen, (n, d, f), pd, device, fan_in=d),
        "w_down": dense_init(gen, (n, f, d), pd, device, fan_in=f),
    }
    if cfg.gated_mlp:
        out["w_gate"] = dense_init(gen, (n, d, f), pd, device, fan_in=d)
    return out


def mlp_block(p, cfg: ArchConfig, x):
    cd = cfg.cdt
    u = x @ p["w_up"].to(cd)
    if cfg.gated_mlp:
        h = _act(cfg.act)(x @ p["w_gate"].to(cd)) * u
    else:
        h = _act(cfg.act)(u)
    return h @ p["w_down"].to(cd)
