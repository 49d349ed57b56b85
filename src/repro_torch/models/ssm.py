"""State-space sequence mixers: Mamba (selective SSM, for Jamba) and RWKV6.

The counterpart of the JAX package's ``models/ssm.py``, with the same
protocol, math, dtypes and rounding points:

* ``*_seq(params, cfg, x, state)`` — process ``x [B,T,d]`` given an incoming
  recurrent state, return ``(y [B,T,d], new_state)``.  Used by prefill,
  the diffusion-window recompute (T = chunk size) and AR decode (T = 1).
* fresh states from ``*_init_state(cfg, batch, device=...)``.

The recurrences (:func:`selective_scan`, :func:`wkv_scan`) run as a plain
Python loop over T, sequential and in fp32, as the reference's ``lax.scan``
does (its chunking only bounds training memory under remat and does not
change the forward).  Projections run in the compute dtype; ``dt``, ``A``,
the scan inputs and the ``ssm``/``wkv`` states in fp32; ``conv``,
``tm_prev`` and ``cm_prev`` keep the dtype they are given (the cache's).

Params are one layer's slice of the flat dict (``init_*`` return the
``[n, …]`` stacks the layer stack keys as ``blocks/pos{j}/mixer/…``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.common import ArchConfig, dense_init


def softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` at every x (``F.softplus``
    returns x itself above its threshold of 20, which differs in the last
    bits)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


# ===========================================================================
# Mamba (selective SSM, mamba-1 as used by Jamba)
# ===========================================================================

def mamba_dims(cfg: ArchConfig):
    d_inner = cfg.mamba_expand * cfg.d_model
    dt_rank = max(1, int(np.ceil(cfg.d_model / 16)))
    return d_inner, dt_rank


def init_mamba(gen, cfg: ArchConfig, device, n: int):
    """``n`` stacked Mamba mixers; ``a_log`` is ``log(1..d_state)`` on every
    row, as the reference."""
    d = cfg.d_model
    di, dtr = mamba_dims(cfg)
    ds, dc = cfg.d_state, cfg.d_conv
    pd = cfg.pdt
    a = torch.log(torch.arange(1, ds + 1, dtype=torch.float32, device=device))
    return {
        "in_proj": dense_init(gen, (n, d, 2 * di), pd, device, fan_in=d),
        "conv_w": dense_init(gen, (n, dc, di), pd, device, fan_in=dc),
        "conv_b": torch.zeros((n, di), dtype=pd, device=device),
        "x_proj": dense_init(gen, (n, di, dtr + 2 * ds), pd, device,
                             fan_in=di),
        "dt_proj": dense_init(gen, (n, dtr, di), pd, device, fan_in=dtr),
        "dt_bias": torch.zeros((n, di), dtype=pd, device=device),
        "a_log": a.to(pd).expand(n, di, ds).contiguous(),
        "d_skip": torch.zeros((n, di), dtype=pd, device=device),
        "out_proj": dense_init(gen, (n, di, d), pd, device, fan_in=di),
    }


def axes_mamba(cfg: ArchConfig):
    return {"in_proj": ("embed_p", "mlp_p"), "conv_w": (None, "mlp_p"),
            "conv_b": ("mlp_p",), "x_proj": ("mlp_p", None),
            "dt_proj": (None, "mlp_p"), "dt_bias": ("mlp_p",),
            "a_log": ("mlp_p", "state"), "d_skip": ("mlp_p",),
            "out_proj": ("mlp_p", "embed_p")}


def mamba_init_state(cfg: ArchConfig, batch: int, dtype=torch.float32, *,
                     device):
    di, _ = mamba_dims(cfg)
    return {
        "conv": torch.zeros((batch, cfg.d_conv - 1, di), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, di, cfg.d_state), dtype=torch.float32,
                           device=device),
    }


def selective_scan(h, dt, A, Bc, Cc, x):
    """Mamba's recurrence, one step a token in fp32: ``h ← exp(dt·A)·h +
    dt·x·B``, ``y = h·C``.  h [B,di,ds]; dt, x [B,T,di]; A [di,ds]; Bc, Cc
    [B,T,ds].  The discretized [B,di,ds] tensors are formed per step, so
    memory stays O(di·ds).  Returns (h, y [B,T,di])."""
    ys = []
    for t in range(dt.shape[1]):
        dt_t, b_t, c_t, x_t = dt[:, t], Bc[:, t], Cc[:, t], x[:, t]
        da_t = torch.exp(dt_t[..., None] * A)               # [B,di,ds]
        dbx_t = (dt_t * x_t)[..., None] * b_t[:, None, :]
        h = da_t * h + dbx_t                                 # [B,di,ds]
        ys.append(torch.einsum("bds,bs->bd", h, c_t))
    y = torch.stack(ys, dim=1) if ys else x.new_zeros(x.shape)
    return h, y


def mamba_seq(params, cfg: ArchConfig, x, state):
    """x [B,T,d] → (y [B,T,d], new state)."""
    B, T, d = x.shape
    di, dtr = mamba_dims(cfg)
    ds = cfg.d_state
    cd = cfg.cdt

    xz = x @ params["in_proj"].to(cd)
    xi, z = xz.chunk(2, dim=-1)                              # [B,T,di]

    # causal depthwise conv with carried state
    conv_in = torch.cat([state["conv"].to(cd), xi], dim=1)
    kern = params["conv_w"].to(cd)                           # [dc, di]
    dc = cfg.d_conv
    xc = 0
    for i in range(dc):
        xc = xc + conv_in[:, i:i + T, :] * kern[i]
    xc = F.silu(xc + params["conv_b"].to(cd))
    # the last d_conv - 1 inputs: both of the reference's branches (T below
    # d_conv - 1, as in AR decode, or not) select exactly these rows
    new_conv = conv_in[:, T:, :]

    # data-dependent dt, B, C for the whole sequence; the discretized
    # [B, d_inner, d_state] tensors are formed per step inside the scan
    proj = xc @ params["x_proj"].to(cd)
    dt, Bc, Cc = torch.split(proj, [dtr, ds, ds], dim=-1)
    dt = softplus(dt @ params["dt_proj"].to(cd)
                  + params["dt_bias"].to(cd)).float()
    A = -torch.exp(params["a_log"].float())                  # [di, ds]
    x32 = xc.float()
    h, y = selective_scan(state["ssm"], dt, A, Bc.float(), Cc.float(), x32)
    y = y + x32 * params["d_skip"].float()
    y = (y.to(cd) * F.silu(z)) @ params["out_proj"].to(cd)
    return y, {"conv": new_conv.to(x.dtype), "ssm": h}


# ===========================================================================
# RWKV6 ("Finch") — data-dependent decay linear attention
# ===========================================================================

def init_rwkv_timemix(gen, cfg: ArchConfig, device, n: int):
    d = cfg.d_model
    hn, hd = cfg.rwkv_n_heads, cfg.rwkv_head_dim
    r = cfg.rwkv_lora_rank
    pd = cfg.pdt
    return {
        "mu": torch.zeros((n, 5, d), dtype=pd, device=device),  # r,k,v,g,w
        "wr": dense_init(gen, (n, d, d), pd, device, fan_in=d),
        "wk": dense_init(gen, (n, d, d), pd, device, fan_in=d),
        "wv": dense_init(gen, (n, d, d), pd, device, fan_in=d),
        "wg": dense_init(gen, (n, d, d), pd, device, fan_in=d),
        "w0": torch.zeros((n, d), dtype=pd, device=device),
        "w_lora_a": dense_init(gen, (n, d, r), pd, device, fan_in=d),
        "w_lora_b": dense_init(gen, (n, r, d), pd, device, fan_in=r),
        "bonus_u": torch.zeros((n, hn, hd), dtype=pd, device=device),
        "ln_scale": torch.zeros((n, d), dtype=pd, device=device),
        "wo": dense_init(gen, (n, d, d), pd, device, fan_in=d),
    }


def axes_rwkv_timemix(cfg: ArchConfig):
    return {"mu": (None, "embed"), "wr": ("embed_p", "heads_p"),
            "wk": ("embed_p", "heads_p"), "wv": ("embed_p", "heads_p"),
            "wg": ("embed_p", "heads_p"), "w0": ("heads_p",),
            "w_lora_a": ("embed_p", None), "w_lora_b": (None, "heads_p"),
            "bonus_u": ("heads", "head_dim"), "ln_scale": ("heads_p",),
            "wo": ("heads_p", "embed_p")}


def init_rwkv_chanmix(gen, cfg: ArchConfig, device, n: int):
    d, f = cfg.d_model, cfg.d_ff
    pd = cfg.pdt
    return {
        "mu": torch.zeros((n, 2, d), dtype=pd, device=device),  # k, r shifts
        "wk": dense_init(gen, (n, d, f), pd, device, fan_in=d),
        "wv": dense_init(gen, (n, f, d), pd, device, fan_in=f),
        "wr": dense_init(gen, (n, d, d), pd, device, fan_in=d),
    }


def axes_rwkv_chanmix(cfg: ArchConfig):
    return {"mu": (None, "embed"), "wk": ("embed_p", "mlp_p"),
            "wv": ("mlp_p", "embed_p"), "wr": ("embed_p", "embed_p")}


def rwkv_init_state(cfg: ArchConfig, batch: int, dtype=torch.float32, *,
                    device):
    hn, hd = cfg.rwkv_n_heads, cfg.rwkv_head_dim
    return {
        "tm_prev": torch.zeros((batch, cfg.d_model), dtype=dtype,
                               device=device),
        "cm_prev": torch.zeros((batch, cfg.d_model), dtype=dtype,
                               device=device),
        "wkv": torch.zeros((batch, hn, hd, hd), dtype=torch.float32,
                           device=device),
    }


def _token_shift(x, prev):
    """[B,T,d], prev [B,d] → x shifted right by one with ``prev`` at t=0."""
    return torch.cat([prev[:, None, :], x[:, :-1, :]], dim=1)


def _group_norm(x, scale, eps=1e-5):
    """Per-head LayerNorm of x [B,T,Hn,hd] (population variance), scaled by
    ``1 + scale``; returns [B,T,Hn·hd] fp32."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    B, T, hn, hd = x.shape
    s = (1.0 + scale.float()).reshape(hn, hd)
    return (y * s).reshape(B, T, hn * hd)


def wkv_scan(S, r, k, v, w, u):
    """RWKV6's WKV recurrence, one step a token in fp32: ``y = r·(S +
    u·kᵀv)``, ``S ← w·S + kᵀv``.  S [B,hn,hd,hd]; r, k, v, w [B,T,hn,hd]; u
    [hn,hd].  Returns (S, y [B,T,hn,hd])."""
    ys = []
    for t in range(r.shape[1]):
        r_t, k_t, v_t, w_t = r[:, t], k[:, t], v[:, t], w[:, t]
        kv = k_t[..., :, None] * v_t[..., None, :]           # [B,hn,hd,hd]
        ys.append(torch.einsum("bhk,bhkv->bhv", r_t, S + u[..., :, None] * kv))
        S = w_t[..., :, None] * S + kv
    y = torch.stack(ys, dim=1) if ys else r
    return S, y


def rwkv_timemix(params, cfg: ArchConfig, x, state):
    """RWKV6 WKV time-mix. x [B,T,d] → (y, new_state)."""
    B, T, d = x.shape
    hn, hd = cfg.rwkv_n_heads, cfg.rwkv_head_dim
    cd = cfg.cdt
    prev = _token_shift(x, state["tm_prev"].to(x.dtype))
    mu = params["mu"].to(cd)
    xr, xk, xv, xg, xw = (x + (prev - x) * mu[i] for i in range(5))
    r = (xr @ params["wr"].to(cd)).reshape(B, T, hn, hd)
    k = (xk @ params["wk"].to(cd)).reshape(B, T, hn, hd)
    v = (xv @ params["wv"].to(cd)).reshape(B, T, hn, hd)
    g = F.silu(xg @ params["wg"].to(cd))
    # data-dependent decay (the RWKV6 "Finch" contribution)
    w = params["w0"].float() + \
        (torch.tanh(xw @ params["w_lora_a"].to(cd))
         @ params["w_lora_b"].to(cd)).float()
    w = torch.exp(-torch.exp(w)).reshape(B, T, hn, hd)      # decay ∈ (0,1)
    u = params["bonus_u"].float()

    S, y = wkv_scan(state["wkv"], r.float(), k.float(), v.float(), w, u)
    y = _group_norm(y, params["ln_scale"]) * g.float()
    y = y.to(cd) @ params["wo"].to(cd)
    return y, {"tm_prev": x[:, -1, :], "wkv": S}


def rwkv_chanmix(params, cfg: ArchConfig, x, state):
    cd = cfg.cdt
    prev = _token_shift(x, state["cm_prev"].to(x.dtype))
    mu = params["mu"].to(cd)
    xk = x + (prev - x) * mu[0]
    xr = x + (prev - x) * mu[1]
    k = torch.square(torch.relu(xk @ params["wk"].to(cd)))
    kv = k @ params["wv"].to(cd)
    y = torch.sigmoid(xr @ params["wr"].to(cd)) * kv
    return y, {"cm_prev": x[:, -1, :]}
