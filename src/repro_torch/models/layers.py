"""Core neural-net layers: RMSNorm, RoPE / M-RoPE, GQA attention (the
plain and flash-style differentiable paths of training, and the partials
the serving paths combine), gated MLP.

Plain functions on tensors; parameters come from the flat param dict
(one layer's slice, keyed by the name under ``mixer/`` or ``ffn/``).  The
math, dtypes and rounding points follow the JAX package's layers exactly,
so the same inputs give the same outputs within float error.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.distributed.sharding import (current_mesh, current_rules,
                                              use_rules)
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


def axes_norm(cfg: ArchConfig):
    return {"scale": ("embed",)}


# ---------------------------------------------------------------------------
# Token embedding
# ---------------------------------------------------------------------------

class _EmbedLookup(torch.autograd.Function):
    """``table[tokens]``, whose backward sums the rows' gradients in fp32
    or wider, then rounds once to the table's dtype.  A diffusion batch
    feeds the mask token at about half its positions, so its row sums
    thousands of gradients: summed in bf16 they lose whole percents (on an
    H100, SDAR-8B-4L's 2 microbatches and 1 differed by 26% on that row)."""

    @staticmethod
    def forward(ctx, table, tokens):
        ctx.save_for_backward(tokens)
        ctx.table_shape, ctx.table_dtype = table.shape, table.dtype
        return table[tokens]

    @staticmethod
    def backward(ctx, grad):
        (tokens,) = ctx.saved_tensors
        acc = torch.zeros(ctx.table_shape, device=grad.device,
                          dtype=torch.promote_types(grad.dtype,
                                                    torch.float32))
        acc.index_put_((tokens.reshape(-1),),
                       grad.reshape(-1, grad.shape[-1]).to(acc.dtype),
                       accumulate=True)
        return acc.to(ctx.table_dtype), None


def embed_lookup(table, tokens):
    """Rows of ``table`` [V, d] at ``tokens`` [...] → [..., d]; under
    autograd the table's gradient is summed in fp32."""
    tokens = tokens.long()
    if torch.is_grad_enabled() and table.requires_grad:
        return _EmbedLookup.apply(table, tokens)
    return table[tokens]


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

_INV_FREQ: dict = {}


def _inv_freq(dim: int, theta: float, device) -> torch.Tensor:
    """The inverse frequencies ``[dim//2]``: the JAX package's float32 numpy
    vector, so the angles match bitwise, copied to ``device`` once (a
    host→device copy inside a dispatch would synchronise with the host)."""
    key = (dim, float(theta), torch.device(device))
    if key not in _INV_FREQ:
        inv = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float32) / dim))
        _INV_FREQ[key] = torch.from_numpy(np.asarray(inv, np.float32)).to(
            device)
    return _INV_FREQ[key]


def _rope_angles(positions, dim: int, theta: float):
    """positions [..., T] → cos/sin [..., T, dim//2] (float32)."""
    inv = _inv_freq(dim, theta, positions.device)
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


def apply_mrope(x, positions3, theta: float, sections):
    """Qwen2-VL multimodal RoPE: x [B, T, H, D], positions3 [B, 3, T]
    (temporal, height, width ids); ``sections`` gives each component's
    rotary dims (summing to D/2), each sliced from the full inverse
    frequency table in turn."""
    d = x.shape[-1]
    assert sum(sections) == d // 2, (sections, d)
    inv = _inv_freq(d, theta, x.device)
    angs, lo = [], 0
    for comp, sec in enumerate(sections):
        pos = positions3[:, comp, :]                        # [B, T]
        angs.append(pos[..., None].float() * inv[lo:lo + sec])
        lo += sec
    ang = torch.cat(angs, dim=-1)[:, :, None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def rope_for(cfg: ArchConfig, x, positions):
    """RoPE, or M-RoPE for a config with ``mrope_sections``: positions
    [B, T], or [B, 3, T] for M-RoPE (a [B, T] array means t = h = w, the
    text-only case)."""
    if cfg.mrope_sections:
        if positions.dim() == 2:
            positions = positions[:, None, :].expand(
                positions.shape[0], 3, positions.shape[1])
        return apply_mrope(x, positions, cfg.rope_theta, cfg.mrope_sections)
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


def axes_attention(cfg: ArchConfig):
    return {"wq": ("embed_p", "heads_p"), "wk": ("embed_p", "heads_p"),
            "wv": ("embed_p", "heads_p"), "wo": ("heads_p", "embed_p")}


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


def sdpa(q, k, v, mask, *, scale: float | None = None):
    """Grouped-query scaled dot-product attention, normalised: q [B,T,H,D],
    k/v [B,S,KVH,D], mask bool [B,1,T,S] → [B,T,H,D] in q's dtype.  fp32
    logits and softmax; the probabilities are rounded to q's dtype before
    PV, as in the JAX package."""
    B, T, H, D = q.shape
    KVH = k.shape[2]
    G = H // KVH
    scale = scale if scale is not None else 1.0 / np.sqrt(D)
    qg = q.reshape(B, T, KVH, G, D)
    logits = torch.einsum("btkgd,bskd->bkgts", qg.float(), k.float()) * scale
    logits = torch.where(mask[:, :, None, :, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgts,bskd->btkgd", probs.to(q.dtype), v.to(q.dtype))
    return out.reshape(B, T, H, D)


def _kind_mask(kind: str, qp, kp, block_size: int):
    """qp [B,tq], kp [B,tk] → bool [B,tq,tk]."""
    if kind == "all":
        return torch.ones((qp.shape[0], qp.shape[1], kp.shape[1]),
                          dtype=torch.bool, device=qp.device)
    if kind == "causal":
        return causal_mask(qp, kp)
    if kind == "block_causal":
        return block_causal_mask(qp, kp, block_size)
    raise ValueError(kind)


def _checkpointed(fn, *args):
    """``fn(*args)`` under ``torch.utils.checkpoint`` (the torch form of
    ``jax.checkpoint``: activations are recomputed in the backward pass)
    when autograd records this call, plainly otherwise.  The recomputation
    runs under the sharding rules and mesh installed at the forward: the
    backward may run after the caller's ``use_rules`` has exited, or on
    autograd's device thread, where the per-thread rules are unset."""
    if torch.is_grad_enabled() and any(
            isinstance(a, torch.Tensor) and a.requires_grad for a in args):
        rules, mesh = current_rules(), current_mesh()

        def under_rules(*a):
            with use_rules(rules, mesh):
                return fn(*a)

        # the training route draws no random numbers (the diffusion masks
        # are inputs), so the generator's state is not stashed: stashing it
        # reads the CUDA generator, which a captured train step cannot
        return torch.utils.checkpoint.checkpoint(under_rules, *args,
                                                 use_reentrant=False,
                                                 preserve_rng_state=False)
    return fn(*args)


def _online_step(acc, m, l, qi, ki, vi, msk, scale):
    """One online-softmax step of a flash scan: fold the keys ``ki``/``vi``
    [B,kc,KVH,D] into the running partial (acc [B,KVH,G,qc,D], m and l
    [B,KVH,G,qc]) of the queries ``qi`` [B,qc,KVH,G,D] under ``msk``
    [B,qc,kc]."""
    logits = torch.einsum("btkgd,bskd->bkgts", qi.float(), ki.float()) * scale
    msk = msk[:, None, None, :, :]
    logits = torch.where(msk, logits, NEG_INF)
    m_new = torch.maximum(m, logits.amax(dim=-1))
    corr = torch.exp(m - m_new)
    e = torch.where(msk, torch.exp(logits - m_new[..., None]), 0.0)
    l = l * corr + e.sum(dim=-1)
    pv = torch.einsum("bkgts,bskd->bkgtd", e.to(vi.dtype).float(), vi.float())
    return acc * corr[..., None] + pv, m_new, l


def _pad_seq(x, n: int):
    """Pad dim 1 of ``x`` with zeros (False) to length ``n``."""
    if x.shape[1] == n:
        return x
    pad = torch.zeros((x.shape[0], n - x.shape[1]) + tuple(x.shape[2:]),
                      dtype=x.dtype, device=x.device)
    return torch.cat([x, pad], dim=1)


def _partials_out(accs, ms, ls, B, T, H, D):
    """Per-query-chunk partials ([B,KVH,G,qc,D], [B,KVH,G,qc]) in chunk
    order → acc [B,T,H,D], m and l [B,T,H]."""
    acc = torch.stack(accs, 1).permute(0, 1, 4, 2, 3, 5)
    m = torch.stack(ms, 1).permute(0, 1, 4, 2, 3)
    l = torch.stack(ls, 1).permute(0, 1, 4, 2, 3)
    n = acc.shape[1] * acc.shape[2]
    return (acc.reshape(B, n, H, D)[:, :T], m.reshape(B, n, H)[:, :T],
            l.reshape(B, n, H)[:, :T])


def flash_partial(q, k, v, *, q_pos, k_pos, k_valid, kind="causal",
                  block_size: int = 0, q_chunk: int = 512,
                  kv_chunk: int = 1024, scale: float | None = None):
    """Memory-efficient (flash-style) partial attention in plain torch:
    query chunks × KV chunks with an online softmax, the mask built per
    chunk from positions, each KV step under :func:`_checkpointed` (the
    reference's ``jax.checkpoint``), so it is differentiable at
    O(q_chunk · kv_chunk) memory.

    q [B,T,H,D]; k/v [B,S,KVH,D]; q_pos [B,T]; k_pos [B,S]; k_valid [B,S].
    Returns acc [B,T,H,D] fp32, m/l [B,T,H] fp32.
    """
    B, T, H, D = q.shape
    S, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    scale = scale if scale is not None else 1.0 / np.sqrt(D)
    qc, kc = min(q_chunk, T), min(kv_chunk, S)
    Tp, Sp = -(-T // qc) * qc, -(-S // kc) * kc
    q, q_pos = _pad_seq(q, Tp), _pad_seq(q_pos, Tp)
    k, v = _pad_seq(k, Sp), _pad_seq(v, Sp)
    k_pos, k_valid = _pad_seq(k_pos, Sp), _pad_seq(k_valid, Sp)
    qs = q.reshape(B, Tp // qc, qc, KVH, G, D)

    def kv_step(acc, m, l, qi, qpi, ki, vi, kpi, kvi):
        msk = _kind_mask(kind, qpi, kpi, block_size) & kvi[:, None, :]
        return _online_step(acc, m, l, qi, ki, vi, msk, scale)

    accs, ms, ls = [], [], []
    for i in range(Tp // qc):
        qi, qpi = qs[:, i], q_pos[:, i * qc:(i + 1) * qc]
        acc = torch.zeros((B, KVH, G, qc, D), dtype=torch.float32,
                          device=q.device)
        m = torch.full((B, KVH, G, qc), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, KVH, G, qc), dtype=torch.float32, device=q.device)
        for j in range(Sp // kc):
            sl = slice(j * kc, (j + 1) * kc)
            acc, m, l = _checkpointed(kv_step, acc, m, l, qi, qpi, k[:, sl],
                                      v[:, sl], k_pos[:, sl], k_valid[:, sl])
        accs.append(acc)
        ms.append(m)
        ls.append(l)
    return _partials_out(accs, ms, ls, B, T, H, D)


def flash_partial_aligned(q, k, v, *, lengths, kind="causal",
                          block_size: int = 0, chunk: int = 512,
                          scale: float | None = None):
    """Triangular flash attention for position-aligned full sequences
    (positions 0..T-1): only the nq(nq+1)/2 (q-chunk, kv-chunk) pairs on
    or below the diagonal run, each under :func:`_checkpointed`.  The chunk
    is cut to a multiple of ``block_size`` so no diffusion block straddles
    two chunks; a T that is not a multiple of the chunk falls back to
    :func:`flash_partial`.  ``kind`` "block_causal" is block-causal, any
    other kind causal.  Returns flash partials (acc fp32 [B,T,H,D], m, l
    [B,T,H])."""
    B, T, H, D = q.shape
    KVH = k.shape[2]
    G = H // KVH
    scale = scale if scale is not None else 1.0 / np.sqrt(D)
    chunk = min(chunk, T)
    if block_size:
        chunk = max(chunk - chunk % block_size, block_size)
    if T % chunk != 0:
        pos = torch.arange(T, dtype=torch.int64, device=q.device)
        pos = pos[None].expand(B, T)
        return flash_partial(q, k, v, q_pos=pos, k_pos=pos,
                             k_valid=pos < lengths[:, None].to(q.device),
                             kind=kind, block_size=block_size, scale=scale)
    nq = T // chunk
    qs = q.reshape(B, nq, chunk, KVH, G, D)
    ks = k.reshape(B, nq, chunk, KVH, D)
    vs = v.reshape(B, nq, chunk, KVH, D)
    offs = torch.arange(chunk, dtype=torch.int64, device=q.device)
    lens = lengths.to(device=q.device, dtype=torch.int64)

    def step(acc, m, l, qb, kb, vb, qi: int, ki: int):
        qpos = qi * chunk + offs[:, None]
        kpos = ki * chunk + offs[None, :]
        if kind == "block_causal":
            ok = torch.div(kpos, block_size, rounding_mode="floor") <= \
                torch.div(qpos, block_size, rounding_mode="floor")
        else:
            ok = kpos <= qpos
        ok = ok[None] & ((ki * chunk + offs)[None, None, :]
                         < lens[:, None, None])
        return _online_step(acc, m, l, qb, kb, vb, ok, scale)

    accs, ms, ls = [], [], []
    for qi in range(nq):
        acc = torch.zeros((B, KVH, G, chunk, D), dtype=torch.float32,
                          device=q.device)
        m = torch.full((B, KVH, G, chunk), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, KVH, G, chunk), dtype=torch.float32,
                        device=q.device)
        for ki in range(qi + 1):
            acc, m, l = _checkpointed(step, acc, m, l, qs[:, qi], ks[:, ki],
                                      vs[:, ki], qi, ki)
        accs.append(acc)
        ms.append(m)
        ls.append(l)
    return _partials_out(accs, ms, ls, B, T, H, D)


def combine_partials(parts, out_dtype):
    """Combine flash partials [(acc, m, l), ...] into normalized output
    (shared implementation: :func:`repro_torch.kernels.ops.combine_flash_partials`)."""
    from repro_torch.kernels.ops import combine_flash_partials
    return combine_flash_partials(parts, out_dtype=out_dtype)


def attn_output(p, cfg: ArchConfig, out):
    B, T = out.shape[:2]
    return out.reshape(B, T, -1) @ p["wo"].to(cfg.cdt)


def attention_block(p, cfg: ArchConfig, x, positions, mask):
    """Self-attention over ``x`` [B,T,d] under ``mask`` [B,1,T,T] (plain
    :func:`sdpa`).  Returns (y [B,T,d], (k, v))."""
    q, k, v = qkv_project(p, cfg, x, positions)
    out = sdpa(q, k, v, mask)
    return attn_output(p, cfg, out), (k, v)


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


def axes_mlp(cfg: ArchConfig):
    out = {"w_up": ("embed_p", "mlp_p"), "w_down": ("mlp_p", "embed_p")}
    if cfg.gated_mlp:
        out["w_gate"] = ("embed_p", "mlp_p")
    return out


def mlp_block(p, cfg: ArchConfig, x):
    cd = cfg.cdt
    u = x @ p["w_up"].to(cd)
    if cfg.gated_mlp:
        h = _act(cfg.act)(x @ p["w_gate"].to(cd)) * u
    else:
        h = _act(cfg.act)(u)
    return h @ p["w_down"].to(cd)
