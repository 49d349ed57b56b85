"""Plain PyTorch versions of the kernels (the CPU path, and the oracles the
CUDA kernels are held against)."""

from __future__ import annotations

import numpy as np
import torch

NEG_INF = -1e30


def paged_chunk_ref(q, k_pages, v_pages, block_tables, ctx_lens, *,
                    scale: float | None = None):
    """Plain chunked paged attention partials.

    Gathers pages into a contiguous [B, S, KVH, D] cache and computes masked
    flash partials (acc fp32 [B,c,H,D], m, l fp32 [B,c,H]) in the kernel's
    output layout.
    """
    B, c, H, D = q.shape
    P, ps, KVH, _ = k_pages.shape
    G = H // KVH
    n_slots = block_tables.shape[1]
    S = n_slots * ps
    scale = scale if scale is not None else 1.0 / np.sqrt(D)

    tables = block_tables.long()
    k = k_pages[tables].reshape(B, S, KVH, D)
    v = v_pages[tables].reshape(B, S, KVH, D)

    qg = q.reshape(B, c, KVH, G, D)
    s = torch.einsum("bckgd,bskd->bkgcs", qg.float(), k.float()) * scale
    pos = torch.arange(S, device=q.device)
    valid = (pos[None, :] < ctx_lens[:, None])[:, None, None, None]
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(dim=-1)
    e = torch.where(valid, torch.exp(s - m[..., None]), 0.0)
    l = e.sum(dim=-1)
    acc = torch.einsum("bkgcs,bskd->bkgcd", e, v.float())
    # kernel layout [B, c, H, D] / [B, c, H]
    acc = acc.permute(0, 3, 1, 2, 4).reshape(B, c, H, D)
    m = m.permute(0, 3, 1, 2).reshape(B, c, H)
    l = l.permute(0, 3, 1, 2).reshape(B, c, H)
    return acc, m, l



def block_diffusion_ref(q, k, v, lengths, *, block_size: int,
                        scale: float | None = None):
    """Plain block-causal attention over a whole position-aligned sequence:
    q [B,T,H,D], k/v [B,T,KVH,D], lengths [B] → [B,T,H,D] in q's dtype.

    Query ``i`` sees key ``j`` when ``j // block_size <= i // block_size``
    and ``j < lengths[b]`` (``block_size`` 1 is the causal mask).  fp32
    scores and softmax; probabilities are masked to 0 after the softmax, so
    a row with no visible key (a ``lengths = 0`` batch-padding row) gives
    exactly 0, as the kernel's ``acc / max(l, 1e-30)`` does, never NaN.
    """
    B, T, H, D = q.shape
    KVH = k.shape[2]
    G = H // KVH
    scale = scale if scale is not None else 1.0 / np.sqrt(D)
    qg = q.reshape(B, T, KVH, G, D)
    s = torch.einsum("btkgd,bskd->bkgts", qg.float(), k.float()) * scale
    pos = torch.arange(T, device=q.device)
    blk = torch.div(pos, block_size, rounding_mode="floor")
    ok = (blk[None, :] <= blk[:, None])[None, None, None] \
        & (pos[None, :] < lengths[:, None])[:, None, None, None]
    s = torch.where(ok, s, NEG_INF)
    p = torch.where(ok, torch.softmax(s, dim=-1), 0.0)
    out = torch.einsum("bkgts,bskd->btkgd", p, v.float())
    return out.reshape(B, T, H, D).to(q.dtype)
