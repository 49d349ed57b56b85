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

