"""Plain PyTorch versions of the kernels (the CPU path, and the oracles the
CUDA kernels are held against)."""

from __future__ import annotations

import numpy as np
import torch

NEG_INF = -1e30
KEYS_PER_TILE = 64  # the split unit of the tensor-core paged kernel


def paged_chunk_ref(q, k_pages, v_pages, block_tables, ctx_lens, *,
                    scale: float | None = None, key_lo=None, p_dtype=None):
    """Plain chunked paged attention partials.

    Gathers pages into a contiguous [B, S, KVH, D] cache and computes masked
    flash partials (acc fp32 [B,c,H,D], m, l fp32 [B,c,H]) in the kernel's
    output layout over the keys at positions ``< ctx_lens[b]`` (and
    ``>= key_lo[b]`` when given).  fp32 probabilities, unless ``p_dtype``
    names a type to round them to before PV (the Pallas body's
    ``e.astype(v.dtype)``; l still sums the unrounded values).
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
    valid = pos[None, :] < ctx_lens[:, None]
    if key_lo is not None:
        valid = valid & (pos[None, :] >= key_lo[:, None])
    valid = valid[:, None, None, None]
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(dim=-1)
    e = torch.where(valid, torch.exp(s - m[..., None]), 0.0)
    l = e.sum(dim=-1)
    pv = e if p_dtype is None else e.to(p_dtype).float()
    acc = torch.einsum("bkgcs,bskd->bkgcd", pv, v.float())
    # kernel layout [B, c, H, D] / [B, c, H]
    acc = acc.permute(0, 3, 1, 2, 4).reshape(B, c, H, D)
    m = m.permute(0, 3, 1, 2).reshape(B, c, H)
    l = l.permute(0, 3, 1, 2).reshape(B, c, H)
    return acc, m, l


def merge_flash_partials(parts, device=None):
    """Merge flash partials ``[(acc, m, l), ...]`` over disjoint KV sets
    into ONE partial ``(acc, m, l)`` — the exact log-sum-exp combine
    (``acc = Σ e^{logit-m} v``, ``m = max logit``, ``l = Σ e^{logit-m}``).
    An empty partial (acc 0, m = -1e30, l 0) merges to a no-op: its
    correction factor underflows to 0, never NaN.  The plain version of the
    paged kernel's split merge.

    ``device`` gives the cross-shard form: the parts come from the shards
    of a mesh, one a shard, each on its shard's device; they are brought
    to ``device`` and merged there — the max of m and the sums of the
    corrected acc and l across the shards, which the JAX package writes
    as ``pmax`` and ``psum`` over a mapped axis.  That form adds the three
    reductions' per-device operand bytes (acc, m and l) to the collective
    record (``repro_torch.distributed.collectives.RECORD``) when two or
    more shards take part."""
    if device is not None:
        if len(parts) > 1:
            from repro_torch.distributed.collectives import record_collective
            record_collective("all-reduce", sum(
                t.numel() * t.element_size() for t in parts[0]), count=3)
        parts = [tuple(t.to(device) for t in p) for p in parts]
    m_g = parts[0][1]
    for _, m, _ in parts[1:]:
        m_g = torch.maximum(m_g, m)
    acc_g = 0.0
    l_g = 0.0
    for acc, m, l in parts:
        corr = torch.exp(m - m_g)
        acc_g = acc_g + acc * corr[..., None]
        l_g = l_g + l * corr
    return acc_g, m_g, l_g


def split_ranges(ctx_lens, n_keys: int, splits: int):
    """The key range ``[lo, hi)`` of each split of each row, as the
    tensor-core paged kernel cuts it on the device: the row's live keys
    ``min(ctx, n_keys)`` in 64-key tiles, ``ceil(tiles / splits)`` tiles a
    split, the last splits short or empty.  Returns ``[(lo [B], hi [B]),
    ...]`` with ``hi <= lo`` for an empty split."""
    ctx = torch.clamp(ctx_lens.long(), 0, n_keys)
    tiles = torch.div(ctx + KEYS_PER_TILE - 1, KEYS_PER_TILE,
                      rounding_mode="floor")
    per = torch.div(tiles + splits - 1, splits, rounding_mode="floor")
    out = []
    for s in range(splits):
        lo = s * per * KEYS_PER_TILE
        out.append((lo, torch.minimum(ctx, lo + per * KEYS_PER_TILE)))
    return out


def paged_chunk_split_ref(q, k_pages, v_pages, block_tables, ctx_lens, *,
                          splits: int, scale: float | None = None):
    """Plain split-KV paged partials: each row's live keys cut into
    ``splits`` equal tile-aligned parts exactly as the tensor-core kernel
    cuts them (:func:`split_ranges`), each part's partial computed alone,
    the parts merged with :func:`merge_flash_partials`.  Same output as
    :func:`paged_chunk_ref` up to the order of the sums."""
    n_keys = block_tables.shape[1] * k_pages.shape[1]
    parts = [paged_chunk_ref(q, k_pages, v_pages, block_tables, hi,
                             scale=scale, key_lo=lo)
             for lo, hi in split_ranges(ctx_lens, n_keys, splits)]
    return merge_flash_partials(parts)


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
