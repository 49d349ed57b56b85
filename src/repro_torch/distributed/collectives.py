"""Collectives over a single-controller mesh.

* :func:`split_kv_paged_partial` — split-KV paged attention over a sharded
  page pool: each shard runs the paged kernel over its own block of pages
  with shard-local block tables, then the flash partials merge exactly
  across the shards.  :func:`scatter_pages_sharded` keeps KV writes on
  their own shard.
* :func:`split_kv_attention` — sequence-parallel attention over a dense KV
  cache split along its sequence axis.
* :func:`psum` — the sum over a subset of the mesh axes (the
  expert-parallel MoE's: over the model axis, or over the data axes and
  the model axis together).
* :func:`compressed_psum` / :func:`compressed_grad_sync` — int8
  stochastic-rounding gradient reduction: per-block scales, quantize → sum
  in int32 → dequantize, 1 byte an element (2× fewer than bf16).

The JAX package runs each body under ``shard_map`` (its
``shard_map_compat`` picks the API of the installed jax), one body a shard
inside one process, and turns ``pmax``/``psum`` into reductions across the
shards.  The port does the same thing explicitly: a shard's inputs live on
its device (:class:`repro_torch.launch.mesh.Mesh`), a Python loop runs the
body once per shard, and a collective (:func:`_all_reduce`) is an
elementwise max or sum across the shards' outputs, on the first shard's
device, its result handed back to each shard's device.  With every shard
on one device each move is a no-op.

A sharded pool is a list of per-shard blocks, shard ``s`` owning global
pages ``[s·P/S, (s+1)·P/S)`` as its own contiguous tensor on its device.

The collective record: every reduction across two or more shards
(:func:`_all_reduce`, and the cross-shard form of
``merge_flash_partials``) adds its per-device operand bytes and one op to
:data:`RECORD` under its kind — the counterpart of the collectives XLA
puts in the reference's compiled module.  Rule HLO004
(:mod:`repro_torch.analysis.rules`) compares what a dispatch recorded
with the backend's analytic formula.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.kernels.ops import (combine_flash_partials,
                                     merge_flash_partials,
                                     paged_chunk_attention)
from repro_torch.kernels.ref import paged_chunk_ref


COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
RECORD = {k: {"bytes": 0, "count": 0} for k in COLLECTIVES}


def record_collective(kind: str, nbytes: int, count: int = 1):
    """Add one collective's per-device operand bytes (``count`` ops) to
    :data:`RECORD`."""
    RECORD[kind]["bytes"] += int(nbytes)
    RECORD[kind]["count"] += count


def record_snapshot() -> dict:
    """A copy of :data:`RECORD`, to take differences around a call."""
    return {k: dict(v) for k, v in RECORD.items()}


def _all_reduce(xs, op: str):
    """``op`` ("max" or "sum") of the shards' tensors ``xs``, elementwise, on
    the first shard's device in the tensors' own dtype; returns the result
    on each shard's device (every shard holds the same value)."""
    dev = xs[0].device
    if len(xs) > 1:
        record_collective("all-reduce", xs[0].numel() * xs[0].element_size())
    out = xs[0]
    for x in xs[1:]:
        x = x.to(dev)
        out = torch.maximum(out, x) if op == "max" else out + x
    return [out.to(x.device) for x in xs]


def psum(xs, mesh, axes):
    """Sum of the shards' tensors over the mesh axes ``axes`` (a name or a
    tuple of names): ``xs`` holds one tensor a device of ``mesh.devices``
    (row-major); the devices that differ only along ``axes`` form a group,
    and each gets its group's :func:`_all_reduce` sum on its device."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    keep = [k for k, a in enumerate(mesh.axis_names) if a not in axes]
    groups: dict = {}
    for i in range(len(xs)):
        c = mesh.coords(i)
        groups.setdefault(tuple(c[k] for k in keep), []).append(i)
    out = [None] * len(xs)
    for members in groups.values():
        for i, y in zip(members, _all_reduce([xs[i] for i in members],
                                             "sum")):
            out[i] = y
    return out


# ---------------------------------------------------------------------------
# int8 stochastic-rounding compressed gradient reduction
# ---------------------------------------------------------------------------

def uniform_draws(rng: torch.Generator, n: int, block: int = 256):
    """The stochastic-rounding draws of one participant's ``n`` values:
    uniform [0, 1) of shape ``[ceil(n / block), block]`` from ``rng``."""
    return torch.rand((-(-n // block), block), generator=rng,
                      device=rng.device)


def _quantize_sr(x, u, block: int = 256):
    """Stochastic-rounding int8 quantization with per-block scales, the
    rounding decided by the draws ``u`` (:func:`uniform_draws`).

    x [N] fp → (q int8 [ceil(N/block), block], scales fp32
    [ceil(N/block)])."""
    n = x.shape[0]
    pad = (-n) % block
    xp = torch.nn.functional.pad(x.float(), (0, pad)).reshape(-1, block)
    scale = xp.abs().amax(dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    y = xp / scale
    lo = torch.floor(y)
    frac = y - lo
    q = lo + (u.to(y.device) < frac)             # unbiased rounding
    q = torch.clamp(q, -127, 127).to(torch.int8)
    return q, scale[:, 0]


def _dequantize(q, scale, n, block: int = 256):
    x = q.float().reshape(-1, block) * scale[:, None]
    return x.reshape(-1)[:n]


def compressed_psum(xs, rng: torch.Generator | None = None,
                    block: int = 256, *, draws=None):
    """Sum of the participants' ``xs`` (one tensor each, same shape) with an
    int8 payload.

    Each participant quantizes with stochastic rounding onto the grid of
    the largest per-block scale across participants (a max collective of
    the tiny scales), so the int32 sum of the payloads is exact; the result
    is the sum of the participants' dequantized values, unbiased in
    expectation.  The draws come from ``rng``, one :func:`uniform_draws` a
    participant in order, or are given as ``draws`` (one tensor a
    participant).  Returns the sum once per participant, on its device."""
    shape, n = xs[0].shape, xs[0].numel()
    if draws is None:
        draws = [uniform_draws(rng, n, block) for _ in xs]
    qs, scales = zip(*(_quantize_sr(x.reshape(-1), u, block)
                       for x, u in zip(xs, draws)))
    smax = _all_reduce(list(scales), "max")
    ints = [torch.round(q.float() * (s / m)[:, None]).to(torch.int32)
            for q, s, m in zip(qs, scales, smax)]
    totals = _all_reduce(ints, "sum")
    return [(t.float() * m[:, None]).reshape(-1)[:n].reshape(shape)
            .to(x.dtype) for t, m, x in zip(totals, smax, xs)]


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _unflatten(tree, it):
    if isinstance(tree, dict):
        out = {k: _unflatten(tree[k], it) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(t, it) for t in tree)
    return next(it)


def compressed_grad_sync(grads, mesh, data_axes, rng: torch.Generator,
                         block: int = 256):
    """:func:`compressed_psum` over every leaf of the participants' gradient
    trees.  ``grads`` holds one tree a participant along the first of
    ``data_axes`` (dicts, lists or tuples of tensors, the same structure
    each); returns one reduced tree a participant.  Leaves go in the JAX
    package's order (sorted dict keys)."""
    axis = data_axes if isinstance(data_axes, str) else data_axes[0]
    if len(grads) != mesh.size(axis):
        raise ValueError(f"{len(grads)} gradient trees for the "
                         f"{mesh.size(axis)} participants of axis {axis!r}")
    per_leaf = zip(*(_leaves(g) for g in grads))
    summed = [compressed_psum(list(xs), rng, block) for xs in per_leaf]
    return [_unflatten(g, iter(out)) for g, out in
            zip(grads, zip(*summed))]


# ---------------------------------------------------------------------------
# split-KV attention over a dense cache (sequence parallel)
# ---------------------------------------------------------------------------

def _split_kv_body(q, k, v, klen, shard: int, *, scale):
    """Flash partial of one shard: its slice of the KV sequence (positions
    ``[shard·S_loc, (shard+1)·S_loc)``), keys at or past ``klen`` masked."""
    from repro_torch.models.layers import sdpa_partial
    S_loc = k.shape[1]
    pos = shard * S_loc + torch.arange(S_loc, device=k.device)[None, :]
    mask = (pos < klen[:, None])[:, None, None, :]            # [B,1,1,S]
    return sdpa_partial(q, k, v, mask, scale=scale)


def split_kv_attention(q, k_cache, v_cache, kv_lens, mesh, *,
                       seq_axis: str = "model", scale: float | None = None):
    """q [B,c,H,D]; KV cache [B,S,KVH,D] split on S over ``seq_axis`` (each
    shard's slice on its device) → exact attention output [B,c,H,D] in q's
    dtype, on q's device."""
    scale = scale if scale is not None else 1.0 / np.sqrt(q.shape[-1])
    devs = mesh.axis_devices(seq_axis)
    S_loc = k_cache.shape[1] // len(devs)
    if S_loc * len(devs) != k_cache.shape[1]:
        raise ValueError(f"KV length {k_cache.shape[1]} does not split "
                         f"over {len(devs)} shards")
    parts = []
    for s, dev in enumerate(devs):
        sl = slice(s * S_loc, (s + 1) * S_loc)
        parts.append(_split_kv_body(q.to(dev), k_cache[:, sl].to(dev),
                                    v_cache[:, sl].to(dev), kv_lens.to(dev),
                                    s, scale=scale))
    return combine_flash_partials(parts, out_dtype=q.dtype,
                                  device=devs[0]).to(q.device)


# ---------------------------------------------------------------------------
# split-KV paged attention (sharded page pool)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class KVShardSpec:
    """Static description of a sharded page pool.

    ``mesh`` carries ``axis`` with size ``n_shards``; shard *s* owns global
    pages ``[s·P/S, (s+1)·P/S)`` on ``mesh.axis_devices(axis)[s]``, while
    the allocator stripes each request's *table slots* round-robin from a
    per-request offset: global table slot ``j`` of a request with stripe
    offset ``o`` lives on shard ``(o + j) % S`` (see ``PagedKVAllocator``).
    That strict striping is what lets every shard derive its local table,
    local page indices and local context length on its device from the
    global table — no per-shard host-side tables.
    """
    mesh: object
    n_shards: int
    axis: str = "kv"

    def __post_init__(self):
        if self.mesh.size(self.axis) != self.n_shards:
            raise ValueError(f"mesh axis {self.axis!r} has "
                             f"{self.mesh.size(self.axis)} shards, not "
                             f"{self.n_shards}")

    @property
    def devices(self) -> tuple:
        return self.mesh.axis_devices(self.axis)


def shard_pages(pages, ks: KVShardSpec, dim: int = 1) -> list:
    """A global pool split into the shards' blocks along its page ``dim``
    (1 for a ``[L, P, …]`` pool, 0 for one layer's ``[P, …]``), each block
    contiguous on its shard's device."""
    return [b.to(d).contiguous() for b, d in
            zip(torch.chunk(pages, ks.n_shards, dim=dim), ks.devices)]


def unshard_pages(blocks, dim: int = 1):
    """The shards' blocks as one global pool (pages in global order), on
    the first block's device."""
    return torch.cat([b.to(blocks[0].device) for b in blocks], dim=dim)


def _local_slots(tables, ctx_lens, stripe_offs, shard: int, *,
                 n_shards: int, pages_local: int, page_size: int):
    """Shard-local view of the global block tables.

    For shard ``s``, local slot ``i`` holds the request's global table slot
    ``j = i·S + (s - o) % S`` — ascending in ``j``, so every local slot
    before the request's (single, final) partial page is a FULL page and
    the kernel's contiguous ``pos < ctx`` masking stays valid after the
    shard-local reorder.  Returns (local_tables [B, Wl] int32 local page
    ids clipped in-bounds, local_ctx [B] int32 valid tokens on this shard).
    """
    B, W = tables.shape
    S = n_shards
    Wl = -(-W // S)
    d = torch.remainder(shard - stripe_offs.long(), S)          # [B]
    j = torch.arange(Wl, device=tables.device)[None, :] * S + d[:, None]
    gl = torch.gather(tables.long(), 1, torch.clamp(j, max=W - 1))
    local = torch.clamp(gl - shard * pages_local, 0, pages_local - 1)
    # tokens contributed by global slot j: ps for full pages, the tail for
    # the request's last page, 0 past the context (incl. clamped j ≥ W —
    # ctx ≤ W·ps always, so those slots mask themselves)
    tok = torch.clamp(ctx_lens.long()[:, None] - j * page_size, 0,
                      page_size)
    return local.to(torch.int32), tok.sum(dim=1).to(torch.int32)


def shard_local_slots(block_tables, ctx_lens, stripe_offs, ks: KVShardSpec,
                      *, pages_local: int, page_size: int) -> list:
    """Every shard's ``(local table, local ctx)`` (:func:`_local_slots`),
    each on its shard's device: they depend on the dispatch's tables only,
    so a model computes them once for all its layers."""
    return [_local_slots(block_tables.to(d), ctx_lens.to(d),
                         stripe_offs.to(d), s, n_shards=ks.n_shards,
                         pages_local=pages_local, page_size=page_size)
            for s, d in enumerate(ks.devices)]


def split_kv_paged_partial(q, k_pages, v_pages, block_tables, ctx_lens,
                           stripe_offs, ks: KVShardSpec, *,
                           impl: str = "kernel", scale: float | None = None,
                           local=None):
    """Split-KV chunked paged attention across ``ks.axis``.

    q [B,c,H,D]; ``k_pages``/``v_pages`` the shards' blocks, ``[P/S, ps,
    KVH, D]`` each on its shard's device; block_tables [B,W] GLOBAL page ids
    (strict striping per :class:`KVShardSpec`); ctx_lens/stripe_offs [B].
    Each shard runs :func:`paged_chunk_attention` (the CUDA kernel on a
    CUDA tensor, its plain version on a CPU one; ``impl="ref"`` the plain
    version) over its local pages only, then the flash partials merge
    exactly across the shards (:func:`merge_flash_partials`, cross-shard
    form).  Returns the *merged partial* ``(acc [B,c,H,D] fp32, m [B,c,H],
    l [B,c,H])`` on q's device — the same contract as the unsharded kernel,
    so the caller combines it with the in-window partial unchanged.
    ``local``: the shards' local tables and ctx as
    :func:`shard_local_slots` gives them for these tables (computed here
    when None).
    """
    if len(k_pages) != ks.n_shards or len(v_pages) != ks.n_shards:
        raise ValueError(f"{len(k_pages)} page blocks for {ks.n_shards} "
                         f"shards")
    if local is None:
        local = shard_local_slots(block_tables, ctx_lens, stripe_offs, ks,
                                  pages_local=k_pages[0].shape[0],
                                  page_size=k_pages[0].shape[1])
    fn = paged_chunk_ref if impl == "ref" else paged_chunk_attention
    parts = [fn(q.to(kp.device), kp, vp, lt, lctx, scale=scale)
             for kp, vp, (lt, lctx) in zip(k_pages, v_pages, local)]
    merged = merge_flash_partials(parts, device=k_pages[0].device)
    return tuple(t.to(q.device) for t in merged)


def scatter_pages_sharded(pages, new, dest, ks: KVShardSpec):
    """Sharded counterpart of the models' token-granular page scatter.

    pages: the shards' blocks ``[L, P/S, ps, KVH, hd]``; new [L,B,T,KVH,hd]
    and flat global dest [B,T].  Each shard rewrites ``dest`` into its local
    flat index (out-of-shard and sentinel entries → the local sentinel,
    dropped) and writes its block in place, so no KV crosses shards and
    every block's ``data_ptr`` stays fixed."""
    from repro_torch.models.transformer import _scatter_pages
    if len(pages) != ks.n_shards:
        raise ValueError(f"{len(pages)} page blocks for {ks.n_shards} "
                         f"shards")
    n = pages[0].shape[1] * pages[0].shape[2]
    for s, blk in enumerate(pages):
        d = dest.to(blk.device) - s * n
        d = torch.where((d >= 0) & (d < n), d, n)
        _scatter_pages(blk, new.to(blk.device), d)
    return pages
