"""The yardstick's arithmetic: the chip's peaks, a kernel's operations and
bytes, and a step's operations, each from shapes and the data of the call.

Frozen here so that a change to the program cannot move the yardstick.
``paged_attn_cost`` is the formula of ``cost()`` in
``repro_torch/kernels/chunked_paged_attn.py`` as of its first benchmark.
"""

from __future__ import annotations

import math

# NVIDIA H100 SXM data sheet: dense bf16 tensor rate and HBM3 bandwidth,
# at the card's full 700 W.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def paged_attn_cost(rows, H: int, KVH: int, D: int, page_size: int,
                    itemsize: int):
    """(FLOPs, bytes) of one paged-attention call over ``rows`` [(ctx,
    queries)]: ``4·ctx·queries·H·D`` operations a row (QKᵀ and PV over its
    live keys) and the bytes it must move: q, the live K/V rows and their
    table entries, ctx_lens, and the fp32 outputs (acc, m, l), each once."""
    flops = nbytes = 0
    for ctx, c in rows:
        flops += 4.0 * ctx * c * H * D
        nbytes += (c * H * D * itemsize + ctx * KVH * D * 2 * itemsize
                   + -(-ctx // page_size) * 4 + 4 + c * H * (D + 2) * 4)
    return flops, nbytes


def roofline_seconds(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time the chip could take, and which bound sets it."""
    tc, tm = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return (tc, "compute") if tc >= tm else (tm, "memory")


def matmul_params(layout: dict, skip=(), n_experts: int = 0,
                  top_k: int = 0) -> int:
    """Weights one token multiplies through, per token: every leaf of two
    or more axes but the embedding, the output head, the norms' scales and
    ``skip``.  A stack of experts, ``[layers, n_experts, in, out]``, counts
    the ``top_k`` experts a token is routed to, ``top_k / n_experts`` of
    its size; the router, ``[layers, in, n_experts]``, counts in full."""
    n = 0
    for name, t in layout.items():
        leaf = name.split("/")[-1]
        if name in ("embed", "lm_head") or leaf in (*skip, "scale") \
                or t.dim() < 2:
            continue
        size = math.prod(t.shape)
        if n_experts and t.dim() == 4 and t.shape[1] == n_experts:
            size = size // n_experts * top_k
        n += size
    return n


def _block_keys(offset: int, n: int, block: int) -> int:
    """Σ over the queries of a prefill chunk [offset, offset+n) of the keys
    each sees: the prefix, then the chunk's positions up to the end of the
    query's own block (block-causal)."""
    total = 0
    p = offset
    while p < offset + n:
        end = min(offset + n, (p // block + 1) * block)
        total += (end - p) * end        # each query sees keys [0, end)
        p = end
    return total


def step_flops(call, *, params: int, d_model: int, vocab: int,
               n_attn_layers: int, n_heads: int, head_dim: int,
               block: int) -> float:
    """Operations one ``decode_step`` call needs: ``2·params`` a token
    computed, the output head on every decode position and on each prefill
    row's last, and attention over each query's live context.  Padding
    (batch rows, window slots past ``valid``, prompt slots past a chunk)
    is not counted."""
    attn = 4.0 * n_attn_layers * n_heads * head_dim
    f = 0.0
    for ctx, v in call.rows:
        f += 2.0 * params * v + 2.0 * d_model * vocab * v
        f += attn * v * (ctx + v)
    for off, n in call.prefill:
        f += 2.0 * params * n + 2.0 * d_model * vocab
        f += attn * _block_keys(off, n, block)
    return f
