"""Public kernel entry points and the plain-tensor ops around them.

``paged_chunk_attention`` launches the hand-written CUDA kernel for CUDA
tensors and runs its plain version for CPU tensors — the device of the
input decides, nothing else.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.chunked_paged_attn import paged_chunk_attention


def merge_flash_partials(parts):
    """Merge flash partials ``[(acc, m, l), ...]`` over disjoint KV sets
    into ONE partial ``(acc, m, l)`` — the exact log-sum-exp combine
    (``acc = Σ e^{logit-m} v``, ``m = max logit``, ``l = Σ e^{logit-m}``).
    An empty partial (acc 0, m = -1e30, l 0) merges to a no-op: its
    correction factor underflows to 0, never NaN."""
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


def combine_flash_partials(parts, out_dtype=torch.float32):
    """Normalize the merge of flash partials: ``merge → acc / max(l, ε)``."""
    acc_g, _, l_g = merge_flash_partials(parts)
    return (acc_g / torch.clamp(l_g, min=1e-30)[..., None]).to(out_dtype)


def softmax_confidence_device(logits):
    """On-device argmax + softmax top-probability: logits [..., V] →
    (confidence [...] fp32, token [...] int32).

    Only these ``2·B·c`` scalars leave the device per dispatch, never the
    ``[B, c, V]`` logits.  ``torch.argmax`` breaks ties at the first maximal
    index, as numpy and XLA do, so committed tokens match the host path.
    """
    x = logits.float()
    m = x.amax(dim=-1, keepdim=True)
    e = torch.exp(x - m)
    p = e / e.sum(dim=-1, keepdim=True)
    tok = torch.argmax(x, dim=-1)
    conf = torch.gather(p, -1, tok[..., None])[..., 0]
    return conf, tok.to(torch.int32)


__all__ = ["merge_flash_partials", "combine_flash_partials",
           "softmax_confidence_device", "paged_chunk_attention"]
