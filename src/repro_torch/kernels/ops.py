"""Public kernel entry points and the plain-tensor ops around them.

``paged_chunk_attention`` and ``block_diffusion_attention`` launch their
hand-written CUDA kernels for CUDA tensors and run their plain versions for
CPU tensors — the device of the input decides, nothing else.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.block_diffusion_attn import \
    block_diffusion_attention
from repro_torch.kernels.chunked_paged_attn import paged_chunk_attention
from repro_torch.kernels.ref import merge_flash_partials


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
           "softmax_confidence_device", "paged_chunk_attention",
           "block_diffusion_attention"]
