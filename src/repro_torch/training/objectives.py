"""Training objectives (the JAX package's ``training/objectives.py``).

* ``block_diffusion_loss`` — SDAR-style masked denoising within blocks:
  every (example, block) draws a mask ratio r ~ U[1/block, 1), masked
  inputs become the mask token, the model runs block-causal and predicts
  the original token at masked positions, the cross entropy weighted 1/r.
* ``ar_loss`` — next-token cross entropy (the AR configs and rwkv6).
* ``encdec_loss`` — either of the two on the decoder of the encoder–decoder
  family, the source encoded bidirectionally.

Drawing the ratios and masks (:func:`diffusion_masks`, from an explicit
``torch.Generator``) is kept apart from the loss on given masks (every
loss takes ``masks=``), so the loss can be evaluated on the masks
``jax.random`` drew for the reference.  Each loss is ``Σ nll·w / max(Σ w,
1)``; the ``*_terms`` functions return the two sums, which the train step
accumulates over microbatches.  The models run their training route
(``apply(impl="train")`` of :class:`TransformerLM`, the plain
differentiable ``apply`` of :class:`EncDecLM`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def diffusion_masks(gen: torch.Generator, B: int, T: int, block_size: int):
    """{"ratios": [B,T] fp32, each token's block ratio r ~ U[1/block, 1),
    "masked": [B,T] bool, u < r for u ~ U[0, 1)}, drawn from ``gen`` on its
    device."""
    n_blocks = -(-T // block_size)
    lo = 1.0 / block_size
    ratios = torch.rand((B, n_blocks), generator=gen, device=gen.device) \
        * (1.0 - lo) + lo
    ratios = ratios.repeat_interleave(block_size, dim=1)[:, :T]
    u = torch.rand((B, T), generator=gen, device=gen.device)
    return {"ratios": ratios, "masked": u < ratios}


def _ce_terms(logits, targets, weights):
    """(Σ nll·w, Σ w) of the fp32 cross entropy of ``logits`` [..., V]."""
    nll = F.cross_entropy(logits.float().flatten(0, -2),
                          targets.flatten().long(),
                          reduction="none").view(targets.shape)
    return torch.sum(nll * weights), torch.sum(weights)


def mean_of(num, den):
    """The loss of its two sums: ``num / max(den, 1)``."""
    return num / torch.clamp(den, min=1.0)


def _masked(masks, tokens, mask_token_id: int):
    ratios = masks["ratios"].to(tokens.device)
    masked = masks["masked"].to(device=tokens.device, dtype=torch.bool)
    inputs = torch.where(masked, torch.full_like(tokens, mask_token_id),
                         tokens)
    return inputs, masked.float() / ratios


def block_diffusion_terms(model, params, tokens, rng=None, *, lengths=None,
                          mm_embeds=None, mm_mask=None, masks=None):
    cfg = model.cfg
    B, T = tokens.shape
    if masks is None:
        masks = diffusion_masks(rng, B, T, cfg.block_size)
    inputs, w = _masked(masks, tokens, cfg.mask_token_id)
    logits = model.apply(params, inputs, mask_mode="block_causal",
                         lengths=lengths, mm_embeds=mm_embeds,
                         mm_mask=mm_mask, impl="train")
    if lengths is not None:
        w = w * (torch.arange(T, device=w.device)[None, :]
                 < lengths.to(w.device)[:, None])
    return _ce_terms(logits, tokens, w)


def ar_terms(model, params, tokens, rng=None, *, lengths=None,
             mm_embeds=None, mm_mask=None, masks=None):
    B, T = tokens.shape
    logits = model.apply(params, tokens, mask_mode="causal", lengths=lengths,
                         mm_embeds=mm_embeds, mm_mask=mm_mask, impl="train")
    w = torch.ones((B, T - 1), dtype=torch.float32, device=tokens.device)
    if lengths is not None:
        w = w * (torch.arange(1, T, device=w.device)[None, :]
                 < lengths.to(w.device)[:, None])
    return _ce_terms(logits[:, :-1], tokens[:, 1:], w)


def encdec_terms(model, params, batch, rng=None, *, diffusion=True,
                 masks=None):
    """batch: ``src_embeds`` [B,S,d], ``src_mask`` [B,S], ``tgt_tokens``
    [B,T]."""
    cfg = model.cfg
    src_embeds, src_mask = batch["src_embeds"], batch["src_mask"]
    tgt = batch["tgt_tokens"]
    B, T = tgt.shape
    if diffusion and cfg.diffusion:
        if masks is None:
            masks = diffusion_masks(rng, B, T, cfg.block_size)
        inputs, w = _masked(masks, tgt, cfg.mask_token_id)
        logits = model.apply(params, src_embeds, src_mask, inputs,
                             mask_mode="block_causal")
        return _ce_terms(logits, tgt, w)
    logits = model.apply(params, src_embeds, src_mask, tgt,
                         mask_mode="causal")
    w = torch.ones((B, T - 1), dtype=torch.float32, device=tgt.device)
    return _ce_terms(logits[:, :-1], tgt[:, 1:], w)


def block_diffusion_loss(*a, **k):
    return mean_of(*block_diffusion_terms(*a, **k))


def ar_loss(*a, **k):
    return mean_of(*ar_terms(*a, **k))


def encdec_loss(*a, **k):
    """Seq2seq loss for the encoder–decoder family."""
    return mean_of(*encdec_terms(*a, **k))


def terms_for(cfg):
    """The ``*_terms`` function of an architecture's objective."""
    if cfg.family == "encdec":
        return encdec_terms
    if cfg.diffusion and cfg.family != "ssm":
        return block_diffusion_terms
    return ar_terms


def loss_for(cfg):
    """Pick the training objective for an architecture."""
    return {encdec_terms: encdec_loss, block_diffusion_terms:
            block_diffusion_loss, ar_terms: ar_loss}[terms_for(cfg)]
