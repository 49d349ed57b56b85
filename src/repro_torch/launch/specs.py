"""Per-(arch × shape) dry-run cell construction, the torch form of the JAX
package's ``launch/specs.py``.

``build_cell`` returns the step function, its arguments — ``meta`` tensors
by default: shape and dtype only, nothing allocated, the torch form of the
reference's ``ShapeDtypeStruct``\\ s — and each argument leaf's partition
spec, from the model's logical axes under the kind's rule set.  With
``device="cuda"`` the same cell's arguments are real tensors on the card
(seeded random weights, zero caches at full context), so the dry run's
prediction can be set against the step run.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.configs import SHAPES, get_config
from repro_torch.distributed.sharding import (Rules, long_context_rules,
                                              param_specs, serving_rules,
                                              training_rules, use_rules)
from repro_torch.launch.mesh import data_axes_of
from repro_torch.models.registry import build_model
from repro_torch.training.objectives import (block_diffusion_terms,
                                             encdec_terms, terms_for)
from repro_torch.training.optimizer import AdamW, AdamWConfig
from repro_torch.training.train_loop import make_train_step

# decode-chunk used for the representative serve_step per family
DECODE_CHUNK = 8

# microbatch counts keeping per-device activations bounded for train_4k
TRAIN_MICROBATCHES = {
    "kimi-k2-1t-a32b": 16,
    "llama4-scout-17b-a16e": 16,
    "starcoder2-15b": 16,
    "smollm-135m": 4,
    "llama3.2-1b": 8,
    "phi3-medium-14b": 16,
    "qwen2-vl-2b": 8,
    "jamba-1.5-large-398b": 16,
    "seamless-m4t-large-v2": 8,
    "rwkv6-1.6b": 8,
    "sdar-8b": 16,
}

# encoder-decoder shape interpretation (documented in DESIGN.md):
# train: src = seq, tgt = seq/4 (audio→text ratio); decode: src = 4096.
ENCDEC_DECODE_SRC = 4096


@dataclass
class Cell:
    arch: str
    shape: str
    kind: str
    fn: Callable
    args: tuple
    in_shardings: Any      # the args' tree with a spec tuple at each leaf
    donate_argnums: tuple
    rules: Rules
    meta: dict
    model: Any = None


def _abs(shape, dtype, device="meta"):
    return torch.empty(tuple(shape), dtype=dtype, device=device)


def input_specs(arch: str, shape_name: str, cfg=None, chunk=None,
                device="meta"):
    """The model inputs of one cell (``meta`` tensors unless ``device``
    names another; the caller fills real ones)."""
    cfg = cfg if cfg is not None else get_config(arch)
    spec = SHAPES[shape_name]
    B, S = spec.global_batch, spec.seq_len
    d = cfg.d_model
    cdt = cfg.cdt
    i32 = torch.int32

    def a(shape, dtype):
        return _abs(shape, dtype, device)

    if spec.kind == "train":
        if cfg.family == "encdec":
            return {"src_embeds": a((B, S, d), cdt),
                    "src_mask": a((B, S), torch.bool),
                    "tgt_tokens": a((B, S // 4), i32)}
        batch = {"tokens": a((B, S), i32)}
        if cfg.family == "vlm":
            batch["mm_embeds"] = a((B, S, d), cdt)
            batch["mm_mask"] = a((B, S), torch.bool)
        return batch
    if spec.kind == "prefill":
        if cfg.family == "encdec":
            return {"src_embeds": a((B, S, d), cdt),
                    "src_mask": a((B, S), torch.bool)}
        batch = {"tokens": a((B, S), i32), "lengths": a((B,), i32)}
        if cfg.family == "vlm":
            batch["mm_embeds"] = a((B, S, d), cdt)
            batch["mm_mask"] = a((B, S), torch.bool)
        return batch
    # decode / long_decode: one chunk step against a seq_len KV cache
    c = cfg.block_size if cfg.family == "hybrid" else (chunk or DECODE_CHUNK)
    if cfg.family == "ssm":
        c = 1
    return {"win_tokens": a((B, c), i32), "win_start": a((B,), i32),
            "win_valid": a((B,), i32), "n_adv": a((B,), i32)}


def _rules_for(kind: str, mesh, cfg=None) -> Rules:
    da = data_axes_of(mesh)
    if kind == "train":
        rules = training_rules(da, "model")
    elif kind == "long_decode":
        rules = long_context_rules(da, "model")
    elif kind == "decode":
        rules = serving_rules(da, "model", moe_2d=True)
    else:
        rules = serving_rules(da, "model")
    if cfg is not None and cfg.rule_overrides:
        rules = rules.with_overrides(**dict(cfg.rule_overrides))
    return rules


def _cache(model, B, S, device):
    if model.cfg.family == "encdec":
        return model.init_cache(B, S, ENCDEC_DECODE_SRC, torch.bfloat16,
                                device=device)
    return model.init_cache(B, S, torch.bfloat16, device=device)


def _fill_batch(batch, cfg, kind: str, S: int, gen):
    """Real values for a cell's batch on a device: tokens drawn from the
    vocabulary, every row at its full length, a decode window right after
    a full ``S``-token context, committing all of it."""
    out = {}
    for k, t in batch.items():
        if k in ("tokens", "win_tokens", "tgt_tokens"):
            out[k] = torch.randint(0, cfg.vocab_size, t.shape, generator=gen,
                                   device=t.device, dtype=t.dtype)
        elif k in ("src_mask", "mm_mask"):
            out[k] = torch.ones_like(t) if k == "src_mask" \
                else torch.zeros_like(t)
        elif k == "lengths":
            out[k] = torch.full_like(t, S)
        elif k == "win_start":
            out[k] = torch.full_like(t, S)
        elif k in ("win_valid", "n_adv"):
            out[k] = torch.full_like(t, batch["win_tokens"].shape[1])
        else:
            out[k] = (torch.randn(t.shape, generator=gen, device=t.device)
                      .to(t.dtype))
    return out


def build_cell(arch: str, shape_name: str, mesh, *, rule_overrides=None,
               cfg_overrides=None, chunk=None, device="meta",
               seed: int = 0) -> Cell:
    """One dry-run cell on ``mesh`` (its shape decides the specs; its
    devices are never used).  ``device``: where the arguments live —
    ``meta`` (shape only) or a real device for the measured run."""
    cfg = get_config(arch)
    mb_override = None
    if cfg_overrides:
        cfg_overrides = dict(cfg_overrides)
        mb_override = cfg_overrides.pop("microbatches", None)
        cfg = cfg.replace(**cfg_overrides)
    spec = SHAPES[shape_name]
    model = build_model(cfg)
    rules = _rules_for(spec.kind, mesh, cfg)
    if rule_overrides:
        rules = rules.with_overrides(
            **{k: (tuple(v) if isinstance(v, list) else v)
               for k, v in rule_overrides.items()})
    real = torch.device(device).type != "meta"
    gen = torch.Generator(device=device).manual_seed(seed) if real else None
    params = model.init_params(gen, device=device)
    with use_rules(rules, mesh):
        params_sh = param_specs(model.logical_axes())
    da = data_axes_of(mesh)
    da_key = da if len(da) > 1 else da[0]
    B, S = spec.global_batch, spec.seq_len
    batch = input_specs(arch, shape_name, cfg=cfg, chunk=chunk,
                        device=device)
    if real:
        batch = _fill_batch(batch, cfg, spec.kind, S, gen)
    meta = {"global_batch": B, "seq_len": S, "kind": spec.kind,
            "chunk": None}

    batch_shardings = {}
    for k, v in batch.items():
        if spec.kind in ("decode", "long_decode") and spec.global_batch == 1:
            batch_shardings[k] = (None,) * v.dim()
        elif v.dim() == 1:
            batch_shardings[k] = (da_key,)
        else:
            batch_shardings[k] = (da_key,) + (None,) * (v.dim() - 1)

    if spec.kind == "train":
        opt = AdamW(AdamWConfig(state_dtype="bfloat16"))
        mb = mb_override or TRAIN_MICROBATCHES.get(arch, 8)
        step = make_train_step(model, opt, microbatches=mb)
        meta["microbatches"] = mb
        terms = terms_for(cfg)
        diffusion = terms is block_diffusion_terms or (
            terms is encdec_terms and cfg.diffusion)
        tok_key = "tgt_tokens" if cfg.family == "encdec" else "tokens"

        def fn(params, opt_state, batch, seed):
            g = masks = None
            tok = batch[tok_key]
            if diffusion and tok.is_meta:
                # the diffusion masks' shapes: a meta tensor has no draws
                masks = {"ratios": _abs(tok.shape, torch.float32),
                         "masked": _abs(tok.shape, torch.bool)}
            elif diffusion:
                g = torch.Generator(device=tok.device).manual_seed(int(seed))
            return step(params, opt_state, batch, g, masks=masks)

        opt_state = opt.init(params)
        opt_sh = {"mu": {k: {"m": s, "v": s} for k, s in params_sh.items()},
                  "step": ()}
        seed_t = torch.zeros((), dtype=torch.int32, device=device)
        args = (params, opt_state, batch, seed_t)
        in_sh = (params_sh, opt_sh, batch_shardings, ())
        return Cell(arch, shape_name, spec.kind, fn, args, in_sh,
                    (0, 1), rules, meta, model)

    cache = _cache(model, B, S + cfg.block_size, device)
    with use_rules(rules, mesh):
        cache_sh = param_specs(model.cache_logical_axes(cache))

    if spec.kind == "prefill":
        if cfg.family == "encdec":
            def fn(params, cache, batch):
                # the reference's admit returns cross caches of the
                # source's length, whatever length the cache argument
                # holds (ENCDEC_DECODE_SRC): the port admits in place, so
                # into cross caches of that length
                B, S_src = batch["src_mask"].shape
                if cache["cross_k"].shape[2] != S_src:
                    fresh = model.init_cache(B, cache["k"].shape[2], S_src,
                                             cache["k"].dtype,
                                             device=cache["k"].device)
                    cache = {**cache, **{k: fresh[k] for k in (
                        "cross_k", "cross_v", "src_mask", "src_len")}}
                return model.admit(params, cache, batch["src_embeds"],
                                   batch["src_mask"])
        else:
            def fn(params, cache, batch):
                logits, new_cache = model.prefill(
                    params, batch["tokens"], batch["lengths"], cache,
                    mm_embeds=batch.get("mm_embeds"),
                    mm_mask=batch.get("mm_mask"), head_mode="last")
                return logits, new_cache
        args = (params, cache, batch)
        in_sh = (params_sh, cache_sh, batch_shardings)
        return Cell(arch, shape_name, spec.kind, fn, args, in_sh,
                    (1,), rules, meta, model)

    # decode / long_decode ------------------------------------------------
    c = batch["win_tokens"].shape[1]
    meta["chunk"] = c
    if real:
        cache["len"].fill_(S)

    if cfg.family == "ssm":
        def fn(params, cache, batch):
            logits, new_cache = model.advance_states(
                params, cache, batch["win_tokens"],
                torch.clamp(batch["win_valid"], max=1))
            return logits, new_cache
    else:
        def fn(params, cache, batch):
            logits, win_kv = model.chunk_forward(
                params, cache, batch["win_tokens"], batch["win_start"],
                batch["win_valid"])
            new_cache = model.freeze(cache, win_kv, batch["win_start"],
                                     batch["n_adv"])
            return logits, new_cache

    args = (params, cache, batch)
    in_sh = (params_sh, cache_sh, batch_shardings)
    return Cell(arch, shape_name, spec.kind, fn, args, in_sh, (1,), rules,
                meta, model)
