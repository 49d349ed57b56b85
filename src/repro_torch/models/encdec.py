"""Encoder–decoder LM (the SeamlessM4T backbone).

As in the JAX package, the modality frontend is a stub: ``encode`` takes
precomputed frame embeddings [B, S_src, d].  The decoder is a transformer
decoder with self-attention and cross-attention; block diffusion (and so
chunked decoding) applies to the decoder, with the cross-attention K/V
computed once at admission and cached.  Parameters keep the reference's
layout (``enc/…`` and ``dec/…`` stacks along a leading ``[L]`` axis), so
``params_from_jax`` carries the reference's weights across unchanged.

Serving is model-level, as in the reference (its ``ModelBackend`` does not
serve this family): ``admit`` (encode, fill the cross cache), then
``chunk_forward`` and ``freeze`` a window at a time.  The attention routes
of ``impl="kernel"`` (CUDA tensors launch the hand kernels, CPU tensors
run their plain versions):

* encoder self-attention: one block-diffusion call a layer with
  ``block_size = S_src`` (bidirectional) over keys ``< src_mask.sum(-1)``;
* the decoder's read of its slot cache ``[L, B, S, KVH, hd]``: the paged
  kernel on the slot view (B pages of S tokens, ``block_tables =
  arange(B)``, ``ctx_lens = len``);
* in-window self-attention: ``sdpa_partial``, plain;
* cross-attention: the paged kernel on the slot view of ``cross_k`` /
  ``cross_v`` with ``ctx_lens`` = the source lengths.

Those routes hold only for a ``src_mask`` that is a prefix (True exactly
below each row's length): ``admit`` checks it once and raises under
``impl="kernel"`` for any other mask.  ``impl="ref"`` runs the reference's
``flash_partial`` over any mask.  ``apply`` (training) always takes the
plain differentiable route, each layer under ``torch.utils.checkpoint``
when ``cfg.remat`` is set.  The caches are updated in place: their
``data_ptr()`` never changes.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.ops import (block_diffusion_attention,
                                     paged_chunk_attention)
from repro_torch.models.common import (ArchConfig, cache_axes, dense_init,
                                       embed_init)
from repro_torch.models.layers import (_checkpointed, attn_output,
                                       axes_attention, axes_mlp, axes_norm,
                                       block_causal_mask, causal_mask,
                                       combine_partials, embed_lookup,
                                       flash_partial, init_attention,
                                       init_mlp, init_norm, mlp_block,
                                       qkv_project, rms_norm, rope_for,
                                       sdpa_partial)
from repro_torch.models.transformer import _scatter_slots

IMPLS = ("kernel", "ref")


def _arange(B: int, n: int, device):
    return torch.arange(n, dtype=torch.int64, device=device)[None].expand(B, n)


class EncDecLM:
    def __init__(self, cfg: ArchConfig):
        if cfg.family != "encdec" or cfg.n_enc_layers <= 0:
            raise ValueError(f"EncDecLM needs an encdec config with encoder "
                             f"layers (got {cfg.family!r}, "
                             f"{cfg.n_enc_layers})")
        self.cfg = cfg
        self.n_periods = cfg.n_layers          # decoder depth

    # ------------------------------------------------------------------
    def init_params(self, generator: torch.Generator | None = None,
                    device="cuda") -> dict[str, torch.Tensor]:
        """Seeded random params in the reference's stacked layout, drawn on
        ``device`` (``"meta"`` allocates nothing).  ``generator`` defaults
        to one seeded with 0 on ``device``."""
        cfg = self.cfg
        if generator is None and torch.device(device).type != "meta":
            generator = torch.Generator(device=device).manual_seed(0)
        Le, Ld = cfg.n_enc_layers, cfg.n_layers
        params = {"embed": embed_init(generator, (cfg.vocab_size, cfg.d_model),
                                      cfg.pdt, device)}
        stacks = (("enc", Le, (("norm1", init_norm), ("attn", init_attention),
                               ("norm2", init_norm), ("mlp", init_mlp))),
                  ("dec", Ld, (("norm1", init_norm),
                               ("self_attn", init_attention),
                               ("norm_x", init_norm),
                               ("cross_attn", init_attention),
                               ("norm2", init_norm), ("mlp", init_mlp))))
        for stack, n, subs in stacks:
            for sub, fn in subs:
                for k, v in fn(generator, cfg, device, n).items():
                    params[f"{stack}/{sub}/{k}"] = v
            if stack == "enc":
                params["enc_norm/scale"] = init_norm(generator, cfg,
                                                     device)["scale"]
        params["final_norm/scale"] = init_norm(generator, cfg, device)["scale"]
        params["lm_head"] = dense_init(
            generator, (cfg.d_model, cfg.vocab_size), cfg.pdt, device)
        return params

    def logical_axes(self) -> dict:
        """The logical axes of every parameter, keyed as :meth:`init_params`
        keys it (the reference's axes, ``layers`` first on a stack)."""
        cfg = self.cfg
        axes = {"embed": ("vocab_p", "embed_p")}
        for stack, subs in (("enc", (("norm1", axes_norm),
                                     ("attn", axes_attention),
                                     ("norm2", axes_norm),
                                     ("mlp", axes_mlp))),
                            ("dec", (("norm1", axes_norm),
                                     ("self_attn", axes_attention),
                                     ("norm_x", axes_norm),
                                     ("cross_attn", axes_attention),
                                     ("norm2", axes_norm),
                                     ("mlp", axes_mlp)))):
            for sub, fn in subs:
                for k, v in fn(cfg).items():
                    axes[f"{stack}/{sub}/{k}"] = ("layers",) + v
        axes["enc_norm/scale"] = axes_norm(cfg)["scale"]
        axes["final_norm/scale"] = axes_norm(cfg)["scale"]
        axes["lm_head"] = ("embed_p", "vocab_p")
        return axes

    @staticmethod
    def cache_logical_axes(cache) -> dict:
        """The logical axes of the slot and cross caches, the reference's by
        leaf name (``src_prefix``, not a tensor, has none)."""
        def one(name, leaf):
            if name in ("k", "v", "cross_k", "cross_v"):
                return ("layers", "batch", "kv_seq", "kv_heads", "head_dim")
            if name == "len":
                return ("batch",)
            return ("batch",) + (None,) * (leaf.dim() - 1)
        return cache_axes(cache, one)

    @staticmethod
    def _sub(params, pre: str, l: int) -> dict:
        """Layer ``l``'s slice of the sub-block under ``pre`` ("dec/mlp/")."""
        return {k[len(pre):]: v[l] for k, v in params.items()
                if k.startswith(pre)}

    def _layers(self, body, x, n: int):
        """``x = body(x, l)`` for l < n, each layer under
        ``torch.utils.checkpoint`` when ``cfg.remat`` is set and autograd
        records (the reference's ``jax.checkpoint`` of the scan body)."""
        for l in range(n):
            if self.cfg.remat:
                x = _checkpointed(lambda x, l=l: body(x, l), x)
            else:
                x = body(x, l)
        return x

    # ------------------------------------------------------------------
    def encode(self, params, src_embeds, src_mask, *, impl: str = "kernel"):
        """Bidirectional encoder over frame embeddings [B, S, d] →
        [B, S, d] (after ``enc_norm``).  ``impl="kernel"`` takes
        ``src_mask`` as a prefix mask (keys ``< src_mask.sum(-1)``);
        ``impl="ref"`` runs the reference's ``flash_partial`` over it."""
        cfg = self.cfg
        B, S, _ = src_embeds.shape
        x = src_embeds.to(cfg.cdt)
        pos = _arange(B, S, x.device)
        src_mask = src_mask.to(device=x.device, dtype=torch.bool)
        lengths = src_mask.sum(-1).to(torch.int32)

        def body(x, l):
            p = self._sub(params, "enc/attn/", l)
            h = rms_norm(x, params["enc/norm1/scale"][l], cfg.norm_eps)
            q, k, v = qkv_project(p, cfg, h, pos)
            if impl == "kernel":
                out = block_diffusion_attention(q, k, v, lengths,
                                                block_size=S)
            else:
                out = combine_partials([flash_partial(
                    q, k, v, q_pos=pos, k_pos=pos, k_valid=src_mask,
                    kind="all")], x.dtype)
            x = x + attn_output(p, cfg, out)
            h = rms_norm(x, params["enc/norm2/scale"][l], cfg.norm_eps)
            return x + mlp_block(self._sub(params, "enc/mlp/", l), cfg, h)

        x = self._layers(body, x, cfg.n_enc_layers)
        return rms_norm(x, params["enc_norm/scale"], cfg.norm_eps)

    def _cross_kv(self, params, enc_out, pos):
        """Every decoder layer's cross-attention K/V of the encoder output
        → (k, v) [L, B, S_src, KVH, hd] (RoPE on k at the source
        positions, as the reference's ``qkv_project``)."""
        cfg = self.cfg
        B, S, _ = enc_out.shape
        ks, vs = [], []
        for l in range(cfg.n_layers):
            p = self._sub(params, "dec/cross_attn/", l)
            k = (enc_out @ p["wk"].to(cfg.cdt)).reshape(B, S, cfg.n_kv_heads,
                                                        cfg.hd)
            ks.append(rope_for(cfg, k, pos))
            vs.append((enc_out @ p["wv"].to(cfg.cdt)).reshape(
                B, S, cfg.n_kv_heads, cfg.hd))
        return torch.stack(ks), torch.stack(vs)

    def _decoder(self, params, x, positions, shared, per_layer):
        """The decoder stack → (x, ks, vs), ks/vs [L, B, T, KVH, hd] the
        window's self-attention K/V.

        ``shared``: ``impl``; ``self_flash`` (``apply``: kind, lengths) or
        ``self_mask`` (a window); ``cache_len``, ``src_mask`` (ref) or
        ``src_len`` (kernel), ``slot_tables``.  ``per_layer``: ``cross_k``,
        ``cross_v`` and, for a window, ``cache_k``, ``cache_v``."""
        cfg = self.cfg
        B, T, _ = x.shape
        kernel = shared["impl"] == "kernel"
        kv = []

        def cache_read(q, k, v, lens, valid):
            """The flash partial of q against a cached [B, S, KVH, hd]."""
            if kernel:
                return paged_chunk_attention(q, k, v, shared["slot_tables"],
                                             lens)
            return flash_partial(q, k, v, q_pos=positions,
                                 k_pos=_arange(B, k.shape[1], q.device),
                                 k_valid=valid, kind="all")

        def body(x, l):
            p = self._sub(params, "dec/self_attn/", l)
            h = rms_norm(x, params["dec/norm1/scale"][l], cfg.norm_eps)
            q, k, v = qkv_project(p, cfg, h, positions)
            parts = []
            if "cache_k" in per_layer:
                kc = per_layer["cache_k"][l].to(cfg.cdt)
                vc = per_layer["cache_v"][l].to(cfg.cdt)
                valid = None if kernel else \
                    _arange(B, kc.shape[1], x.device) \
                    < shared["cache_len"][:, None]
                parts.append(cache_read(q, kc, vc, shared["cache_len"],
                                        valid))
            sf = shared.get("self_flash")
            if sf is not None:
                parts.append(flash_partial(
                    q, k, v, q_pos=positions, k_pos=positions,
                    k_valid=_arange(B, T, x.device) < sf["lengths"][:, None],
                    kind=sf["kind"], block_size=cfg.block_size))
            else:
                parts.append(sdpa_partial(q, k, v, shared["self_mask"]))
            out = combine_partials(parts, x.dtype)
            x = x + attn_output(p, cfg, out)
            kv.append((k, v))

            # cross attention: q without RoPE, as in the reference
            p = self._sub(params, "dec/cross_attn/", l)
            h = rms_norm(x, params["dec/norm_x/scale"][l], cfg.norm_eps)
            qx = (h @ p["wq"].to(cfg.cdt)).reshape(B, T, cfg.n_heads, cfg.hd)
            part = cache_read(qx, per_layer["cross_k"][l].to(cfg.cdt),
                              per_layer["cross_v"][l].to(cfg.cdt),
                              shared.get("src_len"), shared.get("src_mask"))
            x = x + attn_output(p, cfg, combine_partials([part], x.dtype))

            h = rms_norm(x, params["dec/norm2/scale"][l], cfg.norm_eps)
            return x + mlp_block(self._sub(params, "dec/mlp/", l), cfg, h)

        x = self._layers(body, x, cfg.n_layers)
        return x, torch.stack([k for k, _ in kv]), torch.stack(
            [v for _, v in kv])

    def embed(self, params, tokens):
        return embed_lookup(params["embed"], tokens).to(self.cfg.cdt)

    def head(self, params, x):
        cfg = self.cfg
        x = rms_norm(x, params["final_norm/scale"], cfg.norm_eps)
        return (x @ params["lm_head"].to(cfg.cdt)).float()

    # ------------------------------------------------------------------
    def apply(self, params, src_embeds, src_mask, tgt_tokens,
              mask_mode="causal", tgt_lengths=None):
        """Training forward: encode + teacher-forced decode → logits
        [B, T, V] fp32, on the plain differentiable route (the reference's
        ``flash_partial`` everywhere; ``mask_mode`` is its kind: causal,
        block_causal or all)."""
        B, T = tgt_tokens.shape
        dev = tgt_tokens.device
        src_mask = src_mask.to(device=dev, dtype=torch.bool)
        enc_out = self.encode(params, src_embeds, src_mask, impl="ref")
        ck, cv = self._cross_kv(params, enc_out,
                                _arange(B, enc_out.shape[1], dev))
        lengths = tgt_lengths if tgt_lengths is not None else \
            torch.full((B,), T, dtype=torch.int32, device=dev)
        shared = {"impl": "ref", "src_mask": src_mask,
                  "self_flash": {"kind": mask_mode,
                                 "lengths": lengths.to(dev)}}
        x, _, _ = self._decoder(params, self.embed(params, tgt_tokens),
                                _arange(B, T, dev), shared,
                                {"cross_k": ck, "cross_v": cv})
        return self.head(params, x)

    # -- serving ---------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, src_len: int,
                   dtype=torch.bfloat16, device="cuda"):
        """Slot cache: ``len`` [batch] int32, ``k``/``v`` [L, batch,
        max_len, KVH, hd], the cross cache ``cross_k``/``cross_v`` [L,
        batch, src_len, KVH, hd], ``src_mask`` [batch, src_len] bool and
        ``src_len`` [batch] int32 (its row sums, the kernel route's key
        counts), and ``src_prefix`` (whether ``src_mask`` is a prefix mask,
        set by ``admit``)."""
        cfg = self.cfg
        shp = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
        xshp = (cfg.n_layers, batch, src_len, cfg.n_kv_heads, cfg.hd)
        z = lambda s, dt=dtype: torch.zeros(s, dtype=dt,  # noqa: E731
                                            device=device)
        return {"len": z((batch,), torch.int32), "k": z(shp), "v": z(shp),
                "cross_k": z(xshp), "cross_v": z(xshp),
                "src_mask": z((batch, src_len), torch.bool),
                "src_len": z((batch,), torch.int32), "src_prefix": True}

    def admit(self, params, cache, src_embeds, src_mask, *,
              impl: str = "kernel"):
        """Request admission: encode the source and fill the cross cache,
        ``src_mask``, ``src_len`` and ``len = 0``, in place.  Checks once
        whether ``src_mask`` is a prefix mask; under ``impl="kernel"`` a
        mask that is not raises ``ValueError``.  Returns the cache."""
        if impl not in IMPLS:
            raise ValueError(f"unknown impl {impl!r}")
        B, S = src_mask.shape
        if tuple(cache["cross_k"].shape[1:3]) != (B, S):
            raise ValueError(f"cache holds (batch, src_len) "
                             f"{tuple(cache['cross_k'].shape[1:3])}, the "
                             f"source is {(B, S)}")
        dev = cache["len"].device
        src_mask = src_mask.to(device=dev, dtype=torch.bool)
        src_len = src_mask.sum(-1).to(torch.int32)
        # a meta mask has no values (the dry run): taken as a prefix mask
        prefix = src_mask.is_meta or bool(torch.equal(
            src_mask, _arange(B, S, dev) < src_len[:, None]))
        if impl == "kernel" and not prefix:
            raise ValueError("src_mask is not a prefix mask (True exactly "
                             "below each row's length): the kernel route "
                             "reads keys < length; admit it with impl=\"ref\"")
        enc_out = self.encode(params, src_embeds.to(dev), src_mask, impl=impl)
        ck, cv = self._cross_kv(params, enc_out, _arange(B, S, dev))
        cache["cross_k"].copy_(ck)
        cache["cross_v"].copy_(cv)
        cache["src_mask"].copy_(src_mask)
        cache["src_len"].copy_(src_len)
        cache["len"].zero_()
        cache["src_prefix"] = prefix
        return cache

    def chunk_forward(self, params, cache, win_tokens, win_start, win_valid,
                      *, impl: str = "kernel"):
        """Diffusion-window forward against the slot cache and the cross
        cache: win_tokens [B,c], win_start [B], win_valid [B].  Returns
        (logits [B,c,V] fp32, {"k", "v"} [L,B,c,KVH,hd]); the cache is
        only read."""
        if impl not in IMPLS:
            raise ValueError(f"unknown impl {impl!r}")
        if impl == "kernel" and not cache["src_prefix"]:
            raise ValueError("the cache's src_mask is not a prefix mask: "
                             "the kernel route cannot read it")
        cfg = self.cfg
        B, c = win_tokens.shape
        dev = win_tokens.device
        offs = torch.arange(c, dtype=torch.int64, device=dev)
        positions = win_start.long()[:, None] + offs[None, :]
        valid = offs[None, :] < win_valid[:, None]
        if cfg.diffusion:
            sm = block_causal_mask(positions, positions, cfg.block_size)
        else:
            sm = causal_mask(positions, positions)
        sm = (sm & valid[:, None, :] & valid[:, :, None]) | \
            torch.eye(c, dtype=torch.bool, device=dev)[None]
        shared = {"impl": impl, "self_mask": sm[:, None],
                  "cache_len": cache["len"], "src_mask": cache["src_mask"],
                  "src_len": cache["src_len"],
                  "slot_tables": torch.arange(B, dtype=torch.int32,
                                              device=dev)[:, None]}
        per_layer = {name: cache[name] for name in
                     ("k", "v", "cross_k", "cross_v")}
        per_layer["cache_k"] = per_layer.pop("k")
        per_layer["cache_v"] = per_layer.pop("v")
        x, ks, vs = self._decoder(params, self.embed(params, win_tokens),
                                  positions, shared, per_layer)
        return self.head(params, x), {"k": ks, "v": vs}

    def freeze(self, cache, win_kv, win_start, n_adv):
        """Write the first n_adv[b] window KV entries into the slot cache
        and advance ``len``, in place.  Returns the cache."""
        c = win_kv["k"].shape[2]
        offs = torch.arange(c, dtype=torch.int64, device=win_start.device)
        keep = offs[None, :] < n_adv[:, None]
        idx = torch.where(keep, win_start.long()[:, None] + offs[None, :],
                          cache["k"].shape[2])
        _scatter_slots(cache["k"], win_kv["k"], idx)
        _scatter_slots(cache["v"], win_kv["v"], idx)
        cache["len"] += n_adv.to(torch.int32)
        return cache
