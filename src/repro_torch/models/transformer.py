"""Decoder-only LM, the dense, moe and vlm families, on the paged KV pool.

The serving entry points of the JAX package's ``TransformerLM`` for the
paged path, with the same arguments and results:

* ``prefill_chunk_paged`` — one resumable prefill chunk per row against the
  pages earlier chunks wrote; returns the last-position (conf, tok).
* ``chunk_forward_paged`` — diffusion-window forward against the paged
  prefix (block-causal inside the window).
* ``freeze_paged`` — write the leading committed window KV into the pool.
* ``decode_step_paged`` — the fused decode iteration: window forward +
  freeze + on-device confidence/argmax; only ``2·B·c`` scalars come back.
* ``prefill_paged`` — the wave prefill: one forward over a whole admission
  wave's prompts (block-causal attention, the block-diffusion kernel once
  per layer) that scatters their KV into the pool.

Every layer is attention then an FFN: the gated MLP, or the MoE block
(:mod:`repro_torch.models.moe`) when the config has experts; vlm configs
rotate q and k by M-RoPE and may replace token embeddings with
precomputed multimodal ones (``mm_embeds`` where ``mm_mask``).  The
recurrent families (ssm, hybrid) and encdec are not ported yet.

The layer stack is a Python loop over the stacked ``[L, …]`` params.  The
page pool ``{"k_pages", "v_pages"}`` ``[L,P,ps,KVH,hd]`` is updated **in
place** (the torch form of the JAX package's donated pool): every write
goes into a view of the same storage, so ``k_pages.data_ptr()`` never
changes, and the returned cache is the same dict of the same tensors.
Writes land after the forward, as in the reference.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.ops import (block_diffusion_attention,
                                     paged_chunk_attention,
                                     softmax_confidence_device)
from repro_torch.kernels.ref import block_diffusion_ref, paged_chunk_ref
from repro_torch.models.common import ArchConfig, dense_init, embed_init
from repro_torch.models.layers import (attn_output, block_causal_mask,
                                       causal_mask, combine_partials,
                                       init_attention, init_mlp, init_norm,
                                       mlp_block, qkv_project, rms_norm,
                                       sdpa_partial)
from repro_torch.models.moe import init_moe, moe_block

_BLOCK = "blocks/pos0/"


def _page_dest(block_tables, positions, keep, page_size: int, n_pages: int):
    """Flat page-pool destinations [B,T] for absolute token positions.

    ``keep`` masks live entries; everything else maps to the out-of-bounds
    sentinel ``n_pages * page_size``, which :func:`_scatter_pages` drops.
    Page indices are clipped into the table so padded rows never index out
    of bounds — their ``keep`` is False anyway.
    """
    W = block_tables.shape[1]
    pidx = torch.clamp(torch.div(positions, page_size, rounding_mode="floor"),
                       0, W - 1)
    page = torch.gather(block_tables.long(), 1, pidx.long())
    return torch.where(keep, page * page_size + positions % page_size,
                       n_pages * page_size)


def _scatter_pages(pages, new, dest):
    """pages [L,P,ps,KVH,hd] ← new [L,B,T,KVH,hd] at flat dest [B,T], in
    place.  Sentinel destinations (``>= P·ps``) are filtered out first — the
    JAX scatter's ``mode="drop"`` — and the rest are written into a flat
    view of the pool.  Distinct live destinations never collide."""
    L, P, ps, KVH, hd = pages.shape
    flat = pages.view(L, P * ps, KVH, hd)
    d = dest.reshape(-1)
    live = torch.nonzero(d < P * ps).squeeze(1)
    flat[:, d[live]] = new.to(pages.dtype).reshape(L, -1, KVH, hd)[:, live]
    return pages


def copy_pages(cache, src, dst):
    """Whole-page copy in place: ``cache[name][:, dst[i]] ← cache[name][:,
    src[i]]`` for every pool tensor (the copy-on-write move).  The gather
    reads every source before any write lands, so chained src/dst overlaps
    within one call are safe; duplicate (src, dst) pairs (the pow-2 index
    padding) are idempotent."""
    for arr in cache.values():
        arr[:, dst] = arr[:, src]
    return cache


def write_pages(cache, dst, k_new, v_new):
    """Whole-page host→device swap-in, in place: page ``dst[i]`` of the pool
    receives ``k_new[:, i]`` / ``v_new[:, i]`` ([L, n, ps, KVH, hd]);
    duplicate padded indices write identical data."""
    k, v = cache["k_pages"], cache["v_pages"]
    k[:, dst] = k_new.to(device=k.device, dtype=k.dtype)
    v[:, dst] = v_new.to(device=v.device, dtype=v.dtype)
    return cache


class TransformerLM:
    """Decoder-only LM of the attention-only families (paged serving
    path)."""

    PAGED_FAMILIES = ("dense", "moe", "vlm")
    _FFN_INIT = {"mlp": init_mlp, "moe": init_moe}

    def __init__(self, cfg: ArchConfig):
        if cfg.family not in self.PAGED_FAMILIES:
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported to repro_torch yet")
        self.cfg = cfg
        self.n_periods = cfg.n_layers

    def _positions(self):
        """(mixer, ffn) kinds of the one position in each layer."""
        return [("attn", "moe" if self.cfg.n_experts > 0 else "mlp")]

    # ------------------------------------------------------------------
    # Init
    # ------------------------------------------------------------------
    def init_params(self, generator: torch.Generator | None = None,
                    device="cuda") -> dict[str, torch.Tensor]:
        """Seeded random params in the JAX package's stacked layout, drawn
        on ``device`` (``"meta"`` allocates nothing).  ``generator``
        defaults to one seeded with 0 on ``device``."""
        cfg = self.cfg
        if generator is None and torch.device(device).type != "meta":
            generator = torch.Generator(device=device).manual_seed(0)
        n = self.n_periods
        params = {"embed": embed_init(generator, (cfg.vocab_size, cfg.d_model),
                                      cfg.pdt, device)}
        (_, ffn), = self._positions()
        for sub, fn in (("norm1", init_norm), ("mixer", init_attention),
                        ("norm2", init_norm), ("ffn", self._FFN_INIT[ffn])):
            for k, v in fn(generator, cfg, device, n).items():
                params[f"{_BLOCK}{sub}/{k}"] = v
        params["final_norm/scale"] = init_norm(generator, cfg, device)["scale"]
        if not cfg.tie_embeddings:
            params["lm_head"] = dense_init(
                generator, (cfg.d_model, cfg.vocab_size), cfg.pdt, device)
        return params

    @staticmethod
    def _sub(params, sub: str, l: int) -> dict:
        """Layer ``l``'s slice of one sub-block: {"wq": …} for "mixer"."""
        pre = f"{_BLOCK}{sub}/"
        return {k[len(pre):]: v[l] for k, v in params.items()
                if k.startswith(pre)}

    # ------------------------------------------------------------------
    # Embedding / head
    # ------------------------------------------------------------------
    def embed(self, params, tokens, mm_embeds=None, mm_mask=None):
        """Token embeddings [B,T,d]; where ``mm_mask`` [B,T] is set, the
        precomputed multimodal embeddings ``mm_embeds`` [B,T,d] instead."""
        cd = self.cfg.cdt
        x = params["embed"][tokens.long()].to(cd)
        if mm_embeds is not None:
            x = torch.where(mm_mask[..., None].to(x.device),
                            mm_embeds.to(device=x.device, dtype=cd), x)
        return x

    def head(self, params, x):
        cfg = self.cfg
        x = rms_norm(x, params["final_norm/scale"], cfg.norm_eps)
        w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        return (x @ w.to(cfg.cdt)).float()

    # ------------------------------------------------------------------
    # Layer stack
    # ------------------------------------------------------------------
    def _attn(self, p, x, positions, shared, page_k, page_v):
        """Attention mixer, in one of two forms chosen by ``shared``:

        * ``"self_flash"`` (wave prefill): block-causal attention over the
          whole position-aligned sequence, one block-diffusion call
          (kernel, or its plain version under ``impl == "ref"``); no paged
          prefix is read.
        * otherwise: the paged-prefix partial (kernel, or the plain version
          under ``paged_impl == "ref"``) combined exactly with the
          in-window partial.

        Returns (y, (k, v))."""
        cfg = self.cfg
        q, k, v = qkv_project(p, cfg, x, positions)
        sf = shared.get("self_flash")
        if sf is not None:
            fn = block_diffusion_ref if sf["impl"] == "ref" \
                else block_diffusion_attention
            out = fn(q, k, v, sf["lengths"], block_size=sf["block_size"])
            return attn_output(p, cfg, out), (k, v)
        fn = paged_chunk_ref if shared["paged_impl"] == "ref" \
            else paged_chunk_attention
        paged = fn(q, page_k.to(cfg.cdt), page_v.to(cfg.cdt),
                   shared["block_tables"], shared["ctx_lens"])
        window = sdpa_partial(q, k, v, shared["self_mask"])
        out = combine_partials([paged, window], x.dtype)
        return attn_output(p, cfg, out), (k, v)

    def _ffn_apply(self, kind, p, x):
        if kind == "mlp":
            return mlp_block(p, self.cfg, x)
        if kind == "moe":
            return moe_block(p, self.cfg, x)
        raise ValueError(kind)

    def _stack(self, params, x, positions, shared, cache):
        """Run the layer stack; returns (x, {"k", "v"} [L,B,T,KVH,hd])."""
        cfg = self.cfg
        (_, ffn), = self._positions()
        ks, vs = [], []
        for l in range(self.n_periods):
            h = rms_norm(x, params[f"{_BLOCK}norm1/scale"][l], cfg.norm_eps)
            y, (k, v) = self._attn(self._sub(params, "mixer", l), h,
                                   positions, shared, cache["k_pages"][l],
                                   cache["v_pages"][l])
            x = x + y
            h = rms_norm(x, params[f"{_BLOCK}norm2/scale"][l], cfg.norm_eps)
            x = x + self._ffn_apply(ffn, self._sub(params, "ffn", l), h)
            ks.append(k)
            vs.append(v)
        return x, {"k": torch.stack(ks), "v": torch.stack(vs)}

    def _window_masks(self, positions, valid, c):
        """In-window self mask [B,1,c,c]: block-causal (diffusion) or causal,
        restricted to valid slots, OR the identity so padded rows keep one
        finite logit."""
        cfg = self.cfg
        if cfg.diffusion:
            sm = block_causal_mask(positions, positions, cfg.block_size)
        else:
            sm = causal_mask(positions, positions)
        sm = sm & valid[:, None, :] & valid[:, :, None]
        sm = sm | torch.eye(c, dtype=torch.bool, device=positions.device)[None]
        return {"self_mask": sm[:, None]}

    # ------------------------------------------------------------------
    # Paged serving
    # ------------------------------------------------------------------
    def supports_paged(self) -> bool:
        return self.cfg.family in self.PAGED_FAMILIES

    def _check_paged(self):
        if not self.supports_paged():
            raise ValueError(
                f"paged KV serving needs an attention-only family "
                f"(got {self.cfg.family!r})")

    def paged_kv_dims(self) -> tuple[int, int, int]:
        """(n_kv_layers, n_kv_heads, head_dim) — the model-derived half of
        the page-pool shape."""
        return (self.n_periods, self.cfg.n_kv_heads, self.cfg.hd)

    def init_paged_cache(self, n_pages: int, page_size: int | None = None,
                         dtype=torch.float32, device="cuda"):
        """Page-pool cache: {'k_pages','v_pages'} [L,P,ps,KVH,hd]."""
        self._check_paged()
        ps = page_size if page_size is not None else self.cfg.kv_page_size
        L, KVH, hd = self.paged_kv_dims()
        shp = (L, n_pages, ps, KVH, hd)
        return {"k_pages": torch.zeros(shp, dtype=dtype, device=device),
                "v_pages": torch.zeros(shp, dtype=dtype, device=device)}

    def _paged_shared(self, positions, validm, c, block_tables, ctx_lens,
                      impl):
        shared = self._window_masks(positions, validm, c)
        shared.update(block_tables=block_tables.to(torch.int32),
                      ctx_lens=ctx_lens.to(torch.int32), paged_impl=impl)
        return shared

    def prefill_paged(self, params, cache, tokens, lengths, block_tables,
                      mm_embeds=None, mm_mask=None, head_mode: str = "logits",
                      *, impl: str = "kernel"):
        """Batched prompt forward writing KV into the page pool (wave
        prefill): the whole admission wave runs as ONE forward.

        tokens [B,T] (row-padded), lengths [B] (0 ⇒ batch-padding row, no
        writes), block_tables [B,W] int32.  Positions are ``0..T-1``; every
        layer's self-attention is one block-diffusion call, block-causal
        for diffusion models and causal (``block_size = 1``) otherwise.
        K/V of positions ``< lengths`` land in the pool in place.

        head_mode "logits" returns the last-valid-position logits [B,V]
        fp32; "sample" reduces them on device
        (:func:`softmax_confidence_device`) and returns (conf [B], tok
        [B]), so serving never ships [B,V] logits to the host.  Returns
        (head output, cache) — the same cache dict, updated in place.
        """
        self._check_paged()
        if head_mode not in ("logits", "sample"):
            raise ValueError(f"unknown head_mode {head_mode!r}")
        cfg = self.cfg
        B, T = tokens.shape
        dev = tokens.device
        positions = torch.arange(T, dtype=torch.int64,
                                 device=dev)[None].expand(B, T)
        lengths = lengths.to(device=dev, dtype=torch.int32)
        shared = {"self_flash": {
            "lengths": lengths, "impl": impl,
            "block_size": cfg.block_size if cfg.diffusion else 1}}
        x = self.embed(params, tokens, mm_embeds, mm_mask)
        x, kv = self._stack(params, x, positions, shared, cache)
        idx = torch.clamp(lengths.long() - 1, 0, T - 1)
        xl = x[torch.arange(B, device=dev), idx][:, None]
        logits = self.head(params, xl)[:, 0]
        P, ps = cache["k_pages"].shape[1], cache["k_pages"].shape[2]
        keep = positions < lengths[:, None]
        dest = _page_dest(block_tables, positions, keep, ps, P)
        _scatter_pages(cache["k_pages"], kv["k"], dest)
        _scatter_pages(cache["v_pages"], kv["v"], dest)
        if head_mode == "sample":
            return softmax_confidence_device(logits), cache
        return logits, cache

    def prefill_chunk_paged(self, params, cache, tokens, offsets, valid,
                            block_tables, *, impl: str = "kernel",
                            mm_embeds=None, mm_mask=None):
        """One resumable prefill chunk per row: forward prompt tokens
        [offsets, offsets + valid) against the pages already written by
        earlier chunks (``ctx_lens = offsets``), and write this chunk's KV
        into the pool.

        tokens [B,T] (row-padded), offsets [B], valid [B] (0 ⇒ padded row,
        no writes).  Returns (conf [B], tok [B], cache): the
        last-valid-position head reduced on device.
        """
        self._check_paged()
        B, T = tokens.shape
        dev = tokens.device
        offs = torch.arange(T, dtype=torch.int64, device=dev)
        positions = offsets.long()[:, None] + offs[None, :]
        validm = offs[None, :] < valid[:, None]
        shared = self._paged_shared(positions, validm, T, block_tables,
                                    offsets, impl)
        x = self.embed(params, tokens, mm_embeds, mm_mask)
        x, kv = self._stack(params, x, positions, shared, cache)
        idx = torch.clamp(valid.long() - 1, 0, T - 1)
        xl = x[torch.arange(B, device=dev), idx][:, None]
        logits = self.head(params, xl)[:, 0]
        P, ps = cache["k_pages"].shape[1], cache["k_pages"].shape[2]
        dest = _page_dest(block_tables, positions, validm, ps, P)
        _scatter_pages(cache["k_pages"], kv["k"], dest)
        _scatter_pages(cache["v_pages"], kv["v"], dest)
        conf, tok = softmax_confidence_device(logits)
        return conf, tok, cache

    def chunk_forward_paged(self, params, cache, win_tokens, win_start,
                            win_valid, block_tables, ctx_lens, *,
                            impl: str = "kernel", mm_embeds=None,
                            mm_mask=None):
        """Diffusion-window forward against the paged prefix cache.
        ctx_lens [B] is the committed prefix length per row (0 for padded
        rows — their paged partial is empty and the in-window diagonal
        keeps logits finite).  Returns (logits [B,c,V] fp32, win_kv)."""
        self._check_paged()
        B, c = win_tokens.shape
        offs = torch.arange(c, dtype=torch.int64, device=win_tokens.device)
        positions = win_start.long()[:, None] + offs[None, :]
        valid = offs[None, :] < win_valid[:, None]
        shared = self._paged_shared(positions, valid, c, block_tables,
                                    ctx_lens, impl)
        x = self.embed(params, win_tokens, mm_embeds, mm_mask)
        x, kv = self._stack(params, x, positions, shared, cache)
        return self.head(params, x), kv

    def freeze_paged(self, cache, win_kv, block_tables, win_start, n_adv):
        """Write the first n_adv[b] window KV entries into the page pool,
        in place."""
        c = win_kv["k"].shape[2]
        P, ps = cache["k_pages"].shape[1], cache["k_pages"].shape[2]
        offs = torch.arange(c, dtype=torch.int64, device=win_start.device)
        pos = win_start.long()[:, None] + offs[None, :]
        keep = offs[None, :] < n_adv[:, None]
        dest = _page_dest(block_tables, pos, keep, ps, P)
        _scatter_pages(cache["k_pages"], win_kv["k"], dest)
        _scatter_pages(cache["v_pages"], win_kv["v"], dest)
        return cache

    def decode_step_paged(self, params, cache, win_tokens, win_start,
                          win_valid, block_tables, ctx_lens, n_adv, *,
                          impl: str = "kernel", mm_embeds=None,
                          mm_mask=None):
        """One fused paged decode iteration: chunk-forward + freeze +
        on-device sampling.  ``n_adv`` [B] is the number of leading window
        KV entries to freeze (known before the step).  Returns (conf [B,c]
        fp32, tok [B,c] int32, cache) — the cache updated in place."""
        logits, win_kv = self.chunk_forward_paged(
            params, cache, win_tokens, win_start, win_valid, block_tables,
            ctx_lens, impl=impl, mm_embeds=mm_embeds, mm_mask=mm_mask)
        self.freeze_paged(cache, win_kv, block_tables, win_start, n_adv)
        conf, tok = softmax_confidence_device(logits)
        return conf, tok, cache
