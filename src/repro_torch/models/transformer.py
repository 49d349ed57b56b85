"""Decoder-only LM covering the dense / moe / vlm / hybrid / ssm families.

One parameter layout (the JAX package's: ``blocks/pos{j}/…`` stacked along
a leading period axis) and two serving caches, with the reference's
arguments and results.

The paged entry points, for the attention-only families (dense, moe, vlm):

* ``prefill_chunk_paged`` — one resumable prefill chunk per row against the
  pages earlier chunks wrote; returns the last-position (conf, tok).
* ``chunk_forward_paged`` — diffusion-window forward against the paged
  prefix (block-causal inside the window).
* ``freeze_paged`` — write the leading committed window KV into the pool.
* ``decode_step_paged`` — the fused decode iteration: window forward +
  freeze + on-device confidence/argmax; only ``2·B·c`` scalars come back.
* ``prefill_paged`` — the wave prefill: one forward over a whole admission
  wave's prompts that scatters their KV into the pool.

Each takes ``kv_shard`` (a ``KVShardSpec``) for a pool sharded over a
mesh: the cache then holds the shards' blocks, every paged read is
split-KV (:func:`repro_torch.distributed.collectives.split_kv_paged_partial`,
with the rows' stripe offsets ``shard_offs``), and every write stays on
its page's shard.

The dense-slot entry points, which the recurrent families (hybrid, ssm)
serve through (a fixed ``[L_attn, B, S, KVH, hd]`` slot cache plus the
recurrent ``states``):

* ``apply`` — full-sequence forward → logits.
* ``prefill`` — full-sequence forward that writes the slot KV, ``len`` and
  the recurrent states.
* ``chunk_forward`` — diffusion window against the slot cache and states.
* ``freeze`` — write leading window KV into the slot cache, advance ``len``.
* ``advance_states`` — run committed tokens: slot KV and ``len`` advance,
  the new recurrent states come back for the caller to merge.

Self-attention over a whole position-aligned sequence (``apply``,
``prefill``, ``prefill_paged``) is one block-diffusion call a layer (block
1 is causal, a block of T or more bidirectional).  ``apply(impl="train")``
is the training route instead: the reference's differentiable flash scans
(``flash_partial_aligned`` for causal and block-causal masks,
``flash_partial`` for bidirectional ones), each layer under
``torch.utils.checkpoint`` when ``cfg.remat`` is set; it reaches no hand
kernel, since neither has a backward pass.  A window reads its
prefix through the paged kernel: the page pool through block tables, or
the slot cache as B pages of S tokens (``block_tables = arange(B)``,
``ctx_lens = len``); the partial is combined exactly with the in-window
``sdpa_partial``.  CPU tensors (or ``impl="ref"``) run the kernels' plain
versions.  Hybrid (Jamba) layers run in periods of ``attn_period``
heterogeneous positions (one attention, the rest Mamba; MoE every
``moe_every``); ssm (RWKV6) has one time-mix and one channel-mix position.

The layer stack is a Python loop over the stacked ``[n, …]`` params.  The
caches are updated **in place** (the torch form of the JAX package's
donated buffers): every write goes into a view of the same storage, so
``data_ptr()`` of the page pool and of the slot cache never changes.
Writes land after the forward, as in the reference.
"""

from __future__ import annotations

import torch

from repro_torch.distributed.collectives import (scatter_pages_sharded,
                                                 shard_local_slots,
                                                 split_kv_paged_partial)
from repro_torch.kernels.ops import (block_diffusion_attention,
                                     paged_chunk_attention,
                                     softmax_confidence_device)
from repro_torch.kernels.ref import block_diffusion_ref, paged_chunk_ref
from repro_torch.models import ssm
from repro_torch.models.common import (ArchConfig, cache_axes, dense_init,
                                       embed_init)
from repro_torch.models.layers import (_checkpointed, attn_output,
                                       axes_attention, axes_mlp, axes_norm,
                                       block_causal_mask, causal_mask,
                                       combine_partials, embed_lookup,
                                       flash_partial, flash_partial_aligned,
                                       init_attention, init_mlp, init_norm,
                                       mlp_block, qkv_project, rms_norm,
                                       sdpa_partial)
from repro_torch.models.moe import axes_moe, init_moe, moe_block


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
    place.  Sentinel destinations (``>= P·ps``) are dropped — the JAX
    scatter's ``mode="drop"`` — with no read back to the host (no host
    sync, no shape that depends on values): a sentinel entry rewrites the
    first live entry's destination with that entry's own value (with no
    live entry, slot 0 with the value it holds), so repeated destinations
    receive equal values.  Distinct live destinations never collide."""
    L, P, ps, KVH, hd = pages.shape
    n = P * ps
    flat = pages.view(L, n, KVH, hd)
    d = dest.reshape(-1)
    if d.numel() == 0:
        return pages
    vals = new.to(pages.dtype).reshape(L, -1, KVH, hd)
    live = d < n
    first = torch.argmax(live.to(torch.int32)).reshape(1)
    any_live = live.any()
    d = torch.where(live, d, torch.where(any_live, d.index_select(0, first),
                                         0))
    fill = torch.where(any_live, vals.index_select(1, first), flat[:, :1])
    flat[:, d] = torch.where(live[None, :, None, None], vals, fill)
    return pages


def _scatter_paged(pages, new, dest, kv_shard=None):
    """Page-pool scatter, the shard-local variant when the pool is sharded
    (``kv_shard``: a ``KVShardSpec``, ``pages`` the shards' blocks) — each
    shard drops out-of-shard destinations, so no KV crosses shards and
    every block is written in place.

    COW safety: the allocator's ``ensure_private`` runs *before* any
    dispatch that writes a page, so every written page is refcount-1."""
    if kv_shard is None:
        return _scatter_pages(pages, new, dest)
    return scatter_pages_sharded(pages, new, dest, kv_shard)


def _pool_dims(pages, kv_shard=None) -> tuple[int, int]:
    """(global page count, page size) of a pool: one tensor, or with
    ``kv_shard`` the shards' equal blocks."""
    if kv_shard is None:
        return pages.shape[1], pages.shape[2]
    return kv_shard.n_shards * pages[0].shape[1], pages[0].shape[2]


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




def _scatter_slots(cache_kv, new, idx):
    """Slot cache [L,B,S,KVH,hd] ← new [L,B,T,KVH,hd] at positions idx [B,T],
    in place; positions ``>= S`` are dropped (the reference's one-hot
    scatter writes nothing there).  The cache read as B pages of S tokens:
    :func:`_scatter_pages` on row ``b``'s page, so no host sync."""
    B, S = cache_kv.shape[1:3]
    rows = torch.arange(B, device=idx.device)[:, None]
    _scatter_pages(cache_kv, new, torch.where(idx < S, rows * S + idx,
                                              B * S))
    return cache_kv


def _layer(tree, l: int):
    """Layer ``l``'s slice of a ``{name: [n, …]}`` state dict."""
    return {k: v[l] for k, v in tree.items()}


class TransformerLM:
    """Family-dispatching decoder-only LM."""

    PAGED_FAMILIES = ("dense", "moe", "vlm")
    FAMILIES = PAGED_FAMILIES + ("hybrid", "ssm")
    _MIXER_INIT = {"attn": init_attention, "mamba": ssm.init_mamba,
                   "rwkv_tm": ssm.init_rwkv_timemix}
    _FFN_INIT = {"mlp": init_mlp, "moe": init_moe,
                 "rwkv_cm": ssm.init_rwkv_chanmix}
    _MIXER_AXES = {"attn": axes_attention, "mamba": ssm.axes_mamba,
                   "rwkv_tm": ssm.axes_rwkv_timemix}
    _FFN_AXES = {"mlp": axes_mlp, "moe": axes_moe,
                 "rwkv_cm": ssm.axes_rwkv_chanmix}

    def __init__(self, cfg: ArchConfig):
        if cfg.family not in self.FAMILIES:
            raise ValueError(f"TransformerLM does not take family "
                             f"{cfg.family!r} (build_model builds the "
                             f"encdec family as EncDecLM)")
        self.cfg = cfg
        if cfg.family == "hybrid":
            if not (cfg.attn_period > 0
                    and cfg.n_layers % cfg.attn_period == 0):
                raise ValueError(f"hybrid: {cfg.n_layers} layers are not "
                                 f"whole periods of {cfg.attn_period}")
            self.n_periods = cfg.n_layers // cfg.attn_period
        else:
            self.n_periods = cfg.n_layers

    # ------------------------------------------------------------------
    # Layer-position structure
    # ------------------------------------------------------------------
    def _positions(self):
        """(mixer, ffn) kinds of each position inside one period."""
        cfg = self.cfg
        if cfg.family == "hybrid":
            return [("attn" if cfg.is_attn_layer(j) else "mamba",
                     "moe" if cfg.is_moe_layer(j) else "mlp")
                    for j in range(cfg.attn_period)]
        if cfg.family == "ssm":
            return [("rwkv_tm", "rwkv_cm")]
        return [("attn", "moe" if cfg.n_experts > 0 else "mlp")]

    def attn_positions(self):
        return [j for j, (m, _) in enumerate(self._positions()) if m == "attn"]

    @property
    def has_kv(self):
        return bool(self.attn_positions())

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
        for j, (mixer, ffn) in enumerate(self._positions()):
            for sub, fn in (("norm1", init_norm),
                            ("mixer", self._MIXER_INIT[mixer]),
                            ("norm2", init_norm),
                            ("ffn", self._FFN_INIT[ffn])):
                for k, v in fn(generator, cfg, device, n).items():
                    params[f"blocks/pos{j}/{sub}/{k}"] = v
        params["final_norm/scale"] = init_norm(generator, cfg, device)["scale"]
        if not cfg.tie_embeddings:
            params["lm_head"] = dense_init(
                generator, (cfg.d_model, cfg.vocab_size), cfg.pdt, device)
        return params

    def logical_axes(self) -> dict:
        """The logical axes of every parameter, keyed as :meth:`init_params`
        keys it (the reference's axes, ``layers`` first on a stack)."""
        cfg = self.cfg
        axes = {"embed": ("vocab_p", "embed_p")}
        for j, (mixer, ffn) in enumerate(self._positions()):
            for sub, fn in (("norm1", axes_norm),
                            ("mixer", self._MIXER_AXES[mixer]),
                            ("norm2", axes_norm),
                            ("ffn", self._FFN_AXES[ffn])):
                for k, v in fn(cfg).items():
                    axes[f"blocks/pos{j}/{sub}/{k}"] = ("layers",) + v
        axes["final_norm/scale"] = axes_norm(cfg)["scale"]
        if not cfg.tie_embeddings:
            axes["lm_head"] = ("embed_p", "vocab_p")
        return axes

    @staticmethod
    def cache_logical_axes(cache) -> dict:
        """The logical axes of a slot or page-pool cache (``kv_seq`` and
        ``kv_pages`` are the split-KV axes), the reference's by leaf
        name."""
        def one(name, leaf):
            if name in ("k", "v"):
                return ("layers", "batch", "kv_seq", "kv_heads", "head_dim")
            if name in ("k_pages", "v_pages"):
                return ("layers", "kv_pages", None, "kv_heads", "head_dim")
            if name == "len":
                return ("batch",)
            if name == "wkv":
                return ("layers", "batch", "heads", None, None)
            if name == "conv":
                return ("layers", "batch", None, "mlp")
            if name == "ssm":
                return ("layers", "batch", "mlp", None)
            return ("layers", "batch") + (None,) * (leaf.dim() - 2)
        return cache_axes(cache, one)

    @staticmethod
    def _sub(params, j: int, sub: str, l: int) -> dict:
        """Period ``l``'s slice of position ``j``'s sub-block: {"wq": …} for
        "mixer"."""
        pre = f"blocks/pos{j}/{sub}/"
        return {k[len(pre):]: v[l] for k, v in params.items()
                if k.startswith(pre)}

    # ------------------------------------------------------------------
    # Embedding / head
    # ------------------------------------------------------------------
    def embed(self, params, tokens, mm_embeds=None, mm_mask=None):
        """Token embeddings [B,T,d]; where ``mm_mask`` [B,T] is set, the
        precomputed multimodal embeddings ``mm_embeds`` [B,T,d] instead."""
        cd = self.cfg.cdt
        x = embed_lookup(params["embed"], tokens).to(cd)
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
    def _attn(self, p, x, positions, shared, lx, l: int):
        """Attention mixer of period ``l``, in one of two forms chosen by
        ``shared``:

        * ``"self_flash"``: attention over the whole position-aligned
          sequence, one block-diffusion call; no cache is read.  Under
          ``impl == "train"`` the reference's flash scans instead
          (``_mixer_apply``'s ``self_flash`` branch).
        * otherwise: the prefix partial — the slot cache (``lx["cache_k"]``,
          keys ``< cache_len``) or the page pool (``lx["page_k"]``) through
          the paged kernel — combined exactly with the in-window partial.

        ``shared["impl"] == "ref"`` runs the kernels' plain versions.
        Returns (y, (k, v))."""
        cfg = self.cfg
        ref = shared["impl"] == "ref"
        q, k, v = qkv_project(p, cfg, x, positions)
        sf = shared.get("self_flash")
        if sf is not None and shared["impl"] == "train":
            lengths = sf["lengths"]
            if sf["kind"] in ("causal", "block_causal"):
                part = flash_partial_aligned(q, k, v, lengths=lengths,
                                             kind=sf["kind"],
                                             block_size=cfg.block_size)
            else:
                pos = positions if positions.dim() == 2 else positions[:, 0]
                T = pos.shape[1]
                part = flash_partial(
                    q, k, v, q_pos=pos, k_pos=pos,
                    k_valid=torch.arange(T, device=pos.device)[None, :]
                    < lengths[:, None], kind=sf["kind"],
                    block_size=cfg.block_size)
            out = combine_partials([part], x.dtype)
            return attn_output(p, cfg, out), (k, v)
        if sf is not None:
            fn = block_diffusion_ref if ref else block_diffusion_attention
            out = fn(q, k, v, sf["lengths"], block_size=sf["block_size"])
            return attn_output(p, cfg, out), (k, v)
        fn = paged_chunk_ref if ref else paged_chunk_attention
        parts = []
        if "cache_k" in lx:
            # layer l's slot cache [B,S,KVH,hd] is B pages of S tokens
            parts.append(fn(q, lx["cache_k"][l].to(cfg.cdt),
                            lx["cache_v"][l].to(cfg.cdt),
                            shared["slot_tables"], shared["cache_len"]))
        if "page_k" in lx and "kv_shard" in shared:
            # sharded pool: split-KV over the shards' blocks, the partials
            # merged exactly across them
            parts.append(split_kv_paged_partial(
                q, [b[l].to(cfg.cdt) for b in lx["page_k"]],
                [b[l].to(cfg.cdt) for b in lx["page_v"]],
                shared["block_tables"], shared["ctx_lens"],
                shared["shard_offs"], shared["kv_shard"],
                impl="ref" if ref else "kernel",
                local=shared["shard_local"]))
        elif "page_k" in lx:
            parts.append(fn(q, lx["page_k"][l].to(cfg.cdt),
                            lx["page_v"][l].to(cfg.cdt),
                            shared["block_tables"], shared["ctx_lens"]))
        parts.append(sdpa_partial(q, k, v, shared["self_mask"]))
        out = combine_partials(parts, x.dtype)
        return attn_output(p, cfg, out), (k, v)

    def _ffn_apply(self, kind, p, x):
        if kind == "mlp":
            return mlp_block(p, self.cfg, x)
        if kind == "moe":
            return moe_block(p, self.cfg, x)
        raise ValueError(kind)

    def _stack(self, params, x, positions, shared, per_layer):
        """Run the layer stack.

        ``per_layer``: ``{"pos{j}": {...}, "ffn{j}": {...}}`` with leaves of
        leading dim ``n_periods`` — attention caches (``cache_k``/``page_k``
        and their v) and recurrent states (``"state"``: {name: tensor}).
        Returns (x, kvs, states): kvs ``{"pos{j}": (k, v)}`` stacked
        [n_periods, B, T, KVH, hd], states ``{"pos{j}"|"ffn{j}": {name:
        [n_periods, …]}}``.  On the training route with ``cfg.remat``
        each period runs under ``torch.utils.checkpoint`` (the reference's
        ``jax.checkpoint`` of the scan body)."""
        remat = self.cfg.remat and shared["impl"] == "train"
        kv_out, st_out = {}, {}
        for l in range(self.n_periods):
            if remat:
                x, kvs, sts = _checkpointed(
                    lambda x, l=l: self._period(params, x, positions, shared,
                                                per_layer, l), x)
            else:
                x, kvs, sts = self._period(params, x, positions, shared,
                                           per_layer, l)
            for key, kv in kvs.items():
                kv_out.setdefault(key, []).append(kv)
            for key, st in sts.items():
                st_out.setdefault(key, []).append(st)
        kvs = {key: (torch.stack([k for k, _ in kv]),
                     torch.stack([v for _, v in kv]))
               for key, kv in kv_out.items()}
        states = {key: {name: torch.stack([s[name] for s in sts])
                        for name in sts[0]}
                  for key, sts in st_out.items()}
        return x, kvs, states

    def _period(self, params, x, positions, shared, per_layer, l: int):
        """Period ``l`` of the layer stack → (x, {"pos{j}": (k, v)},
        {"pos{j}"|"ffn{j}": state})."""
        cfg = self.cfg
        kv_out, st_out = {}, {}
        for j, (mixer, ffn) in enumerate(self._positions()):
            lx = per_layer.get(f"pos{j}", {})
            pre = f"blocks/pos{j}/"
            h = rms_norm(x, params[f"{pre}norm1/scale"][l], cfg.norm_eps)
            p = self._sub(params, j, "mixer", l)
            if mixer == "attn":
                y, kv_out[f"pos{j}"] = self._attn(p, h, positions, shared,
                                                  lx, l)
            else:
                seq = ssm.mamba_seq if mixer == "mamba" else ssm.rwkv_timemix
                y, st_out[f"pos{j}"] = seq(p, cfg, h, _layer(lx["state"], l))
            x = x + y
            h = rms_norm(x, params[f"{pre}norm2/scale"][l], cfg.norm_eps)
            p = self._sub(params, j, "ffn", l)
            if ffn == "rwkv_cm":
                y, st_out[f"ffn{j}"] = ssm.rwkv_chanmix(
                    p, cfg, h, _layer(per_layer[f"ffn{j}"]["state"], l))
            else:
                y = self._ffn_apply(ffn, p, h)
            x = x + y
        return x, kv_out, st_out

    def _collect_kv(self, kvs):
        """kvs from the stack → {"k", "v"} [L_attn, B, T, KVH, hd] (attention
        positions in order), or None for a model without attention."""
        ks = [kvs[f"pos{j}"][0] for j in self.attn_positions()]
        vs = [kvs[f"pos{j}"][1] for j in self.attn_positions()]
        if not ks:
            return None
        return {"k": torch.cat(ks), "v": torch.cat(vs)}

    def _window_masks(self, positions, valid, c, cache=None):
        """In-window self mask [B,1,c,c]: block-causal (diffusion) or causal,
        restricted to valid slots, OR the identity so padded rows keep one
        finite logit.  With a slot ``cache`` that holds KV, also its
        ``cache_len`` and the one-page-a-row tables of its slot view."""
        cfg = self.cfg
        if cfg.diffusion:
            sm = block_causal_mask(positions, positions, cfg.block_size)
        else:
            sm = causal_mask(positions, positions)
        sm = sm & valid[:, None, :] & valid[:, :, None]
        sm = sm | torch.eye(c, dtype=torch.bool, device=positions.device)[None]
        shared = {"self_mask": sm[:, None]}
        if cache is not None and self.has_kv and "k" in cache:
            B = positions.shape[0]
            shared["cache_len"] = cache["len"]
            shared["slot_tables"] = torch.arange(
                B, dtype=torch.int32, device=positions.device)[:, None]
        return shared

    @staticmethod
    def _flash_block(mask_mode: str, block_size: int, T: int) -> int:
        """The block-diffusion block size that gives ``mask_mode``: 1 is
        causal, the model's block is block-causal, T is bidirectional."""
        return {"causal": 1, "block_causal": block_size,
                "bidirectional": max(T, 1)}[mask_mode]

    # ------------------------------------------------------------------
    # Recurrent-state helpers
    # ------------------------------------------------------------------
    def _fresh_states(self, kind, B, dtype, *, device):
        """Zero states of every period for one recurrent position: mamba
        ``conv`` and rwkv ``tm_prev``/``cm_prev`` at ``dtype``, ``ssm`` and
        ``wkv`` fp32 (the rwkv state split across its two positions)."""
        cfg = self.cfg
        if kind == "mamba":
            st = ssm.mamba_init_state(cfg, B, dtype, device=device)
        elif kind == "rwkv_tm":
            st = ssm.rwkv_init_state(cfg, B, dtype, device=device)
            st = {"tm_prev": st["tm_prev"], "wkv": st["wkv"]}
        elif kind == "rwkv_cm":
            st = {"cm_prev": ssm.rwkv_init_state(cfg, B, dtype,
                                                 device=device)["cm_prev"]}
        else:
            raise ValueError(kind)
        n = self.n_periods
        return {k: v[None].repeat((n,) + (1,) * v.dim())
                for k, v in st.items()}

    def _state_xs(self, B, dtype, cache=None, *, device):
        """Per-position recurrent-state inputs: fresh on ``device``, or the
        cache's."""
        out = {}
        for j, (mixer, ffn) in enumerate(self._positions()):
            if mixer in ("mamba", "rwkv_tm"):
                out[f"pos{j}"] = {"state": cache["states"][f"pos{j}"] if cache
                                  else self._fresh_states(mixer, B, dtype,
                                                          device=device)}
            if ffn == "rwkv_cm":
                out[f"ffn{j}"] = {"state": cache["states"][f"ffn{j}"] if cache
                                  else self._fresh_states("rwkv_cm", B, dtype,
                                                          device=device)}
        return out

    def _cache_xs(self, cache):
        """Per-position slot-cache inputs of the attention positions."""
        if not (self.has_kv and "k" in cache):
            return {}
        return {f"pos{j}": {"cache_k": cache["k"], "cache_v": cache["v"]}
                for j in self.attn_positions()}

    def _recurrent_xs(self, cache, B):
        return {**self._cache_xs(cache),
                **self._state_xs(B, self.cfg.cdt, cache=cache
                                 if "states" in cache else None,
                                 device=cache["len"].device)}

    # ------------------------------------------------------------------
    # Dense-slot entry points
    # ------------------------------------------------------------------
    def apply(self, params, tokens, positions=None, mask_mode="causal",
              lengths=None, mm_embeds=None, mm_mask=None, *,
              impl: str = "kernel"):
        """Full forward → logits [B,T,V] fp32.  ``mask_mode``: causal,
        block_causal or bidirectional, over keys ``< lengths``; positions
        [B, T], or [B, 3, T] for M-RoPE (they reach only the rotary
        embedding: the mask is over the aligned positions 0..T-1, as in the
        reference).

        ``impl``: "kernel" (one block-diffusion kernel call a layer on CUDA
        tensors, its plain version on CPU ones), "ref" (the plain version),
        or "train", the training route (the reference's differentiable
        flash scans, no hand kernel; remat when ``cfg.remat``)."""
        if impl not in ("kernel", "ref", "train"):
            raise ValueError(f"unknown impl {impl!r}")
        B, T = tokens.shape
        dev = tokens.device
        if positions is None:
            positions = torch.arange(T, dtype=torch.int64,
                                     device=dev)[None].expand(B, T)
        if lengths is None:
            lengths = torch.full((B,), T, dtype=torch.int32, device=dev)
        shared = {"impl": impl, "self_flash": {
            "lengths": lengths.to(device=dev, dtype=torch.int32),
            "kind": {"causal": "causal", "block_causal": "block_causal",
                     "bidirectional": "all"}[mask_mode],
            "block_size": self._flash_block(mask_mode, self.cfg.block_size,
                                            T)}}
        x = self.embed(params, tokens, mm_embeds, mm_mask)
        per_layer = self._state_xs(B, x.dtype, device=dev)
        x, _, _ = self._stack(params, x, positions, shared, per_layer)
        return self.head(params, x)

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16,
                   device="cuda"):
        """Slot cache: ``len`` [batch] int32, ``k``/``v`` [L_attn, batch,
        max_len, KVH, hd] when the model has attention, and ``states``
        (``{"pos{j}"|"ffn{j}": {name: [n_periods, batch, …]}}``) when it has
        recurrent layers."""
        cfg = self.cfg
        cache = {"len": torch.zeros((batch,), dtype=torch.int32,
                                    device=device)}
        if self.has_kv:
            shp = (self.n_periods * len(self.attn_positions()), batch,
                   max_len, cfg.n_kv_heads, cfg.hd)
            cache["k"] = torch.zeros(shp, dtype=dtype, device=device)
            cache["v"] = torch.zeros(shp, dtype=dtype, device=device)
        states = self._state_xs(batch, dtype, device=device)
        if states:
            cache["states"] = {k: v["state"] for k, v in states.items()}
        return cache

    def prefill(self, params, tokens, lengths, cache, positions=None,
                mask_mode=None, mm_embeds=None, mm_mask=None,
                head_mode="all", *, impl: str = "kernel"):
        """Forward the prompt from fresh states.  Returns (logits, cache).

        Writes, in place: the slot KV (positions ``< lengths``, the rest of
        each row zeroed), ``len = lengths``, and — when ``cache`` holds
        ``states`` — the new recurrent states (a caller may pass views of
        one slot's rows).  The returned cache is ``cache`` with ``states``
        set to the new states.  head_mode: "all" → logits for every
        position; "last" → the last valid position's; "none" → no logits.
        """
        cfg = self.cfg
        B, T = tokens.shape
        dev = tokens.device
        if positions is None:
            positions = torch.arange(T, dtype=torch.int64,
                                     device=dev)[None].expand(B, T)
        if mask_mode is None:
            mask_mode = "block_causal" if cfg.diffusion else "causal"
        lengths = lengths.to(device=dev, dtype=torch.int32)
        shared = {"impl": impl, "self_flash": {
            "lengths": lengths,
            "block_size": self._flash_block(mask_mode, cfg.block_size, T)}}
        x = self.embed(params, tokens, mm_embeds, mm_mask)
        per_layer = self._state_xs(B, x.dtype, device=dev)
        x, kvs, states = self._stack(params, x, positions, shared, per_layer)
        if head_mode == "last":
            idx = torch.clamp(lengths.long() - 1, 0, T - 1)
            logits = self.head(params, x[torch.arange(B, device=dev), idx][
                :, None])
        elif head_mode == "none":
            logits = None
        else:
            logits = self.head(params, x)

        kv = self._collect_kv(kvs)
        if kv is not None and "k" in cache:
            keep = torch.arange(T, device=dev)[None, :] < lengths[:, None]
            for name in ("k", "v"):
                cache[name][:, :, :T] = torch.where(
                    keep[None, :, :, None, None], kv[name], 0)
                cache[name][:, :, T:] = 0
        if states and "states" in cache:
            for key, st in states.items():
                for name, t in st.items():
                    cache["states"][key][name].copy_(t)
        cache["len"].copy_(lengths)
        new_cache = dict(cache)
        if states:
            new_cache["states"] = states
        return logits, new_cache

    def prefill_slot(self, params, cache, tokens, length, slot, *,
                     impl: str = "kernel"):
        """Admit one prompt into row ``slot`` of the slot cache: the
        reference's recurrent-slot ``_prefill_impl`` (``jnp.take`` of the
        slot, then ``.at[:, slot].set``).  tokens [T] (the prompt padded
        to the cache's ``max_len``: the states run over the padding, as in
        the reference), length [1] int32, slot [1] int64 — all device
        tensors, so one captured graph serves every slot and prompt length.
        :meth:`prefill` runs on a batch-1 scratch sub-cache (it rewrites
        every KV row, ``len`` and state), whose rows ``index_copy_`` then
        writes into the cache in place.  Returns (the last valid position's
        logits [V] fp32, cache)."""
        sub = {"len": cache["len"].new_zeros(1)}
        for name in ("k", "v"):
            if name in cache:
                t = cache[name]
                sub[name] = t.new_zeros(t.shape[:1] + (1,) + t.shape[2:])
        if "states" in cache:
            sub["states"] = {
                key: {name: t.new_zeros(t.shape[:1] + (1,) + t.shape[2:])
                      for name, t in st.items()}
                for key, st in cache["states"].items()}
        logits, _ = self.prefill(params, tokens[None], length, sub,
                                 head_mode="last", impl=impl)
        for name in ("k", "v"):
            if name in cache:
                cache[name].index_copy_(1, slot, sub[name])
        for key, st in cache.get("states", {}).items():
            for name, t in st.items():
                t.index_copy_(1, slot, sub["states"][key][name])
        cache["len"].index_copy_(0, slot, sub["len"])
        return logits[0, 0], cache

    def chunk_forward(self, params, cache, win_tokens, win_start, win_valid,
                      mm_embeds=None, mm_mask=None, *, impl: str = "kernel"):
        """Diffusion-window forward against the slot cache and states.

        win_tokens [B,c] (mask token at uncommitted positions), win_start
        [B] (the window's first position), win_valid [B] (valid window
        slots).  Returns (logits [B,c,V] fp32, win_kv {"k": [L_attn,B,c,KVH,
        hd], "v"} or None); the cache is only read.
        """
        B, c = win_tokens.shape
        offs = torch.arange(c, dtype=torch.int64, device=win_tokens.device)
        positions = win_start.long()[:, None] + offs[None, :]
        valid = offs[None, :] < win_valid[:, None]
        shared = self._window_masks(positions, valid, c, cache)
        shared["impl"] = impl
        x = self.embed(params, win_tokens, mm_embeds, mm_mask)
        x, kvs, _ = self._stack(params, x, positions, shared,
                                self._recurrent_xs(cache, B))
        return self.head(params, x), self._collect_kv(kvs)

    def freeze(self, cache, win_kv, win_start, n_adv):
        """Write the first n_adv[b] window KV entries into the slot cache
        and advance ``len``, in place.  Returns the cache."""
        if win_kv is not None and "k" in cache:
            c = win_kv["k"].shape[2]
            offs = torch.arange(c, dtype=torch.int64, device=win_start.device)
            keep = offs[None, :] < n_adv[:, None]
            idx = torch.where(keep, win_start.long()[:, None] + offs[None, :],
                              cache["k"].shape[2])
            _scatter_slots(cache["k"], win_kv["k"], idx)
            _scatter_slots(cache["v"], win_kv["v"], idx)
        cache["len"] += n_adv.to(torch.int32)
        return cache

    def advance_states(self, params, cache, tokens, lengths, mm_embeds=None,
                       mm_mask=None, *, impl: str = "kernel"):
        """Run committed ``tokens`` [B,T] from position ``cache['len']``:
        rwkv's AR step, or a hybrid block commit (which also rewrites the
        block's attention KV).  Writes, in place, the slot KV of the first
        ``lengths[b]`` tokens and ``len += lengths``.  Returns (logits
        [B,T,V] fp32, new cache): ``cache`` with ``states`` replaced by the
        advanced states of every row (the cache's own states are left as
        they were, for the caller to merge under its slot mask)."""
        B, T = tokens.shape
        offs = torch.arange(T, dtype=torch.int64, device=tokens.device)
        positions = cache["len"].long()[:, None] + offs[None, :]
        valid = offs[None, :] < lengths[:, None]
        shared = self._window_masks(positions, valid, T, cache)
        shared["impl"] = impl
        x = self.embed(params, tokens, mm_embeds, mm_mask)
        x, kvs, states = self._stack(params, x, positions, shared,
                                     self._recurrent_xs(cache, B))
        logits = self.head(params, x)

        kv = self._collect_kv(kvs)
        if kv is not None and "k" in cache:
            idx = torch.where(valid, positions, cache["k"].shape[2])
            _scatter_slots(cache["k"], kv["k"], idx)
            _scatter_slots(cache["v"], kv["v"], idx)
        cache["len"] += lengths.to(torch.int32)
        new_cache = dict(cache)
        if states:
            new_cache["states"] = states
        return logits, new_cache

    # ------------------------------------------------------------------
    # Paged serving (attention-only families)
    # ------------------------------------------------------------------
    def supports_paged(self) -> bool:
        return self.cfg.family in self.PAGED_FAMILIES and self.has_kv

    def _check_paged(self):
        if not self.supports_paged():
            raise ValueError(
                f"paged KV serving needs an attention-only family "
                f"(got {self.cfg.family!r})")

    def paged_kv_dims(self) -> tuple[int, int, int]:
        """(n_kv_layers, n_kv_heads, head_dim) — the model-derived half of
        the page-pool shape."""
        return (self.n_periods * len(self.attn_positions()),
                self.cfg.n_kv_heads, self.cfg.hd)

    def init_paged_cache(self, n_pages: int, page_size: int | None = None,
                         dtype=torch.float32, device="cuda"):
        """Page-pool cache: {'k_pages','v_pages'} [L,P,ps,KVH,hd]."""
        self._check_paged()
        ps = page_size if page_size is not None else self.cfg.kv_page_size
        L, KVH, hd = self.paged_kv_dims()
        shp = (L, n_pages, ps, KVH, hd)
        return {"k_pages": torch.zeros(shp, dtype=dtype, device=device),
                "v_pages": torch.zeros(shp, dtype=dtype, device=device)}

    def _page_xs(self, cache):
        return {f"pos{j}": {"page_k": cache["k_pages"],
                            "page_v": cache["v_pages"]}
                for j in self.attn_positions()}

    def _paged_stack(self, params, x, positions, shared, cache):
        """The layer stack over the page pool → (x, {"k", "v"})."""
        x, kvs, _ = self._stack(params, x, positions, shared,
                                self._page_xs(cache))
        return x, self._collect_kv(kvs)

    def _paged_shared(self, positions, validm, c, block_tables, ctx_lens,
                      impl, cache, kv_shard=None, shard_offs=None):
        shared = self._window_masks(positions, validm, c)
        shared.update(block_tables=block_tables.to(torch.int32),
                      ctx_lens=ctx_lens.to(torch.int32), impl=impl)
        if kv_shard is not None:
            # the sharded pool's fields, read by the paged branch of _attn;
            # every shard's local tables and ctx once for all the layers
            if shard_offs is None:
                shard_offs = torch.zeros_like(shared["ctx_lens"])
            shard_offs = shard_offs.to(torch.int32)
            blk = cache["k_pages"][0]
            shared.update(kv_shard=kv_shard, shard_offs=shard_offs,
                          shard_local=shard_local_slots(
                              shared["block_tables"], shared["ctx_lens"],
                              shard_offs, kv_shard, pages_local=blk.shape[1],
                              page_size=blk.shape[2]))
        return shared

    def prefill_paged(self, params, cache, tokens, lengths, block_tables,
                      mm_embeds=None, mm_mask=None, head_mode: str = "logits",
                      *, impl: str = "kernel", kv_shard=None):
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

        ``kv_shard`` (a ``KVShardSpec`` or None): sharded page pool — the
        cache holds the shards' blocks and the KV scatter stays shard-local
        (block tables carry GLOBAL page ids).  The forward reads no page,
        so it is the same either way.
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
        shared = {"impl": impl, "self_flash": {
            "lengths": lengths,
            "block_size": cfg.block_size if cfg.diffusion else 1}}
        x = self.embed(params, tokens, mm_embeds, mm_mask)
        x, kv = self._paged_stack(params, x, positions, shared, cache)
        idx = torch.clamp(lengths.long() - 1, 0, T - 1)
        xl = x[torch.arange(B, device=dev), idx][:, None]
        logits = self.head(params, xl)[:, 0]
        P, ps = _pool_dims(cache["k_pages"], kv_shard)
        keep = positions < lengths[:, None]
        dest = _page_dest(block_tables, positions, keep, ps, P)
        _scatter_paged(cache["k_pages"], kv["k"], dest, kv_shard)
        _scatter_paged(cache["v_pages"], kv["v"], dest, kv_shard)
        if head_mode == "sample":
            return softmax_confidence_device(logits), cache
        return logits, cache

    def prefill_chunk_paged(self, params, cache, tokens, offsets, valid,
                            block_tables, *, impl: str = "kernel",
                            mm_embeds=None, mm_mask=None, kv_shard=None,
                            shard_offs=None):
        """One resumable prefill chunk per row: forward prompt tokens
        [offsets, offsets + valid) against the pages already written by
        earlier chunks (``ctx_lens = offsets``), and write this chunk's KV
        into the pool.

        tokens [B,T] (row-padded), offsets [B], valid [B] (0 ⇒ padded row,
        no writes).  Returns (conf [B], tok [B], cache): the
        last-valid-position head reduced on device.  ``kv_shard`` and
        ``shard_offs`` [B] (the rows' stripe offsets): the sharded pool,
        read split-KV and written shard-locally.
        """
        self._check_paged()
        B, T = tokens.shape
        dev = tokens.device
        offs = torch.arange(T, dtype=torch.int64, device=dev)
        positions = offsets.long()[:, None] + offs[None, :]
        validm = offs[None, :] < valid[:, None]
        shared = self._paged_shared(positions, validm, T, block_tables,
                                    offsets, impl, cache, kv_shard,
                                    shard_offs)
        x = self.embed(params, tokens, mm_embeds, mm_mask)
        x, kv = self._paged_stack(params, x, positions, shared, cache)
        idx = torch.clamp(valid.long() - 1, 0, T - 1)
        xl = x[torch.arange(B, device=dev), idx][:, None]
        logits = self.head(params, xl)[:, 0]
        P, ps = _pool_dims(cache["k_pages"], kv_shard)
        dest = _page_dest(block_tables, positions, validm, ps, P)
        _scatter_paged(cache["k_pages"], kv["k"], dest, kv_shard)
        _scatter_paged(cache["v_pages"], kv["v"], dest, kv_shard)
        conf, tok = softmax_confidence_device(logits)
        return conf, tok, cache

    def chunk_forward_paged(self, params, cache, win_tokens, win_start,
                            win_valid, block_tables, ctx_lens, *,
                            impl: str = "kernel", mm_embeds=None,
                            mm_mask=None, kv_shard=None, shard_offs=None):
        """Diffusion-window forward against the paged prefix cache.
        ctx_lens [B] is the committed prefix length per row (0 for padded
        rows — their paged partial is empty and the in-window diagonal
        keeps logits finite).  Returns (logits [B,c,V] fp32, win_kv).
        ``kv_shard``/``shard_offs``: as :meth:`prefill_chunk_paged`."""
        self._check_paged()
        B, c = win_tokens.shape
        offs = torch.arange(c, dtype=torch.int64, device=win_tokens.device)
        positions = win_start.long()[:, None] + offs[None, :]
        valid = offs[None, :] < win_valid[:, None]
        shared = self._paged_shared(positions, valid, c, block_tables,
                                    ctx_lens, impl, cache, kv_shard,
                                    shard_offs)
        x = self.embed(params, win_tokens, mm_embeds, mm_mask)
        x, kv = self._paged_stack(params, x, positions, shared, cache)
        return self.head(params, x), kv

    def freeze_paged(self, cache, win_kv, block_tables, win_start, n_adv,
                     kv_shard=None):
        """Write the first n_adv[b] window KV entries into the page pool,
        in place (shard-locally with ``kv_shard``)."""
        c = win_kv["k"].shape[2]
        P, ps = _pool_dims(cache["k_pages"], kv_shard)
        offs = torch.arange(c, dtype=torch.int64, device=win_start.device)
        pos = win_start.long()[:, None] + offs[None, :]
        keep = offs[None, :] < n_adv[:, None]
        dest = _page_dest(block_tables, pos, keep, ps, P)
        _scatter_paged(cache["k_pages"], win_kv["k"], dest, kv_shard)
        _scatter_paged(cache["v_pages"], win_kv["v"], dest, kv_shard)
        return cache

    def decode_step_paged(self, params, cache, win_tokens, win_start,
                          win_valid, block_tables, ctx_lens, n_adv, *,
                          impl: str = "kernel", mm_embeds=None,
                          mm_mask=None, kv_shard=None, shard_offs=None):
        """One fused paged decode iteration: chunk-forward + freeze +
        on-device sampling.  ``n_adv`` [B] is the number of leading window
        KV entries to freeze (known before the step).  Returns (conf [B,c]
        fp32, tok [B,c] int32, cache) — the cache updated in place.
        ``kv_shard``/``shard_offs``: as :meth:`prefill_chunk_paged`."""
        logits, win_kv = self.chunk_forward_paged(
            params, cache, win_tokens, win_start, win_valid, block_tables,
            ctx_lens, impl=impl, mm_embeds=mm_embeds, mm_mask=mm_mask,
            kv_shard=kv_shard, shard_offs=shard_offs)
        self.freeze_paged(cache, win_kv, block_tables, win_start, n_adv,
                          kv_shard=kv_shard)
        conf, tok = softmax_confidence_device(logits)
        return conf, tok, cache
