"""Shared model configuration and parameter-initialization helpers.

:class:`ArchConfig` is field-for-field the configuration of the JAX
package (same names, same defaults), so every config file reads the same
in both.  Parameters are a flat ``dict[str, Tensor]`` keyed by the JAX
pytree path joined with ``/`` (``"blocks/pos0/mixer/wq"``); layer stacks
keep the leading ``L`` axis, so one tensor holds every layer's copy.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class ArchConfig:
    # identity ----------------------------------------------------------
    name: str = "model"
    family: str = "dense"          # dense | moe | hybrid | ssm | encdec | vlm
    # trunk -------------------------------------------------------------
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 4
    n_kv_heads: int = 2
    d_ff: int = 256
    vocab_size: int = 512
    head_dim: int = 0              # 0 → d_model // n_heads
    act: str = "silu"              # silu (SwiGLU) | gelu (GeGLU)
    gated_mlp: bool = True         # False → plain up/act/down FFN
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    max_seq_len: int = 8192
    # MoE ---------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0              # 0 → d_ff
    capacity_factor: float = 2.0
    # hybrid (jamba-style) -----------------------------------------------
    attn_period: int = 0           # 0 → every layer is attention
    attn_offset: int = 3           # index of the attn layer inside a period
    moe_every: int = 0             # 0 → dense FFN everywhere; k → MoE on idx%k==k-1
    d_state: int = 16
    d_conv: int = 4
    mamba_expand: int = 2
    # rwkv ----------------------------------------------------------------
    rwkv_head_dim: int = 64
    rwkv_lora_rank: int = 32
    # encoder-decoder -----------------------------------------------------
    n_enc_layers: int = 0
    # vlm (M-RoPE) --------------------------------------------------------
    mrope_sections: tuple = ()     # per-section rotary dims, sums to head_dim//2
    # diffusion decoding --------------------------------------------------
    diffusion: bool = True         # block-diffusion decoding supported
    block_size: int = 32
    mask_token_id: int = 3         # reserved mask-token id
    confidence_threshold: float = 0.9
    # serving KV-cache dispatch -------------------------------------------
    paged_kv: bool = False         # serve through the paged KV pool
    kv_page_size: int = 16         # tokens per KV page
    paged_attn_impl: str = "kernel"  # kernel (CUDA on GPU tensors) | ref
    # dtypes --------------------------------------------------------------
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    # sharding-rule overrides: ((logical_axis, mesh_axis_or_None), ...)
    rule_overrides: tuple = ()
    # scan/remat -----------------------------------------------------------
    remat: bool = False
    scan_layers: bool = True

    # derived -------------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def moe_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    @property
    def pdt(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    @property
    def cdt(self) -> torch.dtype:
        return torch_dtype(self.compute_dtype)

    @property
    def rwkv_n_heads(self) -> int:
        return self.d_model // self.rwkv_head_dim

    def is_attn_layer(self, idx: int) -> bool:
        if self.attn_period == 0:
            return True
        return idx % self.attn_period == self.attn_offset

    def is_moe_layer(self, idx: int) -> bool:
        if self.n_experts == 0:
            return False
        if self.moe_every == 0:
            return True
        return idx % self.moe_every == self.moe_every - 1

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Parameter count from an init on the ``meta`` device (no memory
        is allocated; matches :meth:`TransformerLM.init_params` exactly)."""
        from repro_torch.models import registry  # local import to avoid cycles

        params = registry.build_model(self).init_params(device="meta")
        return sum(int(np.prod(x.shape)) for x in params.values())


def torch_dtype(name: str) -> torch.dtype:
    """``"bfloat16"`` → ``torch.bfloat16`` (the JAX config's dtype names)."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


# ---------------------------------------------------------------------------
# Initialization helpers: the distributions of the JAX package's
# ``dense_init`` / ``embed_init``, drawn from an explicit torch.Generator on
# the generator's device (numbers differ from jax.random; parity tests
# bridge the JAX params instead, see models/bridge.py).
# ---------------------------------------------------------------------------

def _normal(gen, shape, device) -> torch.Tensor:
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=torch.float32, device="meta")
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=device)


def dense_init(gen, shape, dtype, device, fan_in: int | None = None):
    fan_in = fan_in if fan_in is not None else shape[-2] if len(shape) >= 2 else shape[-1]
    scale = 1.0 / np.sqrt(max(fan_in, 1))
    return _normal(gen, shape, device).mul_(scale).to(dtype)


def embed_init(gen, shape, dtype, device):
    return _normal(gen, shape, device).mul_(0.02).to(dtype)


def cache_axes(cache, leaf_axes):
    """The logical axes of a cache dict: ``leaf_axes(name, tensor)`` for each
    tensor leaf (``name`` its own key), the same nesting, None for a leaf
    that is not a tensor."""
    return {k: cache_axes(v, leaf_axes) if isinstance(v, dict)
            else leaf_axes(k, v) if isinstance(v, torch.Tensor) else None
            for k, v in cache.items()}
