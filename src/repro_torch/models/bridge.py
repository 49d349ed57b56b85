"""Weights across: the JAX package's param pytree → the port's params.

``params_from_jax`` takes the pytree as nested dicts of numpy arrays (what
``jax.tree.map(np.asarray, params)`` gives) and returns the flat
``dict[str, Tensor]`` the port uses, keyed by the pytree path joined with
``/``.  Layouts are kept as they are — stacked ``[L, …]`` layers, and
weights ``[in, out]`` applied as ``x @ w`` — so nothing is transposed.
A bfloat16 array (numpy dtype named ``bfloat16``) comes across through its
16-bit pattern, so this module needs no bfloat16-aware numpy extension.
"""

from __future__ import annotations

import numpy as np
import torch


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.uint16)
        return torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def params_from_jax(tree, device="cuda") -> dict[str, torch.Tensor]:
    """Flatten a nested dict of numpy arrays into ``{"a/b/c": Tensor}`` on
    ``device``."""
    out: dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{prefix}{k}/")
        else:
            out[prefix[:-1]] = _tensor(node).to(device)

    walk(tree, "")
    return out
