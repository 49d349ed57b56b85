"""The run's weights, drawn from the seed on the device.

The layout (names, shapes, dtypes) is the program's: its model's
``init_params(device="meta")`` allocates nothing and gives it.  The values
are the benchmark's: one flat buffer a dtype, filled by a few large
``normal_`` calls of a ``torch.Generator`` on the device, then scaled leaf by
leaf in place — unit norm scales, embeddings at 0.02, every other matrix at
1/sqrt(fan-in) (its second-to-last axis), the configuration's
``zero_leaves`` at zero.  The configuration's ``final_norm_gain`` scales
``final_norm/scale``: the logits' spread, which sets how confident the
random model is and so how many tokens a diffusion step commits.  The
reference is handed the same tensors.
"""

from __future__ import annotations

import math

import torch

CHUNK = 1 << 30         # elements per normal_ call


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed % (1 << 64))


def draw(layout: dict, config: dict, seed: int, device,
         bufs: dict | None = None) -> tuple[dict, dict]:
    """``({name: tensor}, {dtype: flat buffer})`` on ``device`` for the
    meta-tensor ``layout``; ``bufs`` (an earlier call's) are drawn into
    again, so the tensors keep their storage."""
    gen = generator(seed, device)
    by_dtype: dict = {}
    for name, t in layout.items():
        by_dtype.setdefault(t.dtype, []).append(name)
    zeros = tuple(config.get("zero_leaves", ()))
    params, bufs = {}, dict(bufs or {})
    for dtype, names in by_dtype.items():
        total = sum(layout[n].numel() for n in names)
        buf = bufs.get(dtype)
        if buf is None:
            buf = bufs[dtype] = torch.empty(total, dtype=dtype,
                                            device=device)
        for lo in range(0, total, CHUNK):
            buf[lo:lo + CHUNK].normal_(generator=gen)
        off = 0
        for n in names:
            shape = layout[n].shape
            t = buf[off:off + layout[n].numel()].view(shape)
            off += t.numel()
            if n.endswith("/scale"):
                t.fill_(1.0)
            elif n.split("/")[-1] in zeros:
                t.zero_()
            elif n == "embed":
                t.mul_(0.02)
            else:
                t.mul_(1.0 / math.sqrt(shape[-2] if len(shape) >= 2
                                       else shape[-1]))
            params[n] = t
    params["final_norm/scale"].mul_(config.get("final_norm_gain", 1.0))
    return params, bufs
