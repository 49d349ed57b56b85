"""Architecture registry + assigned input shapes.

``--arch <id>`` ids map to modules here; every arch also exposes a reduced
``SMOKE`` config used by the per-arch CPU smoke tests.  The full configs are
only exercised via the dry-run (ShapeDtypeStruct, no allocation).
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass

_MODULES = {
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "starcoder2-15b": "starcoder2_15b",
    "smollm-135m": "smollm_135m",
    "llama3.2-1b": "llama32_1b",
    "phi3-medium-14b": "phi3_medium_14b",
    "qwen2-vl-2b": "qwen2_vl_2b",
    "jamba-1.5-large-398b": "jamba_15_large_398b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "rwkv6-1.6b": "rwkv6_1b6",
    "sdar-8b": "sdar_8b",
}

ALL_ARCHS = [k for k in _MODULES if k != "sdar-8b"]   # the 10 assigned
PAPER_ARCH = "sdar-8b"


def get_config(name: str):
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def get_smoke_config(name: str):
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.SMOKE


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                 # train | prefill | decode | long_decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "long_decode"),
}

# long_500k needs sub-quadratic attention: only hybrid/ssm run it
# (full-attention archs are skipped per assignment; recorded in DESIGN.md §5)
LONG_CONTEXT_ARCHS = {"jamba-1.5-large-398b", "rwkv6-1.6b"}


def cells(include_skipped: bool = False):
    """All (arch, shape) dry-run cells; skipped cells flagged."""
    out = []
    for arch in ALL_ARCHS:
        for sname, spec in SHAPES.items():
            skipped = (spec.kind == "long_decode"
                       and arch not in LONG_CONTEXT_ARCHS)
            if skipped and not include_skipped:
                continue
            out.append((arch, sname, skipped))
    return out
