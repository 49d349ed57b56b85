"""Model registry: build a model object from an ArchConfig."""

from __future__ import annotations

from repro_torch.models.common import ArchConfig
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.transformer import TransformerLM


def build_model(cfg: ArchConfig):
    """The port's model for ``cfg``: an :class:`EncDecLM` for the encdec
    family, a :class:`TransformerLM` for the dense, moe, vlm, hybrid and
    ssm families."""
    if cfg.family == "encdec":
        return EncDecLM(cfg)
    return TransformerLM(cfg)
