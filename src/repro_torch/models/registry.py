"""Model registry: build a model object from an ArchConfig."""

from __future__ import annotations

from repro_torch.models.common import ArchConfig
from repro_torch.models.transformer import TransformerLM


def build_model(cfg: ArchConfig):
    """The port's model for ``cfg``; families not ported yet raise
    ``NotImplementedError`` (the dense family serves today)."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported to repro_torch yet")
    return TransformerLM(cfg)
