"""Model registry: build a model object from an ArchConfig."""

from __future__ import annotations

from repro_torch.models.common import ArchConfig
from repro_torch.models.transformer import TransformerLM


def build_model(cfg: ArchConfig):
    """The port's model for ``cfg``: a :class:`TransformerLM` for the dense,
    moe, vlm, hybrid and ssm families; encdec, not ported yet, raises
    ``NotImplementedError``."""
    if cfg.family not in TransformerLM.FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported to repro_torch yet")
    return TransformerLM(cfg)
