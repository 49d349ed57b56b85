from repro_torch.models.bridge import params_from_jax
from repro_torch.models.common import ArchConfig
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.registry import build_model
from repro_torch.models.transformer import TransformerLM

__all__ = ["ArchConfig", "EncDecLM", "TransformerLM", "build_model",
           "params_from_jax"]
