"""Training: objectives, AdamW, checkpoints, the train step and loop (the
JAX package's ``training`` exports)."""

from repro_torch.training.checkpoint import CheckpointManager, restore, save
from repro_torch.training.data import DataConfig, SyntheticTokenStream
from repro_torch.training.fault_tolerance import (FailureInjector,
                                                  SimulatedFailure,
                                                  StragglerMonitor,
                                                  elastic_shardings)
from repro_torch.training.objectives import (ar_loss, block_diffusion_loss,
                                             encdec_loss, loss_for)
from repro_torch.training.optimizer import AdamW, AdamWConfig, cosine_schedule
from repro_torch.training.train_loop import (Trainer, TrainerConfig,
                                             make_train_step)

__all__ = [
    "CheckpointManager", "restore", "save", "DataConfig",
    "SyntheticTokenStream", "FailureInjector", "SimulatedFailure",
    "StragglerMonitor", "elastic_shardings", "ar_loss",
    "block_diffusion_loss", "encdec_loss", "loss_for", "AdamW", "AdamWConfig",
    "cosine_schedule", "Trainer", "TrainerConfig", "make_train_step",
]
