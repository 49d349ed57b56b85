"""Infrastructure shared between the training and serving stacks."""

from repro_torch.common.faults import (FailureInjector, FaultEvent, FaultPlan,
                                       SimulatedFailure)

__all__ = ["FailureInjector", "FaultEvent", "FaultPlan", "SimulatedFailure"]
