"""The paper's primary contribution: streaming chunked decoding +
saturation-aware elastic scheduling for diffusion LLM serving."""

from repro_torch.core.chunked import (ChunkedDecodeState, batch_apply_step,
                                batch_windows, freeze_run)
from repro_torch.core.diffusion import (DecodeTrace, batch_commit_decisions,
                                  block_decode_reference, commit_decisions,
                                  softmax_confidence)
from repro_torch.core.latency_model import (A100_80G, H100_SXM, TPU_V5E,
                                      AnalyticDeviceModel, DeviceSpec,
                                      PiecewiseAffineLatencyModel)
from repro_torch.core.scheduler import (DEFAULT_CHUNKS, ElasticScheduler,
                                  FixedScheduler)
from repro_torch.core.tu_model import TokenUtilEstimator

__all__ = [
    "ChunkedDecodeState", "batch_apply_step", "batch_windows", "freeze_run",
    "DecodeTrace", "batch_commit_decisions", "block_decode_reference",
    "commit_decisions", "softmax_confidence", "AnalyticDeviceModel",
    "DeviceSpec", "PiecewiseAffineLatencyModel", "TPU_V5E", "A100_80G",
    "H100_SXM", "ElasticScheduler", "FixedScheduler", "TokenUtilEstimator",
    "DEFAULT_CHUNKS",
]
