from repro_torch.serving.backends import (ARState, ModelBackend, PrefillScheduler,
                                    SimBackend, StepInfo)
from repro_torch.serving.clock import VirtualClock, WallClock
from repro_torch.serving.engine import EngineCore, EngineReport, ServingEngine
from repro_torch.serving.kv_pool import (HostPagePool, OutOfPages,
                                   PagedKVAllocator, PrefixMatch)
from repro_torch.serving.metrics import (ClusterReport, chunk_distribution,
                                   slo_capacity)
from repro_torch.serving.request import Request, RequestMetrics
from repro_torch.serving.telemetry import (NULL_TRACER, NullTracer, Tracer,
                                     fault_summary, load_jsonl,
                                     replay_select, validate_trace_events)
from repro_torch.serving.workload import (DATASETS, CommitSimulator, DatasetProfile,
                                    PoissonWorkload, RateVaryingWorkload,
                                    SharedPrefixWorkload, bursty_rate,
                                    diurnal_rate, fixed_batch_workload,
                                    make_trace)

__all__ = [
    "ARState", "ModelBackend", "PrefillScheduler", "SimBackend", "StepInfo",
    "VirtualClock",
    "WallClock", "EngineCore", "EngineReport", "ServingEngine", "OutOfPages",
    "PagedKVAllocator", "HostPagePool", "PrefixMatch",
    "ClusterReport", "chunk_distribution", "slo_capacity",
    "Request", "RequestMetrics", "DATASETS", "CommitSimulator",
    "DatasetProfile", "PoissonWorkload", "RateVaryingWorkload",
    "SharedPrefixWorkload", "bursty_rate",
    "diurnal_rate", "fixed_batch_workload", "make_trace",
    "NULL_TRACER", "NullTracer", "Tracer", "fault_summary", "load_jsonl",
    "replay_select", "validate_trace_events",
]
