"""Multi-replica cluster serving: load-aware routing, KV-pressure admission
with spill-back, optional low-priority preemption, and a shared-virtual-clock
event loop over steppable :class:`~repro_torch.serving.engine.EngineCore` replicas.
"""

from repro_torch.cluster.admission import (KVAdmissionPolicy, admission_pages,
                                     fits_ever, kv_tokens, service_floor)
from repro_torch.cluster.engine import ClusterEngine
from repro_torch.cluster.factory import (build_model_cluster, build_sim_cluster,
                                   make_replica_scheduler)
from repro_torch.cluster.health import HealthMonitor, RecoveryPolicy
from repro_torch.cluster.router import (ROUTERS, HealthAwareRouter,
                                  JoinShortestQueueRouter, RoundRobinRouter,
                                  SaturationAwareRouter, make_router)
from repro_torch.common.faults import FaultEvent, FaultPlan

__all__ = [
    "ClusterEngine", "KVAdmissionPolicy", "admission_pages", "fits_ever",
    "kv_tokens", "service_floor",
    "RoundRobinRouter", "JoinShortestQueueRouter", "SaturationAwareRouter",
    "HealthAwareRouter", "HealthMonitor", "RecoveryPolicy",
    "FaultPlan", "FaultEvent",
    "ROUTERS", "make_router", "build_sim_cluster", "build_model_cluster",
    "make_replica_scheduler",
]
