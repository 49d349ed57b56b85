"""Shared construction of simulated and real-model clusters.

The launcher, benchmark sweep, and example all build the same thing: N
backend replicas with per-replica schedulers, wrapped in a
:class:`ClusterEngine`.  One factory keeps their replica seeding,
scheduler profiling, and admission defaults in lock-step.  Since the KV
layer was unified, sim and (paged) model replicas expose the same
allocator-backed ``.kv`` pressure signal, so the same
:class:`KVAdmissionPolicy` drives both.
"""

from __future__ import annotations

import torch

from repro_torch.cluster.admission import KVAdmissionPolicy
from repro_torch.cluster.engine import ClusterEngine
from repro_torch.cluster.router import make_router
from repro_torch.core.latency_model import CPU_HOST, H100_SXM, AnalyticDeviceModel
from repro_torch.core.scheduler import scheduler_for_mode
from repro_torch.serving import EngineCore, ModelBackend, SimBackend


def make_replica_scheduler(backend, profile, mode: str = "elastic"):
    """Per-replica scheduler for a SimBackend (elastic | ar | bd<chunk>)."""
    return scheduler_for_mode(
        mode, backend.analytic,
        prior_tokens_per_step=profile.tokens_per_step_bd32)


def build_sim_cluster(cfg, profile, n_replicas: int, router, *,
                      device=H100_SXM, mode: str = "elastic",
                      kv_pages: int = 1 << 16, max_batch: int = 256,
                      seed: int = 0, kv_watermark: float = 0.05,
                      preemption: bool = False,
                      kv_admission: str = "incremental",
                      prefill_mode: str = "wave",
                      prefill_token_budget: int | None = None,
                      kv_shards: int = 1,
                      prefix_cache: bool = True,
                      host_kv_pages: int = 0,
                      fault_plan=None,
                      recovery=None,
                      health=None,
                      max_spill_retries: int | None = None,
                      commit_calib_seed: int | None = None,
                      tracer=None
                      ) -> ClusterEngine:
    """N independent SimBackend+scheduler replicas (per-replica RNG seeds,
    per-replica TU estimator state) under one ClusterEngine.  ``router``
    may be a name (see :data:`repro.cluster.router.ROUTERS`) or a router
    instance; ``kv_admission`` picks incremental page growth (default) or
    the legacy worst-case ``reserve`` baseline; ``prefill_mode="chunked"``
    interleaves budget-bounded prefill chunks with replica decode ticks
    instead of charging each admission's whole prompt synchronously."""
    if isinstance(router, str):
        router = make_router(router)
    if commit_calib_seed is None and fault_plan is not None:
        # replicas serve the same "model": share the commit-curve
        # calibration so a migrated request resumes the exact trajectory
        # its source replica would have produced (per-request sampling
        # streams still travel with the migration ticket)
        commit_calib_seed = seed
    replicas = []
    for i in range(n_replicas):
        be = SimBackend(cfg, device,
                        tokens_per_step=profile.tokens_per_step_bd32,
                        decode_mode="ar" if mode == "ar" else "elastic",
                        kv_pool_pages=kv_pages, seed=seed + 1000 * i,
                        kv_admission=kv_admission,
                        prefill_mode=prefill_mode,
                        prefill_token_budget=prefill_token_budget,
                        kv_shards=kv_shards,
                        prefix_cache=prefix_cache,
                        host_kv_pages=host_kv_pages,
                        commit_calib_seed=commit_calib_seed)
        sch = make_replica_scheduler(be, profile, mode)
        core = EngineCore(be, sch, max_batch=max_batch, tracer=tracer)
        core.replica = i
        replicas.append(core)
    return ClusterEngine(replicas, router,
                         admission=KVAdmissionPolicy(
                             low_watermark=kv_watermark),
                         enable_preemption=preemption, tracer=tracer,
                         fault_plan=fault_plan, recovery=recovery,
                         health=health,
                         max_spill_retries=max_spill_retries)


def build_model_cluster(model, params, n_replicas: int, router, *, profile,
                        mode: str = "elastic",
                        n_slots: int = 8, max_len: int = 128,
                        kv_pages: int | None = None,
                        page_size: int | None = None, max_batch: int = 64,
                        kv_watermark: float = 0.05,
                        preemption: bool = False,
                        prefill_mode: str = "chunked",
                        prefill_token_budget: int | None = None,
                        kv_shards: int = 1,
                        prefix_cache: bool = True,
                        host_kv_pages: int = 0,
                        fault_plan=None,
                        recovery=None,
                        max_spill_retries: int | None = None,
                        tracer=None,
                        device="cuda",
                        cache_dtype=torch.float32
                        ) -> ClusterEngine:
    """N real-model replicas (shared params, per-replica KV pool) under one
    ClusterEngine.  Attention-only families serve paged, so every replica
    admits by allocator pages (prompt-only, incremental growth) and
    :class:`KVAdmissionPolicy` reads the identical free-page / reservation
    signal it reads from SimBackend replicas.  Every replica receives the
    same ``params`` dict (no weight is copied, cast or moved) and builds its
    pool on ``device`` in ``cache_dtype``."""
    if isinstance(router, str):
        router = make_router(router)
    replicas = []
    for i in range(n_replicas):
        be = ModelBackend(model, params, n_slots=n_slots, max_len=max_len,
                          decode_mode="ar" if mode == "ar" else "elastic",
                          kv_pages=kv_pages, page_size=page_size,
                          prefill_mode=prefill_mode,
                          prefill_token_budget=prefill_token_budget,
                          kv_shards=kv_shards,
                          prefix_cache=prefix_cache,
                          host_kv_pages=host_kv_pages,
                          cache_dtype=cache_dtype, device=device)
        sch = scheduler_for_mode(
            mode, AnalyticDeviceModel(model.cfg, CPU_HOST),
            prior_tokens_per_step=profile.tokens_per_step_bd32,
            batches=(1, 2, 4, 8, 16), ctx=float(max_len)) \
            if mode == "elastic" else scheduler_for_mode(
                mode, prior_tokens_per_step=profile.tokens_per_step_bd32)
        core = EngineCore(be, sch, max_batch=max_batch, tracer=tracer)
        core.replica = i
        replicas.append(core)
    return ClusterEngine(replicas, router,
                         admission=KVAdmissionPolicy(
                             low_watermark=kv_watermark),
                         enable_preemption=preemption, tracer=tracer,
                         fault_plan=fault_plan, recovery=recovery,
                         max_spill_retries=max_spill_retries)
