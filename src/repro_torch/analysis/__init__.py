"""Static analysis of the serving stack (``python -m
repro_torch.analysis.check``), the torch form of the JAX package's
``repro.analysis``.

Two passes:

* **Pass 1 — dispatch audit** (:mod:`repro_torch.analysis.rules` over the
  dispatch inventory of :mod:`repro_torch.analysis.inventory`): runs every
  registered serving dispatch under the op trace
  (:mod:`repro_torch.analysis.optrace`) and enforces the invariants the
  hot path's performance story rests on — the pool updated in place, no
  vocab-axis escape, O(B·c) host transfer and no host sync, exact
  collective volume under a sharded pool, bounded dispatch-shape churn.
* **Pass 2 — AST repo lint** (:mod:`repro_torch.analysis.lint`): raise-
  before-mutate in the transactional allocator/backends, no wall clock in
  DES code, NULL_TRACER discipline, numpy-only host-commit path.

Keep this module import-light: the kernel modules import
:mod:`repro_torch.analysis.optrace` to report themselves to an active
trace.
"""
