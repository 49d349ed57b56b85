"""Per-step accounting from the op trace, the counterpart of the JAX
package's ``analyze()`` over optimized HLO (``repro.analysis.hlo``).

:func:`analyze` gives the three roofline inputs of one traced step:

* matmul FLOPs: ``2·M·K·N`` for every ``mm``, ``bmm``, ``addmm``,
  ``baddbmm`` and ``_grouped_mm`` (a grouped product counts every row; its
  group sizes are values the trace does not read), plus each hand
  kernel's own count (its cost function's);
* bytes: :func:`repro_torch.analysis.optrace.byte_traffic` (Σ operand +
  result bytes, the reference's jaxpr walker's count), and ``hbm_bytes``,
  the device-memory traffic the reference's HLO analysis estimates: views
  move nothing, an index read moves its result twice (read, write), an
  index write or scatter twice its update, a copy twice its source, a
  fill its result once, a hand kernel its cost function's bytes, any
  other op its operands and results;
* collectives by kind: the port's collective record
  (``repro_torch.distributed.collectives.RECORD``) over the step, per-device
  operand bytes and op counts.

The reference's text parser of optimized XLA HLO has no torch counterpart
and is not ported: nothing compiles a dispatch into a module to parse.
"""

from __future__ import annotations

from repro_torch.analysis import optrace

MATMUL_OPS = {"mm", "bmm", "addmm", "baddbmm", "_grouped_mm"}
# the operand whose last dimension is the contraction
_LHS = {"mm": 0, "bmm": 0, "_grouped_mm": 0, "addmm": 1, "baddbmm": 1}


def op_flops(op) -> float:
    """FLOPs of one recorded op: a hand kernel's own count, ``2·out·K`` for
    a matmul, 0 otherwise."""
    if op.is_kernel:
        return op.flops
    if op.name not in MATMUL_OPS or not op.outputs:
        return 0.0
    n = 1
    for s in op.outputs[0].shape:
        n *= s
    return 2.0 * n * op.inputs[_LHS[op.name]].shape[-1]


INDEX_READS = {"index", "gather", "index_select", "embedding", "take"}
INDEX_WRITES = {"index_put", "index_put_", "_index_put_impl_",
                "_unsafe_index_put", "index_copy", "index_copy_", "scatter",
                "scatter_", "scatter_add", "scatter_add_", "index_add",
                "index_add_", "masked_scatter_"}
NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty",
              "new_empty_strided", "detach", "alias", "lift_fresh",
              "_unsafe_view"}


def op_traffic(op) -> int:
    """Device-memory bytes one recorded op moves (the estimate above)."""
    if op.is_kernel:
        return op.nbytes
    if op.kind == "view" or op.name in NO_TRAFFIC:
        return 0
    if op.name in INDEX_READS:
        return 2 * sum(m.nbytes for m in op.outputs)
    if op.name in INDEX_WRITES:
        return 2 * op.inputs[-1].nbytes
    if op.name == "copy_":
        return 2 * op.inputs[1].nbytes
    if op.name in ("fill_", "zero_", "zeros", "ones", "full", "zeros_like",
                   "ones_like", "full_like"):
        return sum(m.nbytes for m in op.outputs)
    return op.bytes


def _record():
    from repro_torch.distributed.collectives import record_snapshot
    return record_snapshot()


def traced(fn, *args, **kwargs):
    """``optrace.trace`` with the collective record read around the call:
    → (result, trace); ``trace.collectives`` maps each kind to the
    ``{"bytes", "count"}`` the call added."""
    before = _record()
    out, tr = optrace.trace(fn, *args, **kwargs)
    after = _record()
    tr.collectives = {k: {f: after[k][f] - before[k][f]
                          for f in ("bytes", "count")} for k in after}
    return out, tr


def analyze(tr) -> dict:
    """``{"flops", "bytes", "hbm_bytes", "collectives", "kernels"}`` of a
    trace (:func:`traced`'s, for the collectives); ``kernels`` counts the
    hand kernel ops by name."""
    kernels: dict = {}
    for op in tr.ops:
        if op.is_kernel:
            kernels[op.name] = kernels.get(op.name, 0) + 1
    return {"flops": sum(op_flops(op) for op in tr.ops),
            "bytes": optrace.byte_traffic(tr),
            "hbm_bytes": float(sum(op_traffic(op) for op in tr.ops)),
            "collectives": getattr(tr, "collectives", {}),
            "kernels": kernels}
