"""Op trace: every aten op a dispatch runs, the counterpart of the JAX
package's jaxpr walker (``repro.analysis.jaxpr``).

:class:`OpTrace` is a ``TorchDispatchMode``: under it each aten op is
recorded with its name and the shape, dtype and device of every tensor
operand and result.  It audits what was *executed* — on ``meta`` tensors
that is a shape-only trace, the torch form of tracing a jaxpr.  Three
uses, as the reference's:

* byte accounting (:func:`byte_traffic`): Σ operand + result bytes over
  the ops;
* the vocab census (:func:`intermediate_shapes`): every op's result
  shapes, so a rule can look for a ``[B, c, V]`` value;
* the dispatch's returned values (:func:`out_shapes`).

A hand kernel is **one** op.  Its wrapper runs under :func:`kernel_call`,
which keeps the trace from recording what runs inside (the kernel's
output allocations, or on a CPU tensor the plain version's arithmetic)
and records one op named after the kernel, with the FLOPs and bytes of
the kernel module's cost function.  Allocations inside still count toward
the live-bytes peak: they are real memory.

The trace also follows the bytes of live tensors allocated under it (a
result that aliases no operand is a new allocation; it is freed when its
storage is), so :attr:`OpTrace.peak_bytes` is the step's peak of live
bytes above what existed before it — on ``meta`` a prediction of the
device's.
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_ACTIVE: list = []       # the traces entered, innermost last


@dataclass(frozen=True)
class TensorMeta:
    shape: tuple
    dtype: torch.dtype
    device: str

    @property
    def nbytes(self) -> int:
        n = self.dtype.itemsize
        for s in self.shape:
            n *= s
        return n

    @classmethod
    def of(cls, t: torch.Tensor) -> "TensorMeta":
        return cls(tuple(t.shape), t.dtype, str(t.device))


def _tensors(tree):
    """The tensors of an op's arguments or results (tuples, lists, dicts)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)


def _metas(tree) -> list:
    return [TensorMeta.of(x) for x in _tensors(tree)]


@dataclass
class Op:
    """One recorded op.  ``allocs``: its results that are new allocations
    (not views or in-place updates of an operand).  ``kind``: "view" (its
    results only alias operands), "inplace" (it writes an operand), or
    None.  ``flops``/``nbytes`` are set for a hand kernel (its cost
    function's), None for an aten op."""
    name: str
    inputs: list
    outputs: list
    allocs: list
    flops: float | None = None
    nbytes: int | None = None
    kind: str | None = None

    @property
    def bytes(self) -> int:
        if self.nbytes is not None:
            return self.nbytes
        return sum(m.nbytes for m in self.inputs) + \
            sum(m.nbytes for m in self.outputs)

    @property
    def is_kernel(self) -> bool:
        return self.flops is not None


class OpTrace(TorchDispatchMode):
    """Record the aten ops run under ``with OpTrace() as tr:``."""

    def __init__(self):
        super().__init__()
        self.ops: list = []
        self.outputs: list = []      # set by :func:`trace`
        self.live_bytes = 0
        self.peak_bytes = 0
        self._quiet = 0
        self._live: dict = {}

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    def _track(self, results, aliases) -> list:
        """Follow the results that are new allocations; returns them."""
        fresh = []
        for i, t in enumerate(results):
            if not isinstance(t, torch.Tensor) or (i < len(aliases)
                                                   and aliases[i]):
                continue
            fresh.append(TensorMeta.of(t))
            st = t.untyped_storage()
            key = id(st)
            if key in self._live:
                continue
            n = st.nbytes()
            self._live[key] = n
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(st, self._free, key)
        return fresh

    def _free(self, key):
        self.live_bytes -= self._live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        res = out if isinstance(out, (tuple, list)) else (out,)
        aliases, kind = _schema_of(func)
        fresh = self._track(res, aliases)
        if not self._quiet:
            self.ops.append(Op(str(func.overloadpacket.__name__),
                               _metas((args, kwargs)), _metas(out), fresh,
                               kind=kind))
        return out


_SCHEMAS: dict = {}


def _schema_of(func) -> tuple:
    """(which results alias an operand, the op's kind) of an aten op."""
    if func not in _SCHEMAS:
        sch = func._schema
        aliases = [r.alias_info is not None for r in sch.returns]
        kind = "inplace" if sch.is_mutable else \
            "view" if aliases and all(aliases) else None
        _SCHEMAS[func] = (aliases, kind)
    return _SCHEMAS[func]


def active() -> OpTrace | None:
    return _ACTIVE[-1] if _ACTIVE else None


def kernel_call(name: str, cost, inputs, run):
    """Run a hand kernel's wrapper body ``run()``; under an active trace,
    record it as one op ``name`` whose (FLOPs, bytes) are ``cost()``, with
    ``inputs`` and the result as its operands."""
    tr = active()
    if tr is None:
        return run()
    tr._quiet += 1
    try:
        out = run()
    finally:
        tr._quiet -= 1
    flops, nbytes = cost()
    outs = _metas(out)
    tr.ops.append(Op(name, _metas(inputs), outs, outs, float(flops),
                     int(nbytes)))
    return out


def trace(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` under a fresh trace → (result, trace);
    ``trace.outputs`` holds the result's tensors."""
    with OpTrace() as tr:
        out = fn(*args, **kwargs)
    tr.outputs = list(_tensors(out))
    return out, tr


def byte_traffic(tr: OpTrace) -> float:
    """Σ over the ops of (operand + result bytes); a hand kernel's bytes
    are its cost function's."""
    return float(sum(op.bytes for op in tr.ops))


def intermediate_shapes(tr: OpTrace) -> list:
    """Every op's result shapes, in order."""
    return [m.shape for op in tr.ops for m in op.outputs]


def out_shapes(tr: OpTrace) -> list:
    """The shapes of the traced call's returned tensors."""
    return [tuple(t.shape) for t in tr.outputs]
