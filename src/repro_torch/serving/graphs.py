"""Captured dispatches: the torch form of the JAX package's jitted
dispatches — the three donated paged ones of its ``serving/backends.py``
(``_prefill_paged``, ``_prefill_chunk``, ``_decode_paged``), the four of
the recurrent-slot mode (``_prefill``, ``_chunk_fwd``, ``_advance`` with
``_merge``), the page pool's two donated moves of its
``serving/kv_pool.py`` (``_copy_jit``, ``_swapin_jit``) and the train step
of its ``training/train_loop.py`` — one CUDA graph per input bucket.

:class:`DispatchGraphs` is the compile cache.  Its key is the dispatch
kind, the bucketed shape and everything else that selects the traced code
(``impl``, the shard count); the caller pads every host array to its
bucket, so a key sees one shape.  An entry holds the static input
tensors (allocated once), the captured graph, its static outputs, the
``data_ptr``\\ s at capture of what the dispatch writes in place, and the
Python-side counters' deltas recorded while capturing.

* First use of a key: the inputs are copied into the new static inputs
  and the dispatch runs once eagerly (on the capturer's side stream: the
  BLAS handles and the allocator warm up there).  That run IS the call's
  dispatch — its outputs are returned and it is the only run that writes
  the pool (or, for the train step, the params and moments).  Then the
  graph is captured; capture records work and runs none, so what the
  dispatch writes in place is written exactly once.
* Later calls: the inputs go into the static inputs, the graph replays,
  and the static outputs are returned.  A numpy array or a host tensor
  goes through a pinned staging tensor (``copy_(..., non_blocking=True)``;
  a tensor already pinned is copied from directly), a device tensor by a
  device-to-device ``copy_``; the whole padded input every call, so a
  padded row never keeps an earlier call's values.

Invariants:

* All graphs of one cache share one memory pool (``graph_pool_handle``).
  A graph captured later may place its live outputs where an earlier
  graph keeps its intermediates, so replaying the earlier graph can
  overwrite them.  That is safe only because the caller is done with each
  replay's outputs before any other graph of the cache replays: the paged
  path copies every replay's conf/tok to the host
  (``ModelBackend._to_host``) before the pool's COW copies and swap-ins
  (kinds ``copy`` and ``swap_in``, which return nothing) replay; the slot
  path fetches an AR step's and an admission's logits at once, and
  ``ModelBackend._step_slots`` fetches a window's logits before any block
  commit replays (a block commit's logits are never read).  A trainer's
  cache holds its train step's graphs alone, whose loss, norm and lr are
  read before the next step replays.
* What the dispatches write in place (``pool_ptrs()``: the page pool's
  blocks, the slot cache's tensors, or a trainer's params and moments)
  must be where it was at capture: a replay that finds it moved raises.
  A capture that fails raises too: there is no fall-back to the eager
  path, and the capture error mode stays at PyTorch's default
  (``"global"``).
* The hand kernels' wrappers, the MoE grouped product and the collective
  record count at trace time (``LAUNCHES``, ``MERGE_LAUNCHES``,
  ``GROUPED_CALLS``, ``collectives.RECORD``), which under replay would
  count the capture only.  The cache takes each counter's delta over the
  capture back out and adds it again on every replay, so they count
  launches, replayed or not.

Spans (``tracer``: ``NULL_TRACER`` until a backend's engine hands its
own over): ``graph.load`` stages a call's static inputs, ``graph.replay``
runs from the replay's enqueue (where the dispatch's device work starts)
and ``graph.capture`` holds a new key's warm run and capture, with the
key.  Whatever the tracer, the cache counts its replays and the host
seconds its captures took (``capture_s``, warm runs included).

The capturer is injectable: :class:`CudaCapturer` on the card;
:class:`RerunCapturer` on the CPU (tests, the analyzer), a stand-in that
captures nothing and re-runs the dispatch on the static inputs at every
replay, copying its results into the static outputs.
"""

from __future__ import annotations

import gc
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.distributed import collectives
from repro_torch.kernels import block_diffusion_attn as bda
from repro_torch.kernels import chunked_paged_attn as cpa
from repro_torch.models import moe
from repro_torch.serving.clock import WallClock
from repro_torch.serving.telemetry import NULL_TRACER

# the counters that add to themselves when a wrapper is traced
_COUNTERS = ((cpa, "LAUNCHES"), (cpa, "MERGE_LAUNCHES"), (bda, "LAUNCHES"),
             (moe, "GROUPED_CALLS"))


def _snapshot():
    return ([getattr(m, a) for m, a in _COUNTERS],
            collectives.record_snapshot())


def _delta(after, before):
    ints = [x - y for x, y in zip(after[0], before[0])]
    rec = {k: (after[1][k]["bytes"] - before[1][k]["bytes"],
               after[1][k]["count"] - before[1][k]["count"])
           for k in after[1]}
    return ints, {k: v for k, v in rec.items() if v != (0, 0)}


def _restore(snap):
    for (m, a), v in zip(_COUNTERS, snap[0]):
        setattr(m, a, v)
    for k, v in snap[1].items():
        collectives.RECORD[k].update(v)


def _add(delta):
    ints, rec = delta
    for (m, a), d in zip(_COUNTERS, ints):
        setattr(m, a, getattr(m, a) + d)
    for kind, (nbytes, count) in rec.items():
        collectives.record_collective(kind, nbytes, count)


class CudaCapturer:
    """Warm-up and capture on one side stream, every graph into one memory
    pool."""

    def __init__(self, device):
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(f"graph capture needs a CUDA device, not "
                             f"{self.device} (RerunCapturer stands in on "
                             f"the CPU)")
        self.stream = torch.cuda.Stream(self.device)
        self.pool = torch.cuda.graph_pool_handle()

    def warm(self, fn):
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            out = fn()
        cur.wait_stream(self.stream)
        return out

    def capture(self, fn, like):
        """``(replay, static outputs)`` of ``fn`` captured into a graph;
        ``like`` (the warm-up's outputs) is unused.

        As ``torch.cuda.graph`` does, the allocator's unused blocks are
        released first: the warm-up's temporaries sit in its cache, which
        cannot be freed while a stream captures, so a graph that needs
        fresh segments (a train step's 27 GB) would run out of memory.
        The garbage collector stays off while capturing: a graph that it
        destroys mid-capture (an old cache in a reference cycle) resets
        itself, which invalidates the capture.  Unlike
        ``torch.cuda.graph``, no collection runs first: a full one costs a
        large process a fifth of a second a capture."""
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        g = torch.cuda.CUDAGraph()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.stream(self.stream):
                g.capture_begin(pool=self.pool)
                try:
                    out = fn()
                except BaseException:
                    try:
                        g.capture_end()
                    except RuntimeError:
                        pass            # the failed capture's own error
                    raise
                g.capture_end()
        finally:
            if collecting:
                gc.enable()
        return g.replay, out

    def pool_bytes(self) -> int | None:
        """Bytes of the segments the pool holds on the card (None where the
        allocator's snapshot does not name a segment's pool)."""
        segs = torch.cuda.memory_snapshot()
        if segs and "segment_pool_id" not in segs[0]:
            return None
        return sum(s["total_size"] for s in segs
                   if tuple(s["segment_pool_id"]) == tuple(self.pool))


class RerunCapturer:
    """The CPU stand-in: nothing is captured; a replay re-runs the dispatch
    on the static inputs and copies its results into the static outputs."""

    def warm(self, fn):
        return fn()

    def capture(self, fn, like):
        outs = tuple(torch.empty_like(t) for t in like)

        def replay():
            for o, t in zip(outs, fn()):
                o.copy_(t)
        return replay, outs

    def pool_bytes(self):
        return None


@dataclass
class _Entry:
    static: dict            # name → device tensor, allocated once
    replay: object          # the captured graph's replay
    outputs: tuple          # the static outputs
    ptrs: tuple             # the pool's data_ptrs at capture
    delta: tuple            # the counters' deltas over the capture


class DispatchGraphs:
    """One captured graph per key; see the module docstring.

    ``pool_ptrs()`` gives the pool's ``data_ptr``\\ s now; ``capturer``
    defaults to :class:`CudaCapturer` on ``device``."""

    tracer = NULL_TRACER

    def __init__(self, device, pool_ptrs, capturer=None):
        self.device = torch.device(device)
        self.pool_ptrs = pool_ptrs
        self.capturer = capturer if capturer is not None \
            else CudaCapturer(self.device)
        self.entries: dict = {}
        self.replays = 0
        self.capture_s = 0.0        # host seconds in _first, cumulative
        self._host_clock = WallClock()

    def dispatch(self, key, fn, host: dict) -> tuple:
        """Run the dispatch of ``key`` on the inputs ``host`` (name → numpy
        array or tensor at the key's shape: ints, a bool mask, floats in
        any torch dtype, on the host or the device): ``fn(t)``, with ``t``
        the static inputs by name, returns its output tensors.  Returns
        those outputs, on the device."""
        tr = self.tracer
        e = self.entries.get(key)
        if e is None:
            with tr.span("graph.capture", key=repr(key)):
                t0 = self._host_clock.now()
                try:
                    return self._first(key, fn, host)
                finally:
                    self.capture_s += self._host_clock.now() - t0
        ptrs = self.pool_ptrs()
        if ptrs != e.ptrs:
            raise RuntimeError(f"graph {key}: the pool moved since "
                               f"capture ({e.ptrs} → {ptrs}); a replay "
                               f"would write the old storage")
        with tr.span("graph.load"):
            self._load(e.static, host)
        with tr.span("graph.replay"):
            e.replay()
            _add(e.delta)
            self.replays += 1
        return e.outputs

    def _load(self, static: dict, host: dict):
        pin = self.device.type == "cuda"
        for name, a in host.items():
            t = static[name]
            if tuple(a.shape) != tuple(t.shape):
                raise ValueError(f"input {name}: shape {tuple(a.shape)}, "
                                 f"the graph's {tuple(t.shape)}")
            tensor = isinstance(a, torch.Tensor)
            if not pin or (tensor and a.device == t.device):
                if tensor:
                    t.copy_(a)
                else:
                    t.numpy()[...] = a
                continue
            if tensor and a.is_pinned():
                t.copy_(a, non_blocking=True)
                continue
            # a fresh pinned block a call: the host allocator does not hand
            # it out again before this copy has completed
            src = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            if tensor:
                src.copy_(a)
            else:
                src.numpy()[...] = a
            t.copy_(src, non_blocking=True)

    def _first(self, key, fn, host: dict) -> tuple:
        static = {name: torch.empty(
            tuple(a.shape), device=self.device,
            dtype=a.dtype if isinstance(a, torch.Tensor)
            else torch.from_numpy(np.empty(0, a.dtype)).dtype)
            for name, a in host.items()}
        self._load(static, host)
        run = lambda: tuple(fn(static))  # noqa: E731
        out = self.capturer.warm(run)
        ptrs = self.pool_ptrs()
        before = _snapshot()
        try:
            replay, outputs = self.capturer.capture(run, out)
        finally:
            after = _snapshot()
            _restore(before)
        self.entries[key] = _Entry(static, replay, tuple(outputs), ptrs,
                                   _delta(after, before))
        return out

    def pool_bytes(self) -> int | None:
        """Bytes held by the graphs' shared memory pool (None when the
        capturer cannot tell)."""
        return self.capturer.pool_bytes()
