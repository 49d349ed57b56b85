"""Captured dispatches: the torch form of the JAX package's jitted
dispatches in its ``serving/backends.py`` — the three donated paged ones
(``_prefill_paged``, ``_prefill_chunk``, ``_decode_paged``) and the four of
the recurrent-slot mode (``_prefill``, ``_chunk_fwd``, ``_advance`` with
``_merge``) — one CUDA graph per input bucket.

:class:`DispatchGraphs` is the compile cache.  Its key is the dispatch
kind, the bucketed shape and everything else that selects the traced code
(``impl``, the shard count); the backend pads every host array to its
bucket, so a key sees one shape.  An entry holds the static input
tensors (allocated once), the captured graph, its static outputs, the
pool's ``data_ptr``\\ s at capture, and the Python-side counters' deltas
recorded while capturing.

* First use of a key: the host arrays are copied into the new static
  inputs and the dispatch runs once eagerly (on the capturer's side
  stream: the BLAS handles and the allocator warm up there).  That run IS
  the call's dispatch — its outputs are returned and it is the only run
  that writes the pool.  Then the graph is captured; capture records work
  and runs none, so the pool is written exactly once.
* Later calls: the host arrays go through pinned staging tensors into the
  static inputs (``copy_(..., non_blocking=True)``, the whole padded array
  every call, so a padded row never keeps an earlier call's values), the
  graph replays, and the static outputs are returned.

Invariants:

* All graphs of one cache share one memory pool (``graph_pool_handle``).
  A graph captured later may place its live outputs where an earlier
  graph keeps its intermediates, so replaying the earlier graph can
  overwrite them.  That is safe only because the caller is done with each
  replay's outputs before any other graph of the cache replays: the paged
  path copies every replay's conf/tok to the host
  (``ModelBackend._to_host``); the slot path fetches an AR step's and an
  admission's logits at once, and ``ModelBackend._step_slots`` fetches a
  window's logits before any block commit replays (a block commit's
  logits are never read).
* What the dispatches write in place (``pool_ptrs()``: the page pool's
  blocks, or the slot cache's tensors) must be where it was at capture: a
  replay that finds it moved raises.  A capture that fails raises too: there is
  no fall-back to the eager path, and the capture error mode stays at
  PyTorch's default (``"global"``).
* The hand kernels' wrappers, the MoE grouped product and the collective
  record count at trace time (``LAUNCHES``, ``MERGE_LAUNCHES``,
  ``GROUPED_CALLS``, ``collectives.RECORD``), which under replay would
  count the capture only.  The cache takes each counter's delta over the
  capture back out and adds it again on every replay, so they count
  launches, replayed or not.

The capturer is injectable: :class:`CudaCapturer` on the card;
:class:`RerunCapturer` on the CPU (tests, the analyzer), a stand-in that
captures nothing and re-runs the dispatch on the static inputs at every
replay, copying its results into the static outputs.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.distributed import collectives
from repro_torch.kernels import block_diffusion_attn as bda
from repro_torch.kernels import chunked_paged_attn as cpa
from repro_torch.models import moe

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
        ``like`` (the warm-up's outputs) is unused."""
        g = torch.cuda.CUDAGraph()
        with torch.cuda.stream(self.stream):
            g.capture_begin(pool=self.pool)
            try:
                out = fn()
            except BaseException:
                try:
                    g.capture_end()
                except RuntimeError:
                    pass                # the failed capture's own error
                raise
            g.capture_end()
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

    def __init__(self, device, pool_ptrs, capturer=None):
        self.device = torch.device(device)
        self.pool_ptrs = pool_ptrs
        self.capturer = capturer if capturer is not None \
            else CudaCapturer(self.device)
        self.entries: dict = {}
        self.replays = 0

    def dispatch(self, key, fn, host: dict) -> tuple:
        """Run the dispatch of ``key`` on the host arrays ``host`` (name →
        numpy array at the key's shape: ints, or a bool mask): ``fn(t)``,
        with ``t`` the static
        inputs by name, returns its output tensors.  Returns those outputs,
        on the device."""
        e = self.entries.get(key)
        if e is None:
            return self._first(key, fn, host)
        ptrs = self.pool_ptrs()
        if ptrs != e.ptrs:
            raise RuntimeError(f"graph {key}: the pool moved since "
                               f"capture ({e.ptrs} → {ptrs}); a replay "
                               f"would write the old storage")
        self._load(e.static, host)
        e.replay()
        _add(e.delta)
        self.replays += 1
        return e.outputs

    def _load(self, static: dict, host: dict):
        pin = self.device.type == "cuda"
        for name, a in host.items():
            t = static[name]
            if tuple(a.shape) != tuple(t.shape):
                raise ValueError(f"input {name}: shape {a.shape}, the "
                                 f"graph's {tuple(t.shape)}")
            if not pin:
                t.numpy()[...] = a
                continue
            # a fresh pinned block a call: the host allocator does not hand
            # it out again before this copy has completed
            src = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            src.numpy()[...] = a
            t.copy_(src, non_blocking=True)

    def _first(self, key, fn, host: dict) -> tuple:
        static = {name: torch.empty(a.shape, device=self.device,
                                    dtype=torch.from_numpy(
                                        np.empty(0, a.dtype)).dtype)
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
