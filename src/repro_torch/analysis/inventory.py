"""The registered dispatch inventory Pass 1 audits.

Every dispatch the serving hot path can run is enumerated here, twice
over:

* :func:`build_entries` constructs each dispatch on a tiny audit model
  (distinctive ``vocab_size`` so a vocab axis is unambiguous in shapes) on
  a device, together with its declared expectations — the pool in place,
  host-transfer budget, analytic collective volume, shape buckets;
* :data:`KNOWN_DISPATCH_SITES` registers every dispatch call site (a call
  of a model dispatch method, or a graph cache's ``dispatch``) and every
  graph-capture site (``torch.compile``, ``torch.cuda.graph``,
  ``torch.cuda.CUDAGraph``) in the serving modules and the train loop.
  :func:`audit_registration` AST-scans those modules and fails (HLO006)
  on any unregistered site — a new dispatch or a captured graph cannot
  ship without either an inventory entry or an explicit registration.

Entries are audited at ``kv_shards == 1`` and at ``kv_shards == 2`` on a
mesh whose every shard is the chosen device (``make_kv_mesh(S,
devices=[device] * S)``).
"""

from __future__ import annotations

import ast
import functools
import os
from dataclasses import dataclass, field
from typing import Any, Callable

from repro_torch.analysis.findings import Finding

# Audit model: small enough to run in a second on the CPU, vocab chosen so
# no other dimension (d_model, d_ff, pages, page_size, batch, chunk) can
# collide with it — a 307 in any shape IS the vocab axis.
AUDIT_ARCH = dict(name="audit", family="dense", n_layers=2, d_model=64,
                  n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=307,
                  block_size=8, confidence_threshold=0.6)
# the slot backend's audit model: the hybrid family (Mamba, attention on
# the slot view, block-pinned diffusion) at the audit's widths and vocab
AUDIT_SLOT_ARCH = dict(AUDIT_ARCH, name="audit_slot", family="hybrid",
                       n_layers=4, attn_period=4, attn_offset=1)
AUDIT_B = 2          # batch rows in the audited dispatch
AUDIT_C = 4          # decode window (chunk) width
AUDIT_T = 8          # prefill token width


@dataclass
class ChurnSpec:
    """Tick shape grid for HLO005: each maker returns (args, kwargs) for
    one raw shape, routed through the backend's bucketing."""
    arg_makers: list
    declared_buckets: int


@dataclass
class DispatchEntry:
    name: str
    kv_shards: int
    fn: Any                              # the dispatch callable
    make_args: Callable[[], tuple]       # fresh args (a fresh pool)
    make_kwargs: Callable[[], dict] = field(default=lambda: {})
    pool_arg: int | None = 1             # the cache argument; None → skip HLO001
    vocab_size: int | None = None        # None → skip HLO002
    host_budget_bytes: int | None = None  # None → skip HLO003
    expected_collectives: dict | None = None  # None → skip HLO004
    churn: ChurnSpec | None = None       # None → skip HLO005

    @property
    def target(self) -> str:
        return f"{self.name}@kv{self.kv_shards}"


def build_entries(kv_shards: int = 1, device="cuda", *, model=None,
                  params=None, B: int = AUDIT_B, c: int = AUDIT_C,
                  T: int = AUDIT_T, ctx: int = 0, max_len: int = 64,
                  cache_dtype=None) -> list:
    """Construct the dispatch inventory on ``device`` (with ``kv_shards >
    1``, every shard of the pool on it): on the audit model, or on
    ``model`` with ``params`` already there.  The defaults are the audit's
    zero dispatches (empty windows, context 0); ``ctx > 0`` makes every
    row live — row ``b`` owns pages ``[b·W, (b+1)·W)``, decode reads a
    ``ctx``-token prefix and freezes its whole ``c``-token window, a
    chunked prefill writes ``T`` tokens after ``ctx``, a wave prefill
    ``T`` tokens a row — so the kernels do the serving path's work."""
    import torch

    from repro_torch.launch.mesh import make_kv_mesh
    from repro_torch.models import ArchConfig, build_model
    from repro_torch.models.transformer import copy_pages, write_pages
    from repro_torch.serving.backends import (ModelBackend,
                                              _split_kv_collective_bytes)

    dev = torch.empty(0, device=device).device
    if model is None:
        model = build_model(ArchConfig(**AUDIT_ARCH))
        params = model.init_params(
            torch.Generator(device=dev).manual_seed(0), device=dev)
    cfg = model.cfg
    S = kv_shards
    mesh = make_kv_mesh(S, devices=[dev] * S) if S > 1 else None
    be = ModelBackend(model, params, n_slots=8, max_len=max_len,
                      kv_shards=S, device=dev, kv_mesh=mesh,
                      cache_dtype=cache_dtype or torch.float32)
    W = be._table_width
    V = cfg.vocab_size
    i32, i64 = torch.int32, torch.int64

    def z(*shape, dtype=i64):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def full(b, v):
        return torch.full((b,), v if ctx else 0, dtype=i64, device=dev)

    def tables(b):
        if not ctx:
            return z(b, W, dtype=i32)
        return (torch.arange(b * W, dtype=i32, device=dev) % be.kv.n_pages
                ).reshape(b, W)

    def zeros_like(t):
        return [torch.zeros_like(b) for b in t] if isinstance(t, list) \
            else torch.zeros_like(t)

    def cache():
        # a fresh zero pool per call, laid out as the backend's (one tensor
        # or the shards' blocks): the allocator's own is never touched
        return {"k_pages": zeros_like(be.kv.k_pages),
                "v_pages": zeros_like(be.kv.v_pages)}

    def shard_kw(b):
        return ({"kv_shard": be._kv_shard, "shard_offs": z(b, dtype=i32)}
                if S > 1 else {})

    def decode_args(b, ch):
        return (params, cache(), z(b, ch), full(b, ctx), full(b, ch),
                tables(b), full(b, ctx), full(b, ch))

    def prefill_args(b, t):
        return (params, cache(), z(b, t), full(b, t).to(i32), tables(b))

    def chunk_args(b, t):
        return (params, cache(), z(b, t), full(b, ctx), full(b, t),
                tables(b))

    # analytic cross-shard model, expressed per device: the ring model
    # counts 2·(S−1) payload hops per reduction; the per-device operand
    # volume is the payload itself, once per attention layer.
    n_attn = model.paged_kv_dims()[0]

    def expected_allreduce(tokens):
        if S <= 1:
            return {}
        wire = _split_kv_collective_bytes(S, n_attn, cfg.n_heads, cfg.hd,
                                          B, tokens)
        return {"all-reduce": wire // (2 * (S - 1))}

    decode = functools.partial(model.decode_step_paged, impl=be._impl)
    entries = [
        DispatchEntry(
            name="decode_step_paged", kv_shards=S, fn=decode,
            make_args=lambda: decode_args(B, c),
            make_kwargs=lambda: shard_kw(B),
            vocab_size=V,
            host_budget_bytes=8 * B * c,        # conf fp32 + tok int32
            expected_collectives=expected_allreduce(c),
            churn=None if S > 1 else ChurnSpec(
                # raw tick batches 1..4 bucket to {1, 2, 4}: three shapes
                arg_makers=[
                    (lambda b=b: (decode_args(be._bucket(b), c),
                                  shard_kw(be._bucket(b))))
                    for b in (1, 2, 3, 4)],
                declared_buckets=3),
        ),
        DispatchEntry(
            name="prefill_paged", kv_shards=S,
            fn=functools.partial(model.prefill_paged, head_mode="sample",
                                 impl=be._impl, kv_shard=be._kv_shard),
            make_args=lambda: prefill_args(B, T),
            vocab_size=V,
            host_budget_bytes=8 * B,            # [B] conf + [B] tok
            # wave prefill only scatters into the pool (no paged-prefix
            # read) — no cross-shard merge, so no collectives even sharded
            expected_collectives={},
        ),
        DispatchEntry(
            name="prefill_chunk_paged", kv_shards=S,
            fn=functools.partial(model.prefill_chunk_paged, impl=be._impl),
            make_args=lambda: chunk_args(B, T),
            make_kwargs=lambda: shard_kw(B),
            vocab_size=V,
            host_budget_bytes=8 * B,            # [B] conf + [B] tok
            expected_collectives=expected_allreduce(T),
        ),
    ]

    if S == 1:
        k_shape = tuple(be.kv.k_pages.shape)   # [L, P, page, KVH, hd]
        host_block = (k_shape[0], 4) + k_shape[2:]
        kdt = be.kv.k_pages.dtype
        entries += [
            DispatchEntry(
                name="copy_pages", kv_shards=S, fn=copy_pages,
                make_args=lambda: (cache(), z(4), z(4)), pool_arg=0,
                vocab_size=V, host_budget_bytes=0,
                expected_collectives={},
            ),
            DispatchEntry(
                name="write_pages", kv_shards=S, fn=write_pages,
                make_args=lambda: (cache(), z(4),
                                   z(*host_block, dtype=kdt),
                                   z(*host_block, dtype=kdt)),
                pool_arg=0, vocab_size=V, host_budget_bytes=0,
                expected_collectives={},
            ),
        ]
    return entries


# ---------------------------------------------------------------------------
# HLO006 — dispatch-site registration
# ---------------------------------------------------------------------------

# Modules whose dispatch and capture sites must be registered (paths
# relative to the repo root).  Adding a dispatch call or a captured graph
# to any of these without registering it here makes
# `python -m repro_torch.analysis.check` fail.
SCANNED_MODULES = (
    "src/repro_torch/serving/backends.py",
    "src/repro_torch/serving/kv_pool.py",
    "src/repro_torch/models/transformer.py",
    "src/repro_torch/distributed/collectives.py",
    "src/repro_torch/kernels/ops.py",
    "src/repro_torch/serving/graphs.py",
    "src/repro_torch/training/train_loop.py",
)

# the model methods a dispatch site calls, and the graph cache's entry
# (``DispatchGraphs.dispatch``: a captured dispatch's replay)
DISPATCH_METHODS = {"prefill_paged", "prefill_chunk_paged",
                    "decode_step_paged", "prefill_slot", "chunk_forward",
                    "advance_states", "copy_pages", "write_pages",
                    "dispatch"}
# the graph-capture constructions
CAPTURE_CALLS = {"torch.compile", "torch.cuda.graph", "torch.cuda.CUDAGraph"}

# (module, enclosing qualname, called descriptor)
KNOWN_DISPATCH_SITES = {
    ("src/repro_torch/serving/backends.py",
     "ModelBackend._wave", "self.model.prefill_paged"),
    ("src/repro_torch/serving/backends.py",
     "ModelBackend._chunk", "self.model.prefill_chunk_paged"),
    ("src/repro_torch/serving/backends.py",
     "ModelBackend._decode", "self.model.decode_step_paged"),
    ("src/repro_torch/serving/backends.py",
     "ModelBackend._dispatch", "self.graphs.dispatch"),
    ("src/repro_torch/serving/graphs.py",
     "CudaCapturer.capture", "torch.cuda.CUDAGraph"),
    ("src/repro_torch/serving/backends.py",
     "ModelBackend._slot_prefill", "self.model.prefill_slot"),
    ("src/repro_torch/serving/backends.py",
     "ModelBackend._window", "self.model.chunk_forward"),
    ("src/repro_torch/serving/backends.py",
     "ModelBackend._advance", "self.model.advance_states"),
    # the pool's page moves: each body, and the graph cache's replay of
    # the kinds ``copy`` and ``swap_in``
    ("src/repro_torch/serving/kv_pool.py",
     "PagedKVAllocator._device_copy", "copy_pages"),
    ("src/repro_torch/serving/kv_pool.py",
     "PagedKVAllocator._swap_in_device", "write_pages"),
    ("src/repro_torch/serving/kv_pool.py",
     "PagedKVAllocator._pool_dispatch", "self.graphs.dispatch"),
    # the train step's replay (a trainer's own cache)
    ("src/repro_torch/training/train_loop.py",
     "Trainer.train_step", "self.graphs.dispatch"),
}


def repo_root() -> str:
    return os.path.abspath(os.path.join(os.path.dirname(__file__),
                                        "..", "..", ".."))


def _site_of(call) -> str | None:
    """The descriptor of a dispatch or capture call, None for any other."""
    desc = ast.unparse(call.func)
    if desc in CAPTURE_CALLS:
        return desc
    name = call.func.attr if isinstance(call.func, ast.Attribute) \
        else call.func.id if isinstance(call.func, ast.Name) else None
    return desc if name in DISPATCH_METHODS else None


def _is_capture_decorator(dec) -> bool:
    node = dec.func if isinstance(dec, ast.Call) else dec
    return ast.unparse(node) in CAPTURE_CALLS


def scan_dispatch_sites(root: str | None = None) -> list:
    """All dispatch and capture sites in SCANNED_MODULES →
    [(module, qualname, descriptor, lineno), ...]."""
    root = root or repo_root()
    sites = []
    for rel in SCANNED_MODULES:
        with open(os.path.join(root, rel)) as f:
            tree = ast.parse(f.read(), filename=rel)

        def walk(node, qual):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                    for dec in child.decorator_list:
                        if _is_capture_decorator(dec):
                            sites.append((rel, child.name, "@" + ast.unparse(
                                dec.func if isinstance(dec, ast.Call)
                                else dec), child.lineno))
                    walk(child, f"{qual}.{child.name}"
                         if qual != "<module>" else child.name)
                elif isinstance(child, ast.ClassDef):
                    walk(child, f"{qual}.{child.name}"
                         if qual != "<module>" else child.name)
                else:
                    for sub in ast.walk(child):
                        if isinstance(sub, ast.Call):
                            desc = _site_of(sub)
                            if desc is not None:
                                sites.append((rel, qual, desc, sub.lineno))

        walk(tree, "<module>")
    return sites


def audit_registration(root: str | None = None) -> list:
    """HLO006: every scanned dispatch or capture site must be in
    KNOWN_DISPATCH_SITES."""
    out = []
    for rel, qual, desc, lineno in scan_dispatch_sites(root):
        if (rel, qual, desc) not in KNOWN_DISPATCH_SITES:
            out.append(Finding(
                "HLO006", f"{rel}:{lineno}",
                f"unregistered dispatch site in {qual}: {desc!r} — add it "
                f"to the dispatch inventory "
                f"(repro_torch.analysis.inventory.KNOWN_DISPATCH_SITES) so "
                f"the dispatch audit covers it"))
    return out
