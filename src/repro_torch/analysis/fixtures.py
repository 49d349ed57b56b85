"""Mutation fixtures: one deliberately seeded violation per analyzer rule.

``tests/test_torch_analysis.py`` runs each pass over this module (AST
rules: lint scope override; dispatch rules: the toy builders below) and
asserts that EXACTLY the seeded finding fires, naming the offending
op/line — the analyzer is itself mutation-tested.  Nothing imports this
module at runtime and it is excluded from every default lint scope.  The
AST fixtures are the JAX package's, AST105's seeded with torch.
"""

from __future__ import annotations


class OutOfPages(RuntimeError):
    pass


# --- AST101: state write lexically precedes the OutOfPages raise ----------

class BadAllocator:
    def allocate(self, rid, n):
        self._tables[rid] = list(range(n))          # mutation first...
        if n > self.free_pages:
            raise OutOfPages("too late, table already written")  # AST101
        return self._tables[rid]


# --- AST102: decode state committed before the page reservation -----------

class BadBackend:
    def decode_step(self, rids, chunk):
        for rid in rids:
            self._states[rid].commit(0)             # commit first... AST102
        self._reserve_step(self.kv, self._states, rids, chunk)
        return {}


# --- AST103: wall clock inside DES code -----------------------------------

import time                                          # noqa: E402


def bad_tick_latency():
    t0 = time.perf_counter()                         # AST103
    return time.time() - t0                          # AST103


# --- AST104: conditional guarding a tracer call ---------------------------

class BadTracerLoop:
    def tick(self, core, t0, dur):
        if self.tracer is not None:                  # AST104
            self.tracer.tick(core, t0, dur, 0, 0)


# --- AST105: device ops inside the batched host-commit path ---------------

def bad_batch_apply_step(states, conf, tok):
    import torch                                     # AST105
    return torch.as_tensor(conf)                     # AST105


# ===========================================================================
# Dispatch fixtures — torch toys seeding one Pass-1 violation each.
# Builders take the device; every shape is tiny.
# ===========================================================================

FIXTURE_VOCAB = 307        # matches the audit model's distinctive vocab
FIXTURE_B, FIXTURE_C = 2, 4


def undonated_pool_step(device="cpu"):
    """HLO001: a step that takes the page pool and returns a rewritten
    COPY of it (``k_pages.clone()``) instead of updating it in place —
    every step materializes a pool-sized tensor and the pool moves."""
    import torch

    def step(cache, x):
        k = cache["k_pages"].clone()                 # HLO001: a pool copy
        v = cache["v_pages"].clone()
        k[0] += x
        v[0] += x
        return {"k_pages": k, "v_pages": v}

    cache = {"k_pages": torch.zeros((4, 8, 2, 4), device=device),
             "v_pages": torch.zeros((4, 8, 2, 4), device=device)}
    return step, (cache, torch.ones((8, 2, 4), device=device))


def vocab_escaping_step(device="cpu"):
    """HLO002 + HLO003: a fused step that returns the full [B, c, V]
    logits instead of reducing them on device — the vocab axis escapes to
    the host and the output bytes blow the 8·B·c budget."""
    import torch

    def step(x, w):
        return x @ w                                 # [B, c, V] escapes

    args = (torch.zeros((FIXTURE_B, FIXTURE_C, 16), device=device),
            torch.zeros((16, FIXTURE_VOCAB), device=device))
    return step, args


def missing_collective_step(device="cpu"):
    """HLO004: a 'sharded' dispatch that reduces nothing across its shards
    although the analytic model declares an all-reduce — the cross-shard
    merge was silently dropped."""
    import torch

    def step(x):
        return x * 2.0                               # no reduction anywhere

    x = torch.zeros((FIXTURE_B, FIXTURE_C, 4, 18), device=device)
    expected = {"all-reduce": x.numel() * x.element_size()}
    return step, (x,), expected


def unbucketed_grid_step(device="cpu"):
    """HLO005: a dispatch fed raw tick batch sizes with no power-of-two
    bucketing — every batch size is its own shape signature (its own
    captured graph)."""
    import torch

    def step(x):
        return x + 1.0

    makers = [
        (lambda b=b: ((torch.zeros((b, FIXTURE_C), device=device),), {}))
        for b in (1, 2, 3, 4)]                       # raw, unbucketed
    return step, makers
