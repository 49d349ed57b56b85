"""Streaming chunked decoding (paper §4.4) — per-request state machine.

Decomposes a diffusion block into runtime-sized *chunks* without retraining:

* **fine-grained caching** — the leading window positions whose inputs were
  real (committed-before-this-step) tokens get their KV frozen into the
  prefix cache right after the step (``advance``), extending inter-block
  caching into the intra-block phase (§4.2);
* **dynamic chunk sizing** — every step may use a different chunk size
  (the elastic scheduler's control variable);
* **step-wise reorganization (streaming)** — the window always re-anchors at
  the first unfrozen position, so freed prefix capacity is converted into
  fresh suffix positions and the effective decode order approximates
  original block-wise decoding (§4.4, Fig. 4d).

Window modes:
* ``slide``        — attention-only families; window start == cache len.
* ``block_pinned`` — hybrid (Jamba): recurrent layers recompute the window
  from the block-start state, so the window is pinned to the block start and
  blocks commit atomically via ``advance_states`` (DESIGN.md §6).

In-block streaming (default) clamps the window at the current block
boundary, preserving train-time block dependencies (paper §7.2); out-block
streaming (OBS) lets the window cross blocks for higher throughput at low
load.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.diffusion import batch_commit_decisions, commit_decisions

UNSET = -1


@dataclass
class ChunkedDecodeState:
    """Decode-side state for one request."""

    prompt_len: int
    max_new_tokens: int
    block_size: int
    threshold: float
    mask_token: int
    eos_token: int | None = None
    mode: str = "slide"              # slide | block_pinned
    obs: bool = False                # out-block streaming

    committed: np.ndarray = field(init=False)   # [max_new] token ids or UNSET
    frozen: int = field(default=0, init=False)  # generated tokens with frozen KV
    gen_limit: int = field(init=False)          # shrinks when EOS commits
    steps: int = field(default=0, init=False)
    computed_tokens: int = field(default=0, init=False)
    committed_history: list = field(default_factory=list, init=False)

    def __post_init__(self):
        self.committed = np.full(self.max_new_tokens, UNSET, np.int64)
        self.gen_limit = self.max_new_tokens

    # ------------------------------------------------------------------
    @property
    def window_start(self) -> int:
        """Absolute position where the next window begins."""
        return self.prompt_len + self.frozen

    @property
    def n_committed(self) -> int:
        return int((self.committed[:self.gen_limit] != UNSET).sum())

    @property
    def done(self) -> bool:
        return bool((self.committed[:self.gen_limit] != UNSET).all())

    @property
    def output_tokens(self) -> list[int]:
        return [int(t) for t in self.committed[:self.gen_limit]]

    # ------------------------------------------------------------------
    def window(self, chunk_size: int):
        """Build the next window.

        Returns (tokens [c] int64, start abs-position, valid_len,
        committed_at_input [c] bool).  ``valid_len`` ≤ chunk_size enforces
        the in-block clamp and the generation limit.
        """
        c = chunk_size
        if self.mode == "block_pinned":
            # window pinned at block start; covers the whole current block
            blk_idx = self.frozen // self.block_size
            rel_start = blk_idx * self.block_size
            c = self.block_size
        else:
            rel_start = self.frozen
        start = self.prompt_len + rel_start
        limit = self.gen_limit - rel_start
        if not self.obs and self.mode == "slide":
            blk_end = ((start // self.block_size) + 1) * self.block_size
            limit = min(limit, blk_end - start)
        valid = max(0, min(c, limit))
        toks = np.full(c, self.mask_token, np.int64)
        cai = np.zeros(c, bool)
        sl = self.committed[rel_start:rel_start + valid]
        known = sl != UNSET
        toks[:valid][known] = sl[known]
        cai[:valid] = known
        return toks, start, valid, cai

    def apply_step(self, conf, tok, valid_len: int, cai: np.ndarray,
                   rel_start: int | None = None):
        """Commit decisions for one step.

        conf/tok are per-window-position arrays (length ≥ valid_len) from the
        model (or simulator).  Returns (n_committed_now, n_advance) where
        ``n_advance`` is how many leading window KV entries may be frozen
        (they were committed at input time).  The caller performs the actual
        ``freeze``/``advance_states`` on the model cache.
        Returns (commit_mask [len(cai)] bool, n_advance).
        """
        if rel_start is None:
            rel_start = (self.frozen if self.mode == "slide"
                         else (self.frozen // self.block_size) * self.block_size)
        valid = np.arange(len(cai)) < valid_len
        uncommitted = valid & ~cai
        commit = commit_decisions(np.asarray(conf, np.float64), uncommitted,
                                  self.threshold)
        idx = np.nonzero(commit)[0]
        for i in idx:
            p = rel_start + int(i)
            self.committed[p] = int(tok[i])
            if self.eos_token is not None and int(tok[i]) == self.eos_token:
                self.gen_limit = min(self.gen_limit, p + 1)

        # advance = leading run of committed-at-input positions
        if self.mode == "block_pinned":
            n_adv = 0
            blk_idx = self.frozen // self.block_size
            blk_lo = blk_idx * self.block_size
            blk_hi = min(blk_lo + self.block_size, self.gen_limit)
            if (self.committed[blk_lo:blk_hi] != UNSET).all():
                n_adv = blk_hi - self.frozen          # whole block commits
        else:
            n_adv = 0
            for i in range(valid_len):
                if cai[i]:
                    n_adv += 1
                else:
                    break
            # never advance past the (possibly shrunk) generation limit
            n_adv = min(n_adv, self.gen_limit - self.frozen)
        self.steps += 1
        self.computed_tokens += int(valid_len)
        self.committed_history.append(len(idx))
        return commit, n_adv

    def advance(self, n: int):
        self.frozen += int(n)

    # ------------------------------------------------------------------
    @property
    def token_utilization(self) -> float:
        return self.n_committed / max(self.computed_tokens, 1)


# ===========================================================================
# Batched host-side decode logic (the serving hot path)
#
# Backends step many requests per iteration; the per-request ``window()`` /
# ``apply_step()`` pair costs a Python loop per request plus a Python loop
# per window position.  The batched variants below compute the same
# quantities across the live batch with numpy array ops — only a single
# variable-length slice copy (window) / index-assignment (commit writeback)
# per row remains, because each state owns its own ``committed`` array.
# Slide-mode only: block-pinned (hybrid) windows have a different width per
# step and stay on the scalar path.
# ===========================================================================

def batch_windows(states, chunk_size: int):
    """Vectorized ``window(chunk_size)`` over slide-mode states.

    Returns (tokens [B, c] int64, start [B] int64, valid [B] int64,
    committed_at_input [B, c] bool) — row ``i`` is exactly
    ``states[i].window(chunk_size)``.
    """
    B, c = len(states), chunk_size
    frozen = np.fromiter((s.frozen for s in states), np.int64, B)
    prompt = np.fromiter((s.prompt_len for s in states), np.int64, B)
    gen_limit = np.fromiter((s.gen_limit for s in states), np.int64, B)
    bs = np.fromiter((s.block_size for s in states), np.int64, B)
    obs = np.fromiter((s.obs for s in states), bool, B)
    start = prompt + frozen
    limit = gen_limit - frozen
    blk_end = (start // bs + 1) * bs
    limit = np.where(obs, limit, np.minimum(limit, blk_end - start))
    valid = np.maximum(0, np.minimum(c, limit))
    toks = np.empty((B, c), np.int64)
    toks[:] = np.fromiter((s.mask_token for s in states), np.int64,
                          B)[:, None]
    cai = np.zeros((B, c), bool)
    for i, s in enumerate(states):
        v = int(valid[i])
        if v:
            sl = s.committed[s.frozen:s.frozen + v]
            known = sl != UNSET
            toks[i, :v][known] = sl[known]
            cai[i, :v] = known
    return toks, start, valid, cai


def freeze_run(valid: np.ndarray, cai: np.ndarray) -> np.ndarray:
    """Length of each row's leading committed-at-input run — how many
    window KV entries may be frozen after the step (``n_advance``).

    Computable BEFORE the step runs: the run counts positions committed in
    *earlier* steps, and an EOS committed this step always lands at or past
    the first uncommitted position, so it can never clamp the run (windows
    are already clamped to ``gen_limit``).  This is what lets the fused
    device step freeze window KV in the same dispatch that computes it.
    """
    stop = ~cai | (np.arange(cai.shape[1])[None, :] >= valid[:, None])
    return np.where(stop.any(axis=1), stop.argmax(axis=1), valid)


def batch_apply_step(states, conf, tok, valid: np.ndarray, cai: np.ndarray):
    """Vectorized ``apply_step`` over slide-mode states.

    conf/tok [B, c]; valid/cai from :func:`batch_windows`.  Returns
    (commit_mask [B, c] bool, n_advance [B] int64); each state's
    ``committed`` / ``gen_limit`` / step counters are updated exactly as
    its scalar ``apply_step`` would.  Rows with ``valid == 0`` are no-ops
    (the scalar path is never invoked for them), matching the backends'
    skip behaviour.
    """
    B, c = cai.shape
    conf = np.asarray(conf, np.float64)
    live = valid > 0
    validm = np.arange(c)[None, :] < valid[:, None]
    uncommitted = validm & ~cai
    thresholds = np.fromiter((s.threshold for s in states), np.float64, B)
    commit = batch_commit_decisions(conf, uncommitted, thresholds)

    for i in np.nonzero(live)[0]:
        s = states[i]
        idx = np.nonzero(commit[i])[0]
        if idx.size:
            s.committed[s.frozen + idx] = tok[i, idx]
            if s.eos_token is not None:
                eos = idx[np.asarray(tok[i, idx]) == s.eos_token]
                if eos.size:
                    s.gen_limit = min(s.gen_limit, s.frozen + int(eos[0]) + 1)
        s.steps += 1
        s.computed_tokens += int(valid[i])
        s.committed_history.append(int(idx.size))

    n_adv = freeze_run(valid, cai)
    gen_limit = np.fromiter((s.gen_limit for s in states), np.int64, B)
    frozen = np.fromiter((s.frozen for s in states), np.int64, B)
    n_adv = np.where(live, np.minimum(n_adv, gen_limit - frozen), 0)
    return commit, n_adv
