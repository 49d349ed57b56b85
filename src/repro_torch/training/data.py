"""Deterministic synthetic token pipeline.

Every global batch is a pure function of (seed, step) — hash-based counter
RNG — so restart-after-failure resumes the exact data stream with O(1)
skipping (no state to checkpoint beyond the step counter), and elastic
re-sharding keeps per-example content stable regardless of host layout.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    reserved_low: int = 4          # ids < reserved_low never emitted (mask etc.)


class SyntheticTokenStream:
    """Markov-ish synthetic LM data (learnable structure, not iid noise):
    token_{t+1} depends on token_t via a seeded permutation + noise, so a
    real model's loss measurably decreases — useful for the train examples."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size - cfg.reserved_low
        self._perm = rng.permutation(v)
        self._noise_p = 0.1

    def batch(self, step: int) -> np.ndarray:
        """[global_batch, seq_len] int32, pure function of step."""
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, 0xD1FF]))
        v = cfg.vocab_size - cfg.reserved_low
        B, T = cfg.global_batch, cfg.seq_len
        out = np.empty((B, T), np.int64)
        out[:, 0] = rng.integers(0, v, B)
        noise = rng.random((B, T)) < self._noise_p
        jump = rng.integers(0, v, (B, T))
        for t in range(1, T):
            nxt = self._perm[out[:, t - 1]]
            out[:, t] = np.where(noise[:, t], jump[:, t], nxt)
        return (out + cfg.reserved_low).astype(np.int32)

    def __iter__(self):
        step = 0
        while True:
            yield self.batch(step)
            step += 1
