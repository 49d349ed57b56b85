"""Block-diffusion decoding semantics (paper §4.1, Table 1).

Token states within a decoding block:

* MASKED   — input is the mask token; output below confidence threshold,
             not committed.
* DECODING — input is the mask token; output crossed the threshold this
             step and is committed (provisional KV).
* DECODED  — input is the committed token (recomputed ≥1 step after
             commitment); KV is valid and may be frozen into the cache.

The commit rule (``commit_decisions``) and the reference block-wise decode
loop (``block_decode_reference``, the paper's BD-<block> baseline) live here;
the streaming chunked variant is in :mod:`repro_torch.core.chunked`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

MASKED, DECODING, DECODED = 0, 1, 2


def softmax_confidence(logits: np.ndarray):
    """logits [*, V] → (confidence [*, ], argmax token [*, ]) in fp64."""
    x = logits.astype(np.float64)
    x = x - x.max(axis=-1, keepdims=True)
    p = np.exp(x)
    p /= p.sum(axis=-1, keepdims=True)
    tok = p.argmax(axis=-1)
    conf = np.take_along_axis(p, tok[..., None], axis=-1)[..., 0]
    return conf, tok.astype(np.int64)


def commit_decisions(conf: np.ndarray, uncommitted: np.ndarray,
                     threshold: float) -> np.ndarray:
    """Which uncommitted positions commit this step.

    conf [W] confidences for window positions; uncommitted [W] bool.
    Commits every uncommitted position with conf > threshold; if none
    qualifies, commits the single highest-confidence uncommitted position
    (progress guarantee — standard practice for confidence-threshold
    diffusion decoding).
    Returns bool [W]: True where a commitment happens this step.
    """
    commit = (conf > threshold) & uncommitted
    if not commit.any() and uncommitted.any():
        masked_conf = np.where(uncommitted, conf, -np.inf)
        commit[int(masked_conf.argmax())] = True
    return commit


def batch_commit_decisions(conf: np.ndarray, uncommitted: np.ndarray,
                           thresholds: np.ndarray) -> np.ndarray:
    """Vectorized :func:`commit_decisions` over a batch.

    conf [B, W] fp64, uncommitted [B, W] bool, thresholds [B].
    Row semantics are identical to the scalar rule: commit every
    uncommitted position above the row's threshold; rows with uncommitted
    positions but no qualifier commit their single highest-confidence
    uncommitted position (numpy argmax tie-break: first maximal index).
    """
    conf = np.asarray(conf, np.float64)
    commit = (conf > np.asarray(thresholds)[:, None]) & uncommitted
    fallback = ~commit.any(axis=1) & uncommitted.any(axis=1)
    if fallback.any():
        masked = np.where(uncommitted, conf, -np.inf)
        rows = np.nonzero(fallback)[0]
        commit[rows, masked[rows].argmax(axis=1)] = True
    return commit


@dataclass
class DecodeTrace:
    """Per-request record of a decode run (for TU accounting and tests)."""
    tokens: list          # committed token ids in position order
    steps: int            # model invocations
    computed_tokens: int  # Σ window sizes over steps
    committed_per_step: list

    @property
    def token_utilization(self) -> float:
        return len(self.tokens) / max(self.computed_tokens, 1)

    @property
    def tokens_per_step(self) -> float:
        return len(self.tokens) / max(self.steps, 1)


def block_decode_reference(step_fn, prompt_len: int, gen_len: int,
                           block_size: int, threshold: float,
                           mask_token: int, eos_token: int | None = None):
    """Reference block-wise diffusion decoding (the paper's fixed-BD baseline).

    ``step_fn(window_tokens, window_start, committed_mask) -> (conf, tok)``
    abstracts one model forward over the full current block window; the same
    closure drives real models and the synthetic commit simulator.

    Decodes ``gen_len`` tokens in blocks of ``block_size``.  Each step the
    whole remaining block is recomputed (no chunking); tokens committed in
    a previous step are fed back as real inputs (and therefore transition
    DECODING → DECODED per Table 1).
    """
    out: list[int] = []
    steps = 0
    computed = 0
    committed_per_step = []
    pos = prompt_len
    done = False
    while len(out) < gen_len and not done:
        blk_len = min(block_size, gen_len - len(out))
        tokens = np.full(blk_len, mask_token, np.int64)
        committed = np.zeros(blk_len, bool)
        while not committed.all():
            conf, tok = step_fn(tokens.copy(), pos, committed.copy())
            commit = commit_decisions(conf, ~committed, threshold)
            tokens = np.where(commit, tok, tokens)
            committed |= commit
            steps += 1
            computed += blk_len
            committed_per_step.append(int(commit.sum()))
        out.extend(int(t) for t in tokens)
        if eos_token is not None and eos_token in tokens:
            out = out[:out.index(eos_token) + 1] if eos_token in out else out
            done = True
        pos += blk_len
    return DecodeTrace(out[:gen_len] if not done else out, steps, computed,
                       committed_per_step)
