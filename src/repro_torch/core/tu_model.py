"""Online token-utilization estimator (paper §5.3).

Estimates ``N_commit(c)`` — expected committed tokens per step for each
candidate chunk size — from the live commit stream.  Key observation: a step
executed with window size ``w`` yields an unbiased prefix-truncation sample
for every candidate ``c ≤ w`` (the commits that landed in the first ``c``
window positions), so large-chunk steps update the whole curve at once — this
is how the paper "observes the number of committed tokens under the largest
chunk size" during warmup and keeps updating online.

Candidates larger than any observed window are extrapolated with a concave
power-law fit (commits exhibit diminishing returns in ``c``, §5.3 Fig. 5b),
and the final estimate is made monotone non-decreasing in ``c``.
"""

from __future__ import annotations

import numpy as np


class TokenUtilEstimator:
    def __init__(self, candidates, ema: float = 0.95,
                 prior_tokens_per_step: float = 3.8):
        """``prior_tokens_per_step``: expected commits for the largest
        candidate before any observation (paper's BD32 ≈ 3.8)."""
        self.candidates = sorted(candidates)
        self.ema = ema
        cmax = self.candidates[-1]
        # concave prior: N(c) = p·c^0.5 scaled to hit the prior at cmax
        a = prior_tokens_per_step / np.sqrt(cmax)
        self._est = {c: min(c, a * np.sqrt(c)) for c in self.candidates}
        self._fresh = {c: 0 for c in self.candidates}
        self._n_updates = 0

    # ------------------------------------------------------------------
    def update(self, commit_mask, valid_len: int):
        """commit_mask: bool array over window positions for one request-step;
        valid_len: how many positions were actually evaluated."""
        commit_mask = np.asarray(commit_mask, bool)
        self._n_updates += 1
        for c in self.candidates:
            if c > valid_len:
                break
            n = float(commit_mask[:c].sum())
            self._est[c] = self.ema * self._est[c] + (1 - self.ema) * n
            self._fresh[c] += 1

    def update_batch(self, commit_masks, valid_lens):
        for m, v in zip(commit_masks, valid_lens):
            self.update(m, int(v))

    # ------------------------------------------------------------------
    def _extrapolate(self):
        """Power-law fit N(c)=a·c^g through fresh candidates for stale ones."""
        fresh = [c for c in self.candidates if self._fresh[c] > 0]
        if len(fresh) < 2:
            return dict(self._est)
        x = np.log([float(c) for c in fresh])
        y = np.log([max(self._est[c], 1e-3) for c in fresh])
        A = np.stack([x, np.ones_like(x)], 1)
        (g, loga), *_ = np.linalg.lstsq(A, y, rcond=None)
        g = float(np.clip(g, 0.0, 1.0))        # concave, non-decreasing
        a = float(np.exp(loga))
        out = {}
        cmax_fresh = max(fresh)
        for c in self.candidates:
            if self._fresh[c] > 0 and c <= cmax_fresh:
                out[c] = self._est[c]
            else:
                out[c] = a * c ** g
        return out

    def estimate(self, c: int) -> float:
        est = self._extrapolate()
        # isotonic: commits can only grow with window size
        val = 0.0
        for cc in self.candidates:
            val = max(val, est[cc])
            if cc == c:
                break
        return float(np.clip(val, 1e-3, c))

    def curve(self):
        return {c: self.estimate(c) for c in self.candidates}

    def token_utilization(self, c: int) -> float:
        return self.estimate(c) / c
