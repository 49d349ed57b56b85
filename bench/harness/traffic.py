"""Open-loop traffic from a mix file (``bench/traffic/<name>.json``).

A mix gives the length profile of a public data set (mean and standard
deviation of prompt and output tokens, each with a cap) and an arrival
process with its rate.  Lengths are lognormal with the profile's mean and
standard deviation, taken at fixed quantiles, so every seed serves the same
multiset of sizes; the seed only orders them and draws the prompt token
ids.  Arrivals likewise: a Poisson mix takes its gaps at fixed quantiles of
the exponential, in an order the seed draws; a bursty mix (a square wave of
rate, ``bursty_rate`` of the program's ``serving/workload.py``) puts a fixed
count of arrivals in each burst and each lull, at jittered even spacing.
The order is stratified (``STRATA`` bands of the sorted values, one of each
band in every run of ``STRATA`` requests), so any stretch of the schedule
holds about the whole distribution, and it is drawn from ``SCHEDULE_SEED``:
every run replays one schedule (a trace drawn once from the profile), and
the run's seed draws only the prompt ids (and, elsewhere, the weights).
The tails of a single prefill lane at four fifths of its capacity swing
with the order in which long prompts arrive, far more than the program's
own run-to-run noise; a replayed schedule keeps the spread between runs
down to what the system does with it.

Copied in idea from ``repro_torch/serving/workload.py``; the lengths there
are clipped normals, which put a third of ShareGPT's prompts at the clip.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from statistics import NormalDist

import numpy as np

RESERVED_IDS = 4        # ids 0..3 are the model's specials (mask id 3)
STRATA = 16
SCHEDULE_SEED = 2026    # draws the order of every mix's sizes and gaps


@dataclass(frozen=True)
class Arrival:
    """One request of a run: its due time (seconds from the traffic's
    start), prompt token ids and output length."""
    rid: int
    due: float
    prompt: tuple
    max_new: int


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """A numpy generator for ``seed`` (any whole number) and a stream id,
    so the harness's draws never share a stream."""
    return np.random.default_rng([seed % (1 << 64), stream])


def lognormal_quantiles(mean: float, std: float, n: int, lo: int,
                        hi: int) -> np.ndarray:
    """``n`` lengths at the quantiles (i + 0.5) / n of the lognormal with
    this mean and standard deviation, rounded and clipped to [lo, hi]."""
    s2 = math.log1p((std / mean) ** 2)
    mu = math.log(mean) - s2 / 2
    dist = NormalDist(mu, math.sqrt(s2))
    q = [dist.inv_cdf((i + 0.5) / n) for i in range(n)]
    return np.clip(np.rint(np.exp(q)), lo, hi).astype(np.int64)


def stratified(values, rng, strata: int = STRATA) -> np.ndarray:
    """``values`` in an order drawn by ``rng`` in which every run of
    ``strata`` consecutive entries holds one value of each band of the
    sorted values (the last run holds what is left)."""
    v = np.sort(np.asarray(values))
    bands = [rng.permutation(b) for b in np.array_split(v, strata)]
    out = []
    for i in range(max(len(b) for b in bands)):
        group = [b[i] for b in bands if i < len(b)]
        out.extend(rng.permutation(group))
    return np.asarray(out, dtype=v.dtype)


def poisson_dues(rate: float, span: float, rng) -> np.ndarray:
    """Due times over [0, span): the gaps of a Poisson process at rate
    ``rate``, taken at fixed quantiles of the exponential, in a stratified
    order drawn by ``rng``."""
    n = max(1, int(round(rate * span)))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    dues = np.cumsum(stratified(gaps, rng))
    return dues[dues < span]


def bursty_dues(rate: float, span: float, rng, burst_ratio: float,
                duty: float, period: float) -> np.ndarray:
    """Due times over [0, span) of a square wave with time-average ``rate``:
    ``base·burst_ratio`` for the first ``duty`` of each period, ``base``
    after.  Each burst and each lull gets its expected count of arrivals,
    evenly spaced with a jitter drawn from ``rng``."""
    base = rate / (duty * burst_ratio + (1.0 - duty))
    out = []
    t0 = 0.0
    while t0 < span:
        for lo, length, lam in ((t0, duty * period, base * burst_ratio),
                                (t0 + duty * period, (1 - duty) * period,
                                 base)):
            n = int(round(lam * length))
            if n:
                out.append(lo + (np.arange(n) + rng.random(n)) * length / n)
        t0 += period
    dues = np.sort(np.concatenate(out)) if out else np.zeros(0)
    return dues[dues < span]


def make_arrivals(mix: dict, seed: int, span: float, vocab: int) -> list:
    """The requests due over [0, span) for ``mix``: the schedule is the
    mix's own, the prompt ids are drawn from ``seed``."""
    arr = mix["arrivals"]
    rng = rng_for(SCHEDULE_SEED, 1)
    if arr["process"] == "poisson":
        dues = poisson_dues(arr["rate"], span, rng)
    elif arr["process"] == "bursty":
        dues = bursty_dues(arr["rate"], span, rng, arr["burst_ratio"],
                           arr["duty"], arr["period"])
    else:
        raise ValueError(f"unknown arrival process {arr['process']!r}")
    n = len(dues)
    p, o = mix["prompt"], mix["output"]
    plen = stratified(lognormal_quantiles(p["mean"], p["std"], n, p["min"],
                                          p["max"]), rng)
    olen = stratified(lognormal_quantiles(o["mean"], o["std"], n, o["min"],
                                          o["max"]), rng)
    ids = rng_for(seed, 2)
    return [Arrival(i, float(dues[i]),
                    tuple(int(t) for t in ids.integers(RESERVED_IDS, vocab,
                                                       int(plen[i]))),
                    int(olen[i]))
            for i in range(n)]
