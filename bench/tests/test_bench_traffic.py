"""The traffic generator: its lengths' moments and caps, its arrivals, and
the same offered work for every seed."""

import json
import math
from pathlib import Path

import numpy as np
import pytest

from harness.traffic import (RESERVED_IDS, bursty_dues, lognormal_quantiles,
                             make_arrivals, poisson_dues, rng_for)

TRAFFIC = Path(__file__).resolve().parents[1] / "traffic"


def _uncapped_moments(mean, std, n=20000):
    x = lognormal_quantiles(mean, std, n, 1, 10 ** 9)
    return x.mean(), x.std()


@pytest.mark.parametrize("mean,std", [(213, 508), (321, 214), (89, 22),
                                      (175, 67)])
def test_lognormal_quantiles_match_the_profile(mean, std):
    m, s = _uncapped_moments(mean, std)
    assert abs(m - mean) / mean < 0.01
    assert abs(s - std) / std < 0.05


def test_caps_cut_what_the_profile_says():
    x = lognormal_quantiles(213, 508, 10000, 1, 2048)
    assert x.max() == 2048 and x.min() >= 1
    cut = (lognormal_quantiles(213, 508, 10000, 1, 10 ** 9) > 2048).mean()
    assert 0.005 < cut < 0.015          # ShareGPT prompts: about 1% cut


@pytest.mark.parametrize("name", sorted(p.stem for p in TRAFFIC.glob("*.json")))
def test_every_seed_replays_one_schedule(name):
    """Every run seed gets the same due times and lengths in the same
    order; the seed draws the prompt ids, the same ones for the same seed,
    away from the reserved ids."""
    mix = json.loads((TRAFFIC / f"{name}.json").read_text())
    a = make_arrivals(mix, 11, 40.0, 151936)
    b = make_arrivals(mix, 11, 40.0, 151936)
    c = make_arrivals(mix, 2 ** 40 + 3, 40.0, 151936)
    assert a == b
    assert [(x.due, len(x.prompt), x.max_new) for x in a] == \
        [(x.due, len(x.prompt), x.max_new) for x in c]
    assert [x.prompt for x in a] != [x.prompt for x in c]
    assert min(min(r.prompt) for r in a + c) >= RESERVED_IDS
    assert all(x.due < y.due for x, y in zip(a, a[1:]))
    assert max(len(r.prompt) for r in a) <= mix["prompt"]["max"]
    assert max(r.max_new for r in a) <= mix["output"]["max"]


def test_stratified_order_spreads_every_band():
    from harness.traffic import stratified
    v = np.arange(64)
    out = stratified(v, rng_for(3, 1), strata=16)
    assert sorted(out) == list(v)
    for g in range(4):
        assert sorted(x // 4 for x in out[16 * g:16 * g + 16]) == \
            list(range(16))


def test_poisson_gaps_are_a_fixed_set_in_a_seeded_order():
    d1 = poisson_dues(4.0, 50.0, rng_for(1, 1))
    d2 = poisson_dues(4.0, 50.0, rng_for(2, 1))
    g1, g2 = np.diff(np.r_[0, d1]), np.diff(np.r_[0, d2])
    assert np.allclose(np.sort(g1), np.sort(g2))
    assert abs(len(d1) - 200) <= 1
    assert abs(g1.mean() - 0.25) < 0.01


def test_bursty_counts_follow_the_square_wave():
    d = bursty_dues(2.5, 20.0, rng_for(5, 1), 8, 0.2, 10.0)
    base = 2.5 / (0.2 * 8 + 0.8)
    in_burst = ((d % 10.0) < 2.0).sum()
    assert in_burst == 2 * round(base * 8 * 2.0)
    assert len(d) - in_burst == 2 * round(base * 8.0)
    assert math.isclose(len(d) / 20.0, 2.5, rel_tol=0.05)
