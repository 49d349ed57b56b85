"""The window arithmetic, on hand-made records."""

import pytest

from harness import stats
from harness.serve import Call
from harness.traffic import Arrival


def _a(rid, due):
    return Arrival(rid, due, (5, 6), 4)


def test_tokens_in_window_count_every_request():
    commits = {1: [(0.5, 3), (1.5, 2)], 2: [(1.9, 4), (2.0, 9)]}
    assert stats.tokens_in(commits, 1.0, 2.0) == 6


def test_ttft_counts_from_due_and_censors_at_the_window_end():
    arr = [_a(1, 1.0), _a(2, 1.5), _a(3, 0.5)]        # 3 is due before
    commits = {1: [(1.2, 1), (1.4, 2)], 2: []}
    assert stats.ttfts(arr, commits, 1.0, 3.0) == pytest.approx([0.2, 1.5])


def test_p90_is_numpys_linear_percentile():
    assert stats.p90(list(range(11))) == pytest.approx(9.0)
    assert stats.p90([]) is None


def test_queue_wait_and_backlog():
    arr = [_a(1, 0.0), _a(2, 1.0), _a(3, 2.5)]
    assert stats.queue_waits(arr, {1: 0.25, 2: 2.8}, 0.0, 2.0) == \
        pytest.approx([0.25, 1.0])
    commits = {1: [(0.5, 1)]}
    assert stats.backlog(arr, commits, 2.0) == 1
    assert stats.backlog(arr, commits, 0.4) == 1


def test_calls_in_window_by_start():
    calls = [Call(t, t + 0.1, 8, [], [], 0, 0) for t in (0.5, 1.0, 1.95)]
    assert len(stats.calls_in(calls, 1.0, 2.0)) == 2


def test_token_gaps_share_each_commit_among_its_tokens():
    arr = [Arrival(1, 0.0, (5,), 6), Arrival(2, 0.0, (5,), 3),
           Arrival(3, -1.0, (5,), 3)]                  # 3 is due before
    commits = {1: [(1.0, 2), (1.3, 3), (1.5, 1)], 2: [(1.0, 1), (3.0, 2)],
               3: [(1.0, 1), (1.1, 1)]}
    assert sorted(stats.token_gaps(arr, commits, 0.0, 2.0)) == \
        pytest.approx(sorted([0.1, 0.1, 0.1, 0.2]))


def test_commit_decisions_read_against_the_threshold():
    import math

    from reference.block_diffusion_lm import decision_errors, rule_commits
    t = math.log(9.0)                                  # threshold 0.9
    lodds = {0: t + 1.0, 1: t - 0.5, 2: t - 3.0, 3: t + 0.25, 4: -6.0,
             5: -7.0}
    steps = [[(0, True), (1, True), (2, False)],       # 1 commits below
             [(3, False), (4, True)],                  # 3 passes, skipped
             [(5, True)]]                              # a lone commit
    hit, miss = decision_errors(steps, lodds, 0.9)
    assert hit == pytest.approx([-1.0, 0.5])           # the lone commit out
    assert miss == pytest.approx([-3.0, 0.25])
    rule = rule_commits(steps, lodds, 0.9)
    assert rule == {0: True, 1: False, 2: False, 3: True, 4: False, 5: True}
    assert rule_commits([[(4, False), (2, False)]], lodds, 0.9) == \
        {4: False, 2: True}                            # progress: the best
    hit, miss = decision_errors(steps, lodds, 0.9, rule)
    assert max(hit + miss) <= 0


def test_a_limit_left_null_holds_nothing_correct():
    from harness.check import verdict
    res = {"gap": 0.1, "faults": [], "tokens": 500}
    cfg = {"check": {"logit_gap": 1.0, "min_tokens": 300}}
    assert verdict(cfg, res)[0]
    cfg["check"]["logit_gap"] = None
    ok, checked = verdict(cfg, res)
    assert not ok and checked["logit_gap"]["limit"] is None
    cfg = {"check": {"logit_gap": 1.0, "min_tokens": 300,
                     "decision_error": 0.1}}
    assert not verdict(cfg, res)[0]                    # no reading: fails
    assert verdict(cfg, dict(res, decision_error=0.05))[0]
    assert not verdict(cfg, dict(res, decision_error=0.2))[0]


def test_prefill_shapes_pad_to_one_aligned_chunk():
    """On the card the program pads a prefill's token axis to at least one
    aligned chunk: a 16-token prefill is a ``[1, 32]`` dispatch."""
    from harness.runner import shapes_used
    calls = [Call(0.0, 1.0, 32, [(10, 32)] * 3, [(0, 16)], 0, 0),
             Call(1.0, 2.0, 32, [], [(0, 448), (0, 20)], 0, 0)]
    assert shapes_used(calls, 32) == {"decode 4x32": 1, "prefill 1x32": 1,
                                      "prefill 2x512": 1}
    assert "prefill 1x16" in shapes_used(calls)
