"""90th percentile of the time a token, over every token after the first of
the requests due in the window: each commit's distance from the request's
commit before it, shared among the tokens it committed (host clock)."""

from harness import stats


def read(run):
    v = stats.p90(stats.token_gaps(run.arrivals, run.rec.commits, run.w0,
                                   run.w1))
    return None if v is None else v * 1e3
