"""90th percentile over the requests due in the window of the time from
each one's due time to its first committed token; a request with no token
by the window's end counts at its age then (host clock)."""

from harness import stats


def read(run):
    v = stats.p90(stats.ttfts(run.arrivals, run.rec.commits, run.w0,
                              run.w1))
    return None if v is None else v * 1e3
