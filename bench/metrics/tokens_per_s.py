"""Output tokens committed inside the window, by every request, over the
window's seconds (host clock)."""

from harness import stats


def read(run):
    return stats.tokens_in(run.rec.commits, run.w0, run.w1) / run.seconds
