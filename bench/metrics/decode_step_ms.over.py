"""``decode_step_ms`` in a cell above capacity, where it moves the tokens
a second and not a latency tail."""

from harness import stats


def read(run):
    v = stats.spans_in(run.rec.spans, "decode_step", run.w0, run.w1)
    return 1e3 * sum(v) / len(v) if v else None
