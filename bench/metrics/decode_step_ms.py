"""Model step: the mean host-clock time of the window's
``ModelBackend.decode_step`` calls, each ending on its scalars' fetch (a
tick's prefill chunk and decode dispatch, and the host commit of both)."""

from harness import stats


def read(run):
    v = stats.spans_in(run.rec.spans, "decode_step", run.w0, run.w1)
    return 1e3 * sum(v) / len(v) if v else None
