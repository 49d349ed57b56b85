"""Engine layer (``EngineCore._admit``): 90th percentile of due time to
admission over the requests due in the window; one not admitted by the
window's end counts at its age then."""

from harness import stats


def read(run):
    v = stats.p90(stats.queue_waits(run.arrivals, run.rec.admit, run.w0,
                                    run.w1))
    return None if v is None else v * 1e3
