"""Device: the share of the profiled slice's wall time in which no
operation ran on the card, in %."""


def read(run):
    t = run.trace
    if t is None or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
