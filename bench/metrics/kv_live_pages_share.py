"""KV pool (``PagedKVAllocator``): the peak over the window's ticks of the
pool gauge ``pages_in_use`` over ``n_pages`` (the program's tick gauges),
in %."""


def read(run):
    v = [100.0 * g["pages_in_use"] / g["n_pages"]
         for r in run.ticks() if (g := r.get("gauges")) and g.get("n_pages")]
    return max(v) if v else None
