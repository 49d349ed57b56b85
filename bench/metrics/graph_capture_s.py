"""Graph cache (``DispatchGraphs``): the host seconds of set-up spent
capturing graphs, the program's counter ``graph_capture_s`` at the
window's first tick; None where the program has no such counter."""


def read(run):
    ticks = run.ticks()
    if not ticks:
        return None
    return (ticks[0].get("counters") or {}).get("graph_capture_s")
