"""Engine and model step, host (``EngineCore.tick``, ``ModelBackend``): the
mean host time of the window's ticks outside every dispatch's flight, in
ms, from the program's spans.  A flight runs from a ``graph.replay``,
``graph.eager`` or ``graph.capture`` start to the end of the next
``*.fetch``; the ticks of the profiled slice are left out.  It reads a
traced run, a process the profiler has slowed (PERF.md)."""

FLIGHT_STARTS = ("graph.replay", "graph.eager", "graph.capture")


def _covered(intervals, lo: float, hi: float) -> float:
    """Length of the union of ``intervals`` inside [lo, hi]."""
    total, end = 0.0, lo
    for a, b in sorted(intervals):
        a, b = max(a, end), min(b, hi)
        if b > a:
            total += b - a
            end = b
    return total


def tick_host_ms(spans: list, w0: float, w1: float, skip=None):
    """Mean host time of the window's ticks outside every dispatch's flight,
    in ms; ``skip`` an interval whose ticks are left out."""
    ticks: dict = {}
    for s in spans:
        ticks.setdefault((s["replica"], s["tick"]), []).append(s)
    host = []
    for group in ticks.values():
        tick = next((s for s in group if s["name"] == "engine.tick"), None)
        if tick is None or tick["t0"] < w0 or tick["t1"] > w1:
            continue
        if skip is not None and tick["t1"] > skip[0] and tick["t0"] < skip[1]:
            continue
        fetches = sorted((s["t0"], s["t1"]) for s in group
                         if s["name"].endswith(".fetch"))
        flights = []
        for a in sorted(s["t0"] for s in group if s["name"] in FLIGHT_STARTS):
            end = next((f1 for f0, f1 in fetches if f0 >= a), None)
            if end is not None:
                flights.append((a, end))
        dur = tick["t1"] - tick["t0"]
        host.append(dur - _covered(flights, tick["t0"], tick["t1"]))
    return 1e3 * sum(host) / len(host) if host else None


def read(run):
    skip = (run.trace["t0"], run.trace["t1"]) if run.trace else None
    return tick_host_ms(run.spans(), run.w0, run.w1, skip)
