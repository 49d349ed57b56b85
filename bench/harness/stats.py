"""Window arithmetic over what the probes recorded.

Every time is on the engine's wall clock, whose zero is the traffic's
start; the window is [w0, w1).  A request belongs to the window when it
fell due inside it, and its times count from that due time.
"""

from __future__ import annotations

import numpy as np


def p90(values) -> float | None:
    """The 90th percentile, numpy's linear interpolation (the program's own
    ``EngineReport`` convention); None for no values."""
    return float(np.percentile(values, 90)) if len(values) else None


def due_in(arrivals, w0: float, w1: float) -> list:
    return [a for a in arrivals if w0 <= a.due < w1]


def tokens_in(commits: dict, w0: float, w1: float) -> int:
    """Tokens committed inside the window, by every request."""
    return sum(n for evs in commits.values() for t, n in evs
               if w0 <= t < w1)


def ttfts(arrivals, commits: dict, w0: float, w1: float) -> list:
    """Seconds from due time to first committed token, for each request due
    in the window; one with no token by ``w1`` counts at its age then."""
    out = []
    for a in due_in(arrivals, w0, w1):
        evs = [t for t, _ in commits.get(a.rid, ()) if t < w1]
        out.append((min(evs) if evs else w1) - a.due)
    return out


def token_gaps(arrivals, commits: dict, w0: float, w1: float) -> list:
    """Seconds a token, for every token after a request's first commit:
    each commit's distance from the request's commit before it, over the
    tokens it committed, counted once for each of them.  Requests due in
    the window, commits before ``w1``."""
    out = []
    for a in due_in(arrivals, w0, w1):
        evs = sorted((t, n) for t, n in commits.get(a.rid, ()) if t < w1)
        for (t0, _), (t1, n) in zip(evs, evs[1:]):
            out += [(t1 - t0) / n] * n
    return out


def queue_waits(arrivals, admit: dict, w0: float, w1: float) -> list:
    """Seconds from due time to admission for each request due in the
    window; one not admitted by ``w1`` counts at its age then."""
    out = []
    for a in due_in(arrivals, w0, w1):
        t = admit.get(a.rid)
        out.append((t if t is not None and t < w1 else w1) - a.due)
    return out


def calls_in(calls, w0: float, w1: float) -> list:
    """The ``decode_step`` calls that started inside the window."""
    return [c for c in calls if w0 <= c.t0 < w1]


def spans_in(spans, name: str, w0: float, w1: float) -> list:
    return [t1 - t0 for n, t0, t1 in spans if n == name and w0 <= t0 < w1]


def backlog(arrivals, commits: dict, t: float) -> int:
    """Requests due by ``t`` that have no committed token by ``t``."""
    return sum(1 for a in arrivals if a.due <= t and not any(
        s <= t for s, _ in commits.get(a.rid, ())))
