"""Model step and graph cache (the backend's and ``DispatchGraphs``'s
spans): the % of the profiled slice's wall time in which the device is
idle and the innermost host range open when the gap began is one of the
program's ``prefill.*``, ``decode.*``, ``kv.*``, ``slot.*`` or ``graph.*``
spans; None where no program range named a gap."""

from harness.trace import PROGRAM_LAYERS, STEP_LAYERS


def step_host_idle_share(idle_by_span: dict, window_s: float):
    """% of the slice's wall time idle under a model-step or graph-cache
    span; None where no program span named a gap."""
    if not any(n.startswith(PROGRAM_LAYERS) for n in idle_by_span):
        return None
    idle = sum(v for n, v in idle_by_span.items() if n.startswith(STEP_LAYERS))
    return 100.0 * idle / window_s


def read(run):
    t = run.trace
    return None if t is None else step_host_idle_share(t["idle_by_span"],
                                                       t["window_s"])
