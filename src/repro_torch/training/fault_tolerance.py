"""Fault-tolerance utilities of training.

* :class:`StragglerMonitor` — per-host step-time tracking with robust
  outlier detection (median + MAD): flags hosts whose step times are
  persistently slow.
* :class:`FailureInjector` / :class:`SimulatedFailure` — the deterministic
  failure schedule of restart drills, re-exported from
  :mod:`repro_torch.common.faults`.
* :func:`elastic_shardings` — the specs of a logical-axis tree under
  another mesh's rules (restoring a checkpoint after the mesh grew or
  shrank).
"""

from __future__ import annotations

from collections import defaultdict, deque

import numpy as np

from repro_torch.common.faults import FailureInjector, SimulatedFailure

__all__ = ["StragglerMonitor", "FailureInjector", "SimulatedFailure",
           "elastic_shardings"]


class StragglerMonitor:
    def __init__(self, window: int = 32, threshold_mads: float = 6.0,
                 min_samples: int = 8):
        self.window = window
        self.threshold = threshold_mads
        self.min_samples = min_samples
        self._times = defaultdict(lambda: deque(maxlen=window))

    def record(self, host_id, step_time_s: float):
        self._times[host_id].append(step_time_s)

    def stragglers(self):
        """Hosts whose median step time is an outlier vs the fleet."""
        meds = {h: float(np.median(t)) for h, t in self._times.items()
                if len(t) >= self.min_samples}
        if len(meds) < 3:
            return []
        vals = np.array(list(meds.values()))
        med = np.median(vals)
        mad = np.median(np.abs(vals - med)) + 1e-9
        return [h for h, v in meds.items()
                if (v - med) / mad > self.threshold]

    def fleet_p50(self):
        vals = [t for dq in self._times.values() for t in dq]
        return float(np.median(vals)) if vals else float("nan")


def elastic_shardings(logical_axes_tree, rules):
    """Specs for restoring a checkpoint under a (possibly different) mesh:
    logical axis names are topology-independent, so growing or shrinking
    the mesh only changes the rules table."""
    from repro_torch.distributed.sharding import param_specs, use_rules
    with use_rules(rules):
        return param_specs(logical_axes_tree)
