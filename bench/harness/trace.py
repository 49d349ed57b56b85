"""A steady slice of the traced window under ``torch.profiler``.

The slice opens and closes between engine ticks, when the device has
finished every dispatch of the tick (each dispatch's scalars are fetched to
the host before the tick ends), so it holds whole ticks; it is short (a
few thousand kernels a tick, each a profiler record, inside the graphs'
replays too).  While it is open the harness's spans are also
``record_function`` ranges (``bench.<span>``), on the profiler's own clock,
which name the device's idle gaps.  The profiler slows the host, so the
slice's idle share reads high against an unprofiled tick.
"""

from __future__ import annotations

import torch


def warm_profiler(step):
    """One short profile around ``step()`` during set-up, so the profiler's
    first start (CUPTI's initialisation, seconds) does not stall the
    window."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        step()
        torch.cuda.synchronize()


class Slice:
    def __init__(self):
        self.prof = None
        self.t0 = self.t1 = None

    @property
    def open(self) -> bool:
        return self.prof is not None and self.t1 is None

    def start(self, clock):
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self.ticks = 0
        self.t0 = clock.now()

    def stop(self, clock):
        torch.cuda.synchronize()
        self.t1 = clock.now()
        self.prof.__exit__(None, None, None)

    def analyse(self, kernel_prefixes=()) -> dict:
        """busy and window seconds, device time by operation name, the
        longest idle gaps named by the harness span open when each began,
        and the device seconds of operations whose names hold any of
        ``kernel_prefixes``."""
        cuda = torch.autograd.DeviceType.CUDA
        dev, spans = [], []
        for ev in self.prof.events():
            s, e = ev.time_range.start * 1000, ev.time_range.end * 1000
            if ev.name.startswith("bench."):
                if ev.device_type != cuda:
                    spans.append((s, e, ev.name[len("bench."):]))
            elif ev.device_type == cuda and not getattr(
                    ev, "is_user_annotation", False):
                dev.append((s, e, ev.name))
        dev.sort()
        by_name: dict = {}
        for s, e, n in dev:
            by_name[n] = by_name.get(n, 0) + (e - s)
        busy, gaps = 0, []
        cur_s = cur_e = None
        for s, e, _ in dev:
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                    gaps.append((cur_e, s))
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
        spans.sort(key=lambda x: x[1] - x[0])      # innermost first

        def host_at(t):
            for s, e, n in spans:
                if s <= t < e:
                    return n
            return "loop"

        longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
        named = [(host_at(a), (b - a) / 1e9) for a, b in longest]
        top = sorted(by_name.items(), key=lambda x: -x[1])
        kern = sum(v for n, v in by_name.items()
                   if any(k in n for k in kernel_prefixes))
        return {"busy_s": busy / 1e9, "window_s": self.t1 - self.t0,
                "t0": self.t0, "t1": self.t1,
                "device_ops": [[n[:160], v / 1e9] for n, v in top[:10]],
                "idle_gaps": [[n, v] for n, v in named[:10]],
                "kernel_s": kern / 1e9, "n_device_ops": len(dev),
                "ticks": self.ticks}
