"""A steady slice of the traced window under ``torch.profiler``.

The slice opens and closes between engine ticks, when the device has
finished every dispatch of the tick (each dispatch's scalars are fetched to
the host before the tick ends), so it holds whole ticks; it is short (a
few thousand kernels a tick, each a profiler record, inside the graphs'
replays too).  While it is open the harness's spans are also
``record_function`` ranges (``bench.<span>``), and so, in a traced run, are
the program's own spans (``engine.*``, ``prefill.*``, ``decode.*``, ``kv.*``,
``slot.*``, ``graph.*``: its tracer opens one under each span while a
profiler records), on the profiler's own clock; each idle gap of the
device is named by the innermost of them open when it began.  The profiler
slows the host, so the slice's idle share reads high against an
unprofiled tick.
"""

from __future__ import annotations

import torch

# the program's host ranges: the engine's, then the model step's and the
# graph cache's
STEP_LAYERS = ("prefill.", "decode.", "kv.", "slot.", "graph.")
PROGRAM_LAYERS = ("engine.",) + STEP_LAYERS


def range_name(name: str):
    """A host range's name: the harness's without its ``bench.`` prefix,
    the program's as it is; None for any other event."""
    if name.startswith("bench."):
        return name[len("bench."):]
    return name if name.startswith(PROGRAM_LAYERS) else None


def name_gaps(ranges: list, gaps: list) -> list:
    """The innermost of ``ranges`` ``(start, end, name)`` open at each
    gap's start (``gaps`` ``(start, end)``), or ``loop`` where none is;
    one name a gap, in the gaps' order."""
    order = sorted(range(len(gaps)), key=lambda i: gaps[i][0])
    rs = sorted(ranges)
    out, open_, j = [None] * len(gaps), [], 0
    for i in order:
        t = gaps[i][0]
        while j < len(rs) and rs[j][0] <= t:
            open_.append(rs[j])
            j += 1
        open_ = [r for r in open_ if r[1] > t]
        inner = min(open_, key=lambda r: r[1] - r[0], default=None)
        out[i] = inner[2] if inner is not None else "loop"
    return out


def idle_gaps(ranges: list, device: list, longest: int = 10) -> dict:
    """The device's busy time and idle gaps between ``device`` operations
    ``(start, end)`` (times in any one unit, read as ns), each gap named by
    :func:`name_gaps`: ``busy_s``, the ``longest`` gaps as ``[name,
    seconds]`` and the idle seconds by name (``idle_by_span``)."""
    busy, gaps = 0, []
    cur_s = cur_e = None
    for s, e in sorted(device):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    names = name_gaps(ranges, gaps)
    by: dict = {}
    for (a, b), n in zip(gaps, names):
        by[n] = by.get(n, 0.0) + (b - a) / 1e9
    top = sorted(range(len(gaps)), key=lambda i: gaps[i][0] - gaps[i][1])
    return {"busy_s": busy / 1e9,
            "idle_gaps": [[names[i], (gaps[i][1] - gaps[i][0]) / 1e9]
                          for i in top[:longest]],
            "idle_by_span": dict(sorted(by.items(), key=lambda x: -x[1]))}


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
        """busy and window seconds, device time by operation name (the
        whole table, ``by_name``, and its ten largest, ``device_ops``), the
        longest idle gaps and the idle seconds by the innermost host range
        open when each gap began (:func:`idle_gaps`), and the device
        seconds of operations whose names hold any of
        ``kernel_prefixes``."""
        cuda = torch.autograd.DeviceType.CUDA
        dev, ranges = [], []
        for ev in self.prof.events():
            s, e = ev.time_range.start * 1000, ev.time_range.end * 1000
            name = range_name(ev.name)
            if ev.device_type == cuda:
                if name is None and not getattr(ev, "is_user_annotation",
                                                False):
                    dev.append((s, e, ev.name))
            elif name is not None:
                ranges.append((s, e, name))
        by_name: dict = {}
        for s, e, n in sorted(dev):
            by_name[n] = by_name.get(n, 0) + (e - s)
        gaps = idle_gaps(ranges, [(s, e) for s, e, _ in dev])
        top = sorted(by_name.items(), key=lambda x: -x[1])
        kern = sum(v for n, v in by_name.items()
                   if any(k in n for k in kernel_prefixes))
        return {"window_s": self.t1 - self.t0, "t0": self.t0, "t1": self.t1,
                "device_ops": [[n[:160], v / 1e9] for n, v in top[:10]],
                "by_name": {n: v / 1e9 for n, v in top}, **gaps,
                "kernel_s": kern / 1e9, "n_device_ops": len(dev),
                "ticks": self.ticks}
