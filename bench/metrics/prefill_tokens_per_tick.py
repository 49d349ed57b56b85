"""Backend, chunked prefill (``PrefillScheduler``): prompt tokens a tick
over the window's ticks that carried prefill (the backend's
``last_prefill_plan`` after each call)."""


def read(run):
    n = [sum(k for _, k in c.prefill) for c in run.calls() if c.prefill]
    return sum(n) / len(n) if n else None
