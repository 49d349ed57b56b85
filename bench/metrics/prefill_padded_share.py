"""Backend, chunked prefill (``PrefillScheduler``): the % of the prefill
dispatches' padded rows that carry a prompt token, over the window's ticks:
the program's counters ``prefill_tick_tokens`` summed over the growth of
``prefill_padded_tokens``; None where the program has no such counter or
ran no prefill dispatch."""


def read(run):
    c = [r.get("counters") or {} for r in run.ticks()]
    if len(c) < 2 or "prefill_padded_tokens" not in c[0]:
        return None
    tokens = sum(x.get("prefill_tick_tokens", 0) for x in c[1:])
    grew = c[-1]["prefill_padded_tokens"] - c[0]["prefill_padded_tokens"]
    return 100.0 * tokens / grew if grew else None
