"""Kernels (``csrc/chunked_paged_attn.cu`` and its merge): the least time
the chip could take for the paged-attention calls of the profiled slice
(``costs.paged_attn_cost`` on each dispatch's context lengths and live
queries, one call a layer, the larger of its compute and memory bounds)
over the device time of the kernels by name, in %."""

from harness import costs


def read(run):
    t, s = run.trace, run.shape
    if t is None or t["kernel_s"] <= 0:
        return None
    least = 0.0
    for c in run.rec.calls:
        if not (t["t0"] <= c.t0 and c.t1 <= t["t1"]):
            continue
        for rows in (c.rows, [(off, n) for off, n in c.prefill]):
            if rows:
                f, b = costs.paged_attn_cost(rows, s["n_heads"],
                                             s["n_kv_heads"], s["head_dim"],
                                             s["page_size"], s["itemsize"])
                least += costs.roofline_seconds(f, b)[0]
    return 100.0 * least * s["n_attn_layers"] / t["kernel_s"] or None
