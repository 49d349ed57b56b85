"""Backend, recurrent-slot admission (``ModelBackend.admit`` →
``TransformerLM.prefill_slot``, the WKV scan): the mean host-clock time of
the window's admissions, each ending on its logits' fetch."""

from harness import stats


def read(run):
    v = stats.spans_in(run.rec.spans, "admit", run.w0, run.w1)
    return 1e3 * sum(v) / len(v) if v else None
