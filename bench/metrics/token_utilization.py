"""Scheduler (``ElasticScheduler``, the TU model): tokens committed over
window positions computed, in the window's decode dispatches, in %."""


def read(run):
    calls = run.calls()
    computed = sum(c.computed for c in calls)
    return 100.0 * sum(c.commits for c in calls) / computed if computed \
        else None
