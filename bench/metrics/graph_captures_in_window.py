"""Graph cache (``DispatchGraphs``): graphs captured inside the window
(the cache's entries at its close less at its opening); none where the
backend captures nothing."""


def read(run):
    return None if run.graphs is None else run.graphs[1] - run.graphs[0]
