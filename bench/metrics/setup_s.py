"""Seconds from the process's start to the window's opening: imports,
weights, the pool, kernel builds and graph captures (warm-up), and the
pre-roll of the cell's own traffic."""


def read(run):
    return run.setup_s
