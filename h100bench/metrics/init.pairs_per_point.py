"""(point, candidate) pairs that the init's selection scan evaluates per
grid point, over the window: the program's counters ``init.pairs`` over
``init.points``.  The work the culling leaves for K7."""

from h100bench.spans import counter_ratio


def read(run):
    return counter_ratio(run, "init.pairs", "init.points")
