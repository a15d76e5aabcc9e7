"""Host reads of the global RMS per sharded solver step, over the window:
the program's counters ``sharded.host_reads`` over ``sharded.steps``."""

from h100bench.spans import counter_ratio


def read(run):
    return counter_ratio(run, "sharded.host_reads", "sharded.steps")
