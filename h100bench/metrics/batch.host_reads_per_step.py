"""Host reads of a batch's RMS vector per packed step, over the window:
the program's counters ``batch.host_reads`` over ``batch.steps``."""

from h100bench.spans import counter_ratio


def read(run):
    return counter_ratio(run, "batch.host_reads", "batch.steps")
