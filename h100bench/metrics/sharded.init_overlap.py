"""The share of the sharded init's blocks that were enqueued while an
earlier block's work on another card was still running, over the window:
the program's counters ``sharded.init_overlapped`` over
``sharded.init_blocks``."""

from h100bench.spans import counter_ratio


def read(run):
    return counter_ratio(run, "sharded.init_overlapped",
                         "sharded.init_blocks")
