"""Seconds per mesh from ``run_mesh``'s entry to its ``search`` mark: the
grid and the exact-distance init (the program's stage timer, after a
device synchronise)."""

from h100bench.readers import mean, stage


def read(run):
    return mean(stage(r, None, "search") for r in run.records)
