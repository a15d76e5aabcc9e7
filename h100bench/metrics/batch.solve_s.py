"""Seconds per batch in the packed reinit and min/max stages (``minmax`` -
``search`` of the batch's stage timer)."""

from h100bench.readers import mean, stage


def read(run):
    return mean(stage(r, "search", "minmax") for r in run.records)
