"""Seconds per mesh in the three solver stages: ``minmax`` - ``search``
(the initial reinit and the min/max flow) plus ``total`` - ``advect``
(the final reinit), from the program's stage timer."""

from h100bench.readers import mean, stage


def read(run):
    def one(r):
        a, b = stage(r, "search", "minmax"), stage(r, "advect", "total")
        return None if a is None or b is None else a + b
    return mean(one(r) for r in run.records)
