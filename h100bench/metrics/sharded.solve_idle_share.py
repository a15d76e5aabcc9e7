"""Per cent of the time in the sharded solver loops (the program's span
``lsf.sharded.solve``: the initial reinit, the min/max flow and the final
reinit) in which no card ran anything."""

from h100bench.spans import idle_share_in


def read(run):
    return idle_share_in(run, "lsf.sharded.solve")
