"""Seconds per mesh in the sharded advection (the program's span
``lsf.sharded.advect``, closed once the mesh's cards are synchronised)."""

from h100bench.readers import mean
from h100bench.spans import seconds_per_job


def read(run):
    return mean(seconds_per_job(run, "lsf.sharded.advect"))
