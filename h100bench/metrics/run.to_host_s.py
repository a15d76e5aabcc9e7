"""Seconds per mesh in which ``run_mesh`` copies its three fields and the
advected nodes to the host (the program's span
``lsf.run_mesh.to_host``)."""

from h100bench.readers import mean
from h100bench.spans import seconds_per_job


def read(run):
    return mean(seconds_per_job(run, "lsf.run_mesh.to_host"))
