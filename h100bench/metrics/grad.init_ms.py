"""Device milliseconds per gradient of the kernels launched inside the
forward's exact-distance init (the program's span ``lsf.init``: K7 and
the exact re-evaluation, by the launches' correlation ids)."""

from h100bench.readers import mean
from h100bench.spans import kernel_ms_per_job


def read(run):
    return mean(kernel_ms_per_job(run, "lsf.init"))
