"""Device milliseconds per mesh of the kernels launched inside the
reference-mode init (the program's span ``lsf.init.reference``: the
nearest-centroid search, the sign and the field, by the launches'
correlation ids)."""

from h100bench.readers import mean
from h100bench.spans import kernel_ms_per_job


def read(run):
    return mean(kernel_ms_per_job(run, "lsf.init.reference"))
