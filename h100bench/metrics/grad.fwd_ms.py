"""Device milliseconds per gradient of the kernels launched inside the
forward (the program's span ``lsf.render_from_vertices``, by the
launches' correlation ids on its thread)."""

from h100bench.readers import mean
from h100bench.spans import kernel_ms_per_job


def read(run):
    return mean(kernel_ms_per_job(run, "lsf.render_from_vertices"))
