"""K9's share of its bound: each traced mesh's box points times its
centroids at 8 operations a pair (``roofline/k9.py``), over the device
time of the kernels launched inside the program's span
``lsf.init.reference.nearest`` in that job."""

from h100bench import jobs
from h100bench.readers import share
from h100bench.roofline import k9
from h100bench.spans import kernel_ms_per_job


def read(run):
    per_job = kernel_ms_per_job(run, k9.SPAN)
    if not per_job:
        return None
    soups, _ = jobs.soups(run.ctx)
    c = run.ctx.config
    sizes, bound, dev = {}, 0.0, 0.0
    for (rec, _), ms in zip(run.job_spans(), per_job):
        if ms is None:
            continue
        k = rec["pool"]
        if k not in sizes:
            sizes[k] = k9.sizes(soups[k], c["dx"], c["pad_cells"])
        bound += k9.bound_s(*sizes[k])
        dev += ms * 1e-3
    return share(bound, dev)
