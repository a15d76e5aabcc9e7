"""K7's share of its bound: the pairs of each traced mesh's culling times
70 operations at the float32 peak, over K7's device time in that job."""

from h100bench import jobs
from h100bench.readers import job_kernels, share
from h100bench.roofline import k7


def read(run):
    if run.trace is None:
        return None
    soups, _ = jobs.soups(run.ctx)
    c = run.ctx.config
    pairs, bound, dev = {}, 0.0, 0.0
    for rec, ks in job_kernels(run, k7.KERNELS):
        if not ks:
            continue
        k = rec["pool"]
        if k not in pairs:
            pairs[k] = k7.pairs(soups[k], c["dx"], c["pad_cells"])
        bound += k7.bound_s(pairs[k])
        dev += sum(e.dur for e in ks) * 1e-6
    return share(bound, dev)
