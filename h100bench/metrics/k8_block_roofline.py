"""K8's block mode's share of its bound: each traced mesh's nodes times
its iterations and final sample, 124 operations each at the float32
peak, over the device time of the block mode's kernels in that mesh."""

from h100bench.readers import job_kernels, share
from h100bench.reference import pipeline
from h100bench.roofline import k8_block


def read(run):
    if run.trace is None:
        return None
    iters = pipeline.settings({
        k: v for k, v in run.ctx.config.get("levelset", {}).items()
        if k in pipeline.SETTINGS})["advect_iters"]
    bound, dev = 0.0, 0.0
    for rec, ks in job_kernels(run, k8_block.KERNELS):
        if not ks or "n_nodes" not in rec:
            continue
        bound += k8_block.bound_s(rec["n_nodes"], iters)
        dev += sum(e.dur for e in ks) * 1e-6
    return share(bound, dev)
