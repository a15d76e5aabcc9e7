"""K5's share of its bound: each call's grid cells times 1600 operations at
the float32 peak, over the device time of its kernels (and the sums'
reduction launched right after them), summed over the traced gradients."""

import math

from h100bench.readers import share
from h100bench.roofline import k5


def read(run):
    if run.trace is None:
        return None
    bound, dev = 0.0, 0.0
    for rec, sp in run.job_spans():
        ks = run.trace.kernels_in(sp.ts, sp.end)
        calls, t, prev = 0, 0.0, False
        for e in ks:
            mine = any(n in e.name for n in k5.KERNELS)
            if mine or (prev and "reduce_partials" in e.name):
                t += e.dur
                calls += k5.FIRST in e.name
            prev = mine or (prev and "reduce_partials" in e.name)
        if calls:
            bound += k5.bound_s(calls, math.prod(rec["shape"]))
            dev += t * 1e-6
    return share(bound, dev)
