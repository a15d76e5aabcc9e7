"""Device milliseconds per mesh of the halo exchanges: every device
operation (copies between cards, fills, kernels) whose launch lies inside
the program's span ``lsf.halo_exchange`` on its thread, tied to it by the
correlation id."""

import bisect
import collections

from h100bench import spans
from h100bench.readers import mean


def device_ms_per_job(run, name: str) -> list:
    """Per traced job, the device milliseconds of the operations launched
    from inside a span called ``name``, None for a job that launched none
    there."""
    if run.trace is None:
        return []
    t = run.trace
    inside = spans._by_thread(t, name, run.lo, run.hi)
    if not inside:
        return []
    device_us = collections.Counter()
    for e in t.device:
        if e.corr > 0:
            device_us[e.corr] += e.dur
    launch_ts = [e.ts for e in t.launches]
    out = []
    for _, job in run.job_spans():
        us = [device_us[e.corr] for e in t.launches[
                  bisect.bisect_left(launch_ts, job.ts):
                  bisect.bisect_right(launch_ts, job.end)]
              if e.corr in device_us and e.tid in inside
              and spans._inside(inside[e.tid], e.ts)]
        out.append(sum(us) * 1e-3 if us else None)
    return out


def read(run):
    return mean(device_ms_per_job(run, "lsf.halo_exchange"))
