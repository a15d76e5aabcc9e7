"""Seconds per mesh of the sharded init: from the start of its first
block (the program's span ``lsf.sharded.init.block``) to the end of the
last device operation launched inside any of its blocks, on any card
(tied to its launch on the span's thread by the correlation id, as
``sharded.exchange_ms`` ties them).  Where the blocks run on their cards
at once this is shorter than the blocks' device time summed."""

import bisect

from h100bench import spans
from h100bench.readers import mean

SPAN = "lsf.sharded.init.block"


def seconds_per_job(run, name: str) -> list:
    """Per traced job, the seconds from the first span called ``name`` to
    the end of the last device operation launched inside one of them;
    None for a job with no such span or operation."""
    if run.trace is None:
        return []
    t = run.trace
    inside = spans._by_thread(t, name, run.lo, run.hi)
    if not inside:
        return []
    end = {}
    for e in t.device:
        if e.corr > 0:
            end[e.corr] = max(end.get(e.corr, e.end), e.end)
    launch_ts = [e.ts for e in t.launches]
    starts = sorted(e.ts for e in t.spans.get(name, []))
    out = []
    for _, job in run.job_spans():
        i = bisect.bisect_left(starts, job.ts)
        ends = [end[e.corr] for e in t.launches[
                    bisect.bisect_left(launch_ts, job.ts):
                    bisect.bisect_right(launch_ts, job.end)]
                if e.corr in end and e.tid in inside
                and spans._inside(inside[e.tid], e.ts)]
        ok = ends and i < len(starts) and starts[i] <= job.end
        out.append((max(ends) - starts[i]) * 1e-6 if ok else None)
    return out


def read(run):
    return mean(seconds_per_job(run, SPAN))
