"""Readers of the program's own instrumentation in a traced window: its
spans (``lsf.<function>`` and ``lsf.<function>.<stage>``, recorded by
``torch.profiler`` on the trace's clock) and its counters
(``utils.profiling.counters()`` of the program, added to only while the
profiler records, so in the benchmark exactly the window's work).

Three views of a span: its seconds per job; the device time of the kernels
whose launch lies inside it on its own thread (a kernel is tied to its
launch by the correlation id); and the device's busy time inside it.
Each returns None where the span or counter is absent, as in a cell that
bypasses the layer or a program without the instrumentation.
"""

from __future__ import annotations

import bisect
import collections

from h100bench import trace as tr


def _by_thread(trace, name: str, lo: float, hi: float) -> dict:
    """The spans called ``name``, per thread: each thread's intervals
    merged and clipped to [lo, hi], as (starts, intervals), sorted."""
    by = collections.defaultdict(list)
    for e in trace.spans.get(name, []):
        by[e.tid].append(e)
    out = {}
    for tid, evs in by.items():
        iv = tr.merged(evs, lo, hi)
        out[tid] = ([a for a, _ in iv], iv)
    return out


def _inside(found, t: float) -> bool:
    """Whether ``t`` lies in one of the intervals of ``found`` (one entry
    of :func:`_by_thread`)."""
    starts, iv = found
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and t <= iv[i][1]


def _overlap(xs: list, ys: list) -> float:
    """The length of the intersection of two sorted disjoint interval
    lists."""
    out, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            out += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return out


def seconds_per_job(run, name: str) -> list:
    """Per traced job, the seconds covered by spans called ``name`` inside
    it (on any thread), None for a job with none."""
    if run.trace is None:
        return []
    spans = run.trace.spans.get(name, [])
    out = []
    for _, job in run.job_spans():
        iv = tr.merged(spans, job.ts, job.end)
        out.append(sum(b - a for a, b in iv) * 1e-6 if iv else None)
    return out


def kernel_ms_per_job(run, name: str) -> list:
    """Per traced job, the device milliseconds of the kernels launched from
    inside a span called ``name`` on the launching thread, None for a job
    that launched none there."""
    if run.trace is None:
        return []
    t = run.trace
    inside = _by_thread(t, name, run.lo, run.hi)
    if not inside:
        return []
    kernel_us = collections.Counter()
    for k in t.kernels:
        if k.corr > 0:
            kernel_us[k.corr] += k.dur
    launch_ts = [e.ts for e in t.launches]
    out = []
    for _, job in run.job_spans():
        us = [kernel_us[e.corr] for e in t.launches[
                  bisect.bisect_left(launch_ts, job.ts):
                  bisect.bisect_right(launch_ts, job.end)]
              if e.corr in kernel_us and e.tid in inside
              and _inside(inside[e.tid], e.ts)]
        out.append(sum(us) * 1e-3 if us else None)
    return out


def idle_share_in(run, name: str):
    """Per cent of the time inside spans called ``name`` (all threads, in
    the window) in which the device ran nothing; None without such spans,
    or where the window holds no device activity at all (a trace without
    the card's)."""
    if run.trace is None:
        return None
    spans = tr.merged(run.trace.spans.get(name, []), run.lo, run.hi)
    device = tr.merged(run.trace.device, run.lo, run.hi)
    total = sum(b - a for a, b in spans)
    if total <= 0.0 or not device:
        return None
    return 100.0 * (1.0 - _overlap(spans, device) / total)


def counter_ratio(run, num: str, den: str):
    """The program's counter ``num`` over its counter ``den`` in a traced
    run; None where either is absent or ``den`` is 0."""
    if run.trace is None:
        return None
    from levelsetfortran_tpu_torch.utils import profiling
    read = getattr(profiling, "counters", None)
    got = read() if read is not None else {}
    if num not in got or not got.get(den):
        return None
    return got[num] / got[den]
