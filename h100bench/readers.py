"""Helpers of the metric readers (``metrics/<name>.py``): means over the
window's job records, and sums over the kernels of each traced job."""

from __future__ import annotations

import statistics


def mean(values):
    """Mean of the values that are not None; None when there are none."""
    vals = [v for v in values if v is not None]
    return statistics.fmean(vals) if vals else None


def stage(rec, a: str, b: str):
    """Seconds between two of a record's stage marks (``a`` None: from the
    start), or None when a mark is missing."""
    t = rec.get("timers", {})
    if b not in t or (a is not None and a not in t):
        return None
    return t[b] - (t[a] if a is not None else 0.0)


def idle_share(run):
    """Per cent of the traced window in which the device ran nothing."""
    if run.trace is None or run.hi <= run.lo:
        return None
    from h100bench import trace
    busy = trace.busy_s(run.trace, run.lo, run.hi)
    if busy <= 0.0:
        return None
    return 100.0 * (1.0 - busy / ((run.hi - run.lo) * 1e-6))


def job_kernels(run, names):
    """(record, kernels whose name holds one of ``names``) per traced
    job."""
    return [(rec, run.trace.kernels_in(sp.ts, sp.end, *names))
            for rec, sp in run.job_spans()]


def share(bound_s: float, device_s: float):
    """A roofline share in per cent, None when nothing ran."""
    if device_s <= 0.0 or bound_s <= 0.0:
        return None
    return 100.0 * bound_s / device_s
