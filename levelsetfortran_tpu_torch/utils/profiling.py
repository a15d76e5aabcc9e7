"""Profiling, tracing and throughput counters (port of
``levelsetfortran_tpu/utils/profiling.py``; the reference's performance
tooling is four ``cpu_time`` checkpoints, ``set3d.f90:52,271-273,314-316,
652-654``).

:func:`trace` records a ``torch.profiler`` Chrome trace (viewable in
Perfetto), with CUDA activity when a card is present::

    with profiling.trace("traces"):
        lsf.run("mesh.stl")

While a ``torch.profiler`` session records, the program marks its layers
with :func:`span` (``lsf.<function>`` for the public function doing the
work, ``lsf.<function>.<stage>`` for a stage of it, around stages and
solver loops, never single steps) and counts work with :func:`count`.
The spans land in the trace on the profiler's clock, beside the kernels,
copies and runtime launches of the card; the counters are host numbers
already at hand, never a device read.  With no session recording, both
cost one flag check.

Timed regions are closed by a device synchronize, since a CUDA launch
returns before the device finishes.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler

from .logging import log_event

#: What :func:`span` returns while no profiler session records.
_NO_SPAN = contextlib.nullcontext()
#: The counters of :func:`count`, process-wide.
_counters: dict = {}


def recording() -> bool:
    """Whether a profiler session records: the profiler's own Python flag,
    ``torch.autograd.profiler._is_profiler_enabled``, which
    ``torch.profiler.profile`` and ``torch.autograd.profiler.profile`` set
    while they record (a read of a module attribute)."""
    return _autograd_profiler._is_profiler_enabled


def span(name: str):
    """A context manager marking a layer of the program in the trace: a
    ``torch.profiler.record_function(name)`` while a profiler session
    records (:func:`recording`), else one shared null context (a
    ``record_function`` made unconditionally costs some microseconds)."""
    if recording():
        return torch.profiler.record_function(name)
    return _NO_SPAN


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while a profiler session records
    (:func:`recording`); else nothing.  Called from the thread that drives
    the pipeline, with numbers already on the host."""
    if recording():
        _counters[name] = _counters.get(name, 0) + n


def counters() -> dict:
    """A copy of the counters: what :func:`count` added since the process
    started or since the last :func:`trace` began."""
    return dict(_counters)


@contextlib.contextmanager
def trace(logdir: str):
    """Record a ``torch.profiler`` trace of the block into
    ``logdir/trace_<pid>_<ns>.json``; yields the profiler.  The counters
    start from zero and are logged once at the end (a ``"counters"``
    event)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    _counters.clear()
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    path = os.path.join(logdir,
                        f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    log_event("profiler", logdir=logdir, path=path)
    log_event("counters", logdir=logdir, counters=counters())


def _synchronize(x: torch.Tensor) -> None:
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)


def fetch_scalar(x: torch.Tensor) -> float:
    """Finish everything ``x`` depends on and return the sum of its
    values."""
    s = torch.sum(x)
    _synchronize(s)
    return float(s)


def time_to_completion(fn: Callable, *args) -> Tuple[float, float]:
    """(seconds, scalar) for one completed execution of ``fn(*args)``;
    call once before timing (the first call builds the kernels)."""
    t0 = time.perf_counter()
    s = fetch_scalar(fn(*args))
    return time.perf_counter() - t0, s


def measure_cell_updates_per_sec(step_scan: Callable[[int], Callable],
                                 phi0, *, warmup_steps: int = 5,
                                 bench_steps: int = 40) -> dict:
    """Cell updates per second of a grid-stepping solver.

    ``step_scan(n)`` returns a callable that runs n steps on phi.  Fixed
    overhead (launch, first-touch) cancels in the difference of two step
    counts: the protocol of ``bench.py:59-64``.
    """
    cells = 1
    for d in phi0.shape:
        cells *= d
    small, big = step_scan(warmup_steps), step_scan(bench_steps)
    fetch_scalar(small(phi0))          # kernel build + first touch
    fetch_scalar(big(phi0))
    _synchronize(phi0)
    t0 = time.perf_counter()
    fetch_scalar(small(phi0))
    t1 = time.perf_counter()
    fetch_scalar(big(phi0))
    t2 = time.perf_counter()
    per_step = max(((t2 - t1) - (t1 - t0)) / (bench_steps - warmup_steps),
                   1e-9)
    out = {"cell_updates_per_sec": cells / per_step,
           "seconds_per_step": per_step, "cells": cells}
    log_event("throughput", **out)
    return out
