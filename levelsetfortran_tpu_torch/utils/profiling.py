"""Profiling, tracing and throughput counters (port of
``levelsetfortran_tpu/utils/profiling.py``; the reference's performance
tooling is four ``cpu_time`` checkpoints, ``set3d.f90:52,271-273,314-316,
652-654``).

:func:`trace` records a ``torch.profiler`` Chrome trace (viewable in
Perfetto), with CUDA activity when a card is present.  Timed regions are
closed by a device synchronize, since a CUDA launch returns before the
device finishes.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Tuple

import torch

from .logging import log_event


@contextlib.contextmanager
def trace(logdir: str):
    """Record a ``torch.profiler`` trace of the block into
    ``logdir/trace_<pid>_<ns>.json``; yields the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    path = os.path.join(logdir,
                        f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    log_event("profiler", logdir=logdir, path=path)


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
