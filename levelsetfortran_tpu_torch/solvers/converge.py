"""The solvers' one convergence loop (``subs.f90:717-931``,
``set3d.f90:394-462``): advance, read the step's sum of squared changes to
the host, emit the metrics event, stop at RMS < tol or NaN.  The dense,
banded and sharded solvers differ only in what their ``advance`` launches:
one step, a chunk of steps, or k steps between exchanges.
"""

from __future__ import annotations

import math

import numpy as np

from ..utils.metrics import emit_iteration
from ..utils.profiling import count


def rms_denominator(shape) -> int:
    """The reference's nx*ny*nz, i.e. points-1 per axis (subs.f90:914)."""
    return (shape[0] - 1) * (shape[1] - 1) * (shape[2] - 1)


def stops(rms, tol):
    """The stop rule (subs.f90:926, set3d.f90:458): ``rms`` a host float,
    or a numpy vector of them (a batch's geometries)."""
    return (rms < tol) | np.isnan(rms)


def step_rms(dsq, shape, owners=None) -> float:
    """The one host read of a check: the RMS of a step's float64 sum of
    squared changes, a 0-d tensor or a sharded solve's per-shard sums
    (:func:`~..parallel.distributed.shard_order_sum` over ``owners``)."""
    if isinstance(dsq, list):
        # imported here: the parallel package imports this module
        from ..parallel.distributed import shard_order_sum
        count("sharded.host_reads")
        total = shard_order_sum(dsq, owners)
    else:
        total = dsq.item()
    return math.sqrt(total / rms_denominator(shape))


def converge(advance, phi, iters: int, tol, *, stage: str, shape,
             metrics_every: int = 0, chunk: int = 1, owners=None) -> tuple:
    """``(phi, n, rms, diverged)`` after units of ``advance(phi, n) ->
    (phi, steps, dsq, band_tiles)`` while ``n < iters``, stopping early
    at :func:`stops`.  One host read and one possible ``stage`` event
    (``metrics_every`` rounded to whole ``chunk``s) per unit; the state
    ``phi`` is the caller's own, ``shape`` the (global) grid's."""
    every = chunk * max(1, metrics_every // chunk) if metrics_every else 0
    n, rms = 0, math.inf
    while n < iters:
        phi, steps, dsq, band_tiles = advance(phi, n)
        n += steps
        rms = step_rms(dsq, shape, owners)
        emit_iteration(stage, every, n, rms, band_tiles=band_tiles,
                       cells=math.prod(shape))
        if stops(rms, tol):
            break
    return phi, n, rms, math.isnan(rms)
