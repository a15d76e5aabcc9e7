"""Per-iteration metrics stream from the solver loops (port of
``levelsetfortran_tpu/utils/metrics.py``).

The reference prints an ``Iteration / RMS Error`` line every pseudo-time
step of both hot loops (``subs.f90:923``, ``set3d.f90:456``); this is its
structured form: ``{stage_name, iteration, rms, t, band_tiles,
cells_per_s}`` events in a ring buffer, mirrored to the structured log as
``{"stage": "iteration", ...}`` lines.

The JAX package taps the events out of fused ``lax.while_loop`` bodies
with ``jax.debug.callback``.  The port's solver loops are Python loops that
already read the RMS to the host once per check, so :func:`emit_iteration`
is a plain host call made right after that read.  With ``every == 0`` (the
default) it returns at once: no device work, no extra host sync.

Departure: ``band_tiles`` counts the active 8^3 bricks of the port's
narrow band (read on an emitting step only), where the JAX package counts
its TPU tiles; the two counts are not comparable.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Optional

import torch

from .process import is_primary


class MetricsStream:
    """Host-side sink for in-loop iteration events."""

    def __init__(self, max_events: int = 4096, log: bool = True):
        self.events = collections.deque(maxlen=max_events)
        self.log = log
        self._lock = threading.Lock()
        self._last: dict = {}          # stage -> (iter, wall time)

    def record(self, stage: str, n: int, rms: float, band_tiles: int,
               cells: int) -> None:
        now = time.perf_counter()
        cells_per_s = None
        with self._lock:
            last = self._last.get(stage)
            if last is not None and n > last[0] and now > last[1]:
                cells_per_s = (n - last[0]) * cells / (now - last[1])
            self._last[stage] = (n, now)
            ev = {"stage_name": stage, "iteration": n, "rms": rms,
                  "t": now}
            if band_tiles >= 0:
                ev["band_tiles"] = band_tiles
            if cells_per_s is not None:
                ev["cells_per_s"] = cells_per_s
            self.events.append(ev)
        if self.log:
            from .logging import log_event
            log_event("iteration", **ev)

    def clear(self) -> None:
        with self._lock:
            self.events.clear()
            self._last.clear()


_stream = MetricsStream()


def get_stream() -> MetricsStream:
    return _stream


def set_stream(stream: MetricsStream) -> MetricsStream:
    global _stream
    _stream = stream
    return stream


def emit_iteration(stage: str, every: int, n: int, rms: float,
                   band_tiles=None, cells: Optional[int] = None) -> None:
    """Record one {iteration, rms, band_tiles} event when ``every`` divides
    the iteration count ``n``.

    ``every == 0`` disables it.  ``rms`` is the host float the loop has
    just read.  Only the primary process emits (SURVEY §5), as in the JAX
    package.  ``band_tiles``: a brick activity mask, or a list of them (one
    per shard; across processes this rank's, None for the others'),
    counted only when the event fires.  ``cells``: the
    grid's cell count, for the host-side cells/s.
    """
    if not every or n % every or not is_primary():
        return
    bt = -1
    if band_tiles is not None:
        masks = band_tiles if isinstance(band_tiles, (list, tuple)) \
            else [band_tiles]
        bt = sum(int(torch.count_nonzero(m)) for m in masks
                 if m is not None)
    _stream.record(stage, int(n), float(rms), bt, int(cells or 0))
