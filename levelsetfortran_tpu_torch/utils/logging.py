"""Structured logging and stage timing (port of
``levelsetfortran_tpu/utils/logging.py``): one JSON record per event, and
the descendant of the reference's cpu_time checkpoints
(set3d.f90:52,271,314,652)."""

from __future__ import annotations

import json
import logging
import sys
import time

from .process import is_primary

logger = logging.getLogger("levelsetfortran_tpu_torch")


def log_event(stage: str, **fields) -> None:
    """One structured JSON record per event, from the primary process only
    (rank 0 under a process group), as in the JAX package."""
    if not is_primary():
        return
    logger.info(json.dumps({"stage": stage, "t": time.time(), **fields},
                           default=float))


def configure(level=logging.INFO, stream=sys.stderr) -> None:
    h = logging.StreamHandler(stream)
    h.setFormatter(logging.Formatter("%(message)s"))
    logger.addHandler(h)
    logger.setLevel(level)


class StageTimer:
    """Wall-clock seconds since construction at each named mark."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.marks = {}

    def mark(self, name: str) -> float:
        self.marks[name] = time.perf_counter() - self.t0
        log_event("timer", name=name, seconds=self.marks[name])
        return self.marks[name]
