"""The numbers that decide ``correct``: the program's outputs against the
plain reference's, each reduced to one number that a limit bounds."""

from __future__ import annotations

import math

import numpy as np


def field_gap(got, want, dx: float) -> float:
    """Largest |difference| of two fields over the grid, in units of dx;
    inf where their shapes differ."""
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        return math.inf
    return float(np.max(np.abs(got - want))) / dx


def nodes_gap(got, want, dx: float) -> float:
    """Largest distance between a node's two positions, in units of dx."""
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        return math.inf
    return float(np.max(np.linalg.norm(got - want, axis=1))) / dx


def worst(readings) -> dict:
    """Each number's largest reading over several compared jobs (NaN
    counts as the largest)."""
    out = {}
    for r in readings:
        for k, v in r.items():
            v = math.inf if v != v else float(v)
            out[k] = max(out.get(k, -math.inf), v)
    return out
