"""Narrow-band masks (port of ``levelsetfortran_tpu/ops/band.py``;
reference ``subs.f90:178-207``)."""

from __future__ import annotations

import torch


def narrow_band(phi: torch.Tensor, dx, band_radius: float = 4.1,
                stencil_radius: float = 8.1):
    """Return (active_band, stencil_band) boolean masks (subs.f90:194,199)."""
    a = torch.abs(phi)
    return a < band_radius * dx, a < stencil_radius * dx
