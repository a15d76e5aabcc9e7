"""Min/max mean-curvature-flow RHS (port of
``levelsetfortran_tpu/ops/minmax.py``; reference ``subs.f90:413-483``):

    F = min(curv, 0) where avg < thresh else max(curv, 0)

with the Laplacian curvature proxy (the reference's true mean-curvature
branch is commented out, ``subs.f90:426-448``, and is not ported) and the
7-point neighborhood average.  The solvers run the fused form in
:mod:`.minmax_cuda`.
"""

from __future__ import annotations

import torch

from .derivs import second_derivative
from .stencil import shift


def seven_point_average(phi, h: int = 1):
    """Average of the cell and its 6 face neighbors at offset ``h``."""
    total = phi
    for axis in range(3):
        total = total + shift(phi, axis, h) + shift(phi, axis, -h)
    return total / 7.0


def minmax_rhs(phi, dx, *, threshold: float = 0.0, avg_halfwidth: int = 1):
    """Flow speed F for the min/max smoothing step (subs.f90:453-481)."""
    pure, _ = second_derivative(phi, dx)
    curv = pure.sum(dim=-1)
    pave = seven_point_average(phi, avg_halfwidth)
    return torch.where(pave < threshold, torch.clamp_max(curv, 0.0),
                       torch.clamp_min(curv, 0.0))

