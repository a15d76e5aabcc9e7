"""Min/max mean-curvature-flow RHS (port of
``levelsetfortran_tpu/ops/minmax.py``; reference ``subs.f90:413-483``):

    F = min(curv, 0) where avg < thresh else max(curv, 0)

with the Laplacian curvature proxy, or with ``use_true_curvature`` the true
mean curvature (:func:`mean_curvature`, the reference's commented-out branch
``subs.f90:426-448``), and the 7-point neighborhood average.  The solvers
run the default form fused in :mod:`.minmax_cuda`; the other options have
no kernel (in the JAX package neither) and run these tensor ops.
"""

from __future__ import annotations

import torch

from .derivs import first_derivative, second_derivative
from .stencil import shift


def seven_point_average(phi, h: int = 1):
    """Average of the cell and its 6 face neighbors at offset ``h``."""
    total = phi
    for axis in range(3):
        total = total + shift(phi, axis, h) + shift(phi, axis, -h)
    return total / 7.0


def minmax_rhs(phi, dx, *, threshold: float = 0.0, avg_halfwidth: int = 1,
               use_true_curvature: bool = False):
    """Flow speed F for the min/max smoothing step (subs.f90:453-481)."""
    if use_true_curvature:
        curv = mean_curvature(phi, dx)
    else:
        pure, _ = second_derivative(phi, dx)
        curv = pure.sum(dim=-1)                       # Laplacian proxy
    pave = seven_point_average(phi, avg_halfwidth)
    return torch.where(pave < threshold, torch.clamp_max(curv, 0.0),
                       torch.clamp_min(curv, 0.0))



def mean_curvature(phi, dx, eps: float = 1e-13):
    """True mean curvature div(grad phi / |grad phi|), 0 where |grad phi|^3
    is below ``eps`` (``ops/minmax.py:46-58`` of the JAX package)."""
    grad, mag = first_derivative(phi, dx, order=2)
    pure, mixed = second_derivative(phi, dx)
    gx, gy, gz = grad[..., 0], grad[..., 1], grad[..., 2]
    pxx, pyy, pzz = pure[..., 0], pure[..., 1], pure[..., 2]
    pxy, pxz, pyz = mixed[..., 0], mixed[..., 1], mixed[..., 2]
    num = ((pyy + pzz) * gx * gx + (pxx + pzz) * gy * gy
           + (pxx + pyy) * gz * gz
           - 2.0 * (gx * gy * pxy + gx * gz * pxz + gy * gz * pyz))
    denom = mag ** 3
    return torch.where(denom < eps, torch.zeros_like(num),
                       num / torch.clamp_min(denom, eps))
