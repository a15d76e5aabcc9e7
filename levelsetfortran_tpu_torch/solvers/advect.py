"""Surface-node advection onto the smoothed zero level set (port of
``levelsetfortran_tpu/solvers/advect.py``; reference ``set3d.f90:470-501``).

phi and grad phi are frozen during advection, so each node's trajectory
depends only on its own position: the reference's per-node sweep equals a
batched Jacobi iteration over all nodes.  A float32 field runs every
iteration in one launch of kernel K8 (``ops/advect_cuda.py``); bfloat16
and float64 run the plain loop on their own device, as the JAX package's
dtype routing sends them to its jnp path.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..grid.grid import Grid3D
from ..ops.band import narrow_band
from ..ops import advect_cuda
from ..ops.derivs import first_derivative
from ..ops.weno_cuda import kernel_supported


class AdvectResult(NamedTuple):
    positions: torch.Tensor     # (n_nodes, 3) advected coordinates
    phi_surf: torch.Tensor      # residual phi at the final positions


def banded_gradient(phi, dx, *, order: int = 8, stencil_radius: float = 8.1,
                    quirk_deriv8_y: bool = False):
    """Order-``order`` gradient, zeroed outside the stencil band
    (set3d.f90:470-479)."""
    grad, _ = first_derivative(phi, dx, order=order,
                               quirk_deriv8_y=quirk_deriv8_y)
    _, sb = narrow_band(phi, dx, stencil_radius, stencil_radius)
    return torch.where(sb[..., None], grad, torch.zeros_like(grad))


def advect_nodes(phi, grid: Grid3D, positions, dx, iters: int = 1000, *,
                 eps: float = 1e-13, order: int = 8,
                 stencil_radius: float = 8.1,
                 quirk_deriv8_y: bool = False) -> AdvectResult:
    """Move nodes onto the zero level set; only nodes with
    ``phi_surf > eps`` move (set3d.f90:493)."""
    grad = banded_gradient(phi, dx, order=order,
                           stencil_radius=stencil_radius,
                           quirk_deriv8_y=quirk_deriv8_y)
    step = (advect_cuda.advect if kernel_supported(phi.shape, phi.dtype)
            else advect_cuda.advect_plain)
    x, p_final = step(phi, grad, grid, positions, iters, eps)
    return AdvectResult(positions=x, phi_surf=p_final)
