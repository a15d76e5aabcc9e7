"""End-to-end differentiable pipeline: STL vertices -> pixels (port of
``levelsetfortran_tpu/pipeline/differentiable.py``, single device).

Exact signed-distance init (vertex-differentiable through each point's
nearest triangle), fixed-step reinitialization (kernels K1 forward, K5
backward), fixed-step min/max smoothing (K3 forward, K6 backward) and the
sphere-traced renderer (implicit-function backward): rendered pixels carry
gradients back to the mesh's vertex positions.  The grid is fixed, so the
gradients flow through the field values, not the grid's sizing.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..grid.grid import Grid3D
from ..ops.init_sign import signed_distance_init
from ..render.sphere_trace import camera_rays, render
from ..solvers.minmax_flow import minmax_flow_fixed
from ..solvers.reinit import reinit_fixed


class DifferentiableRender(NamedTuple):
    image: torch.Tensor
    depth: torch.Tensor
    phi: torch.Tensor


def render_from_vertices(vertices, elements, grid: Grid3D, *, eye, target,
                         reinit_steps: int = 20, minmax_steps: int = 10,
                         reinit_cfl: float = 0.1, minmax_cfl: float = 0.01,
                         height: int = 64, width: int = 64,
                         n_march_steps: int = 64, mesh=None,
                         culling=None) -> DifferentiableRender:
    """Render the smoothed level set of a triangle mesh; the pixels are
    differentiable with respect to ``vertices`` ((n, 3) tensor, on the
    device the whole chain runs on).

    ``culling``: as in :func:`..ops.init_sign.signed_distance_init` —
    ``None`` scans all point-triangle pairs (the JAX default under
    tracing), an :class:`..ops.init_sign.InitCulling` or ``"auto"`` scans
    per-block candidate lists."""
    if mesh is not None:
        raise NotImplementedError(
            "the sharded differentiable path (mesh=) is not ported yet: "
            "ROADMAP Queue 1 item 11b, the sharded differentiable solvers")
    dx = grid.dx
    phi = signed_distance_init(grid, vertices, elements,
                               dtype=vertices.dtype, device=vertices.device,
                               culling=culling)
    phi = reinit_fixed(phi, dx, reinit_cfl * dx, reinit_steps)
    if minmax_steps:
        phi = minmax_flow_fixed(phi, dx, minmax_cfl * dx * dx, minmax_steps)
    origins, dirs = camera_rays(height, width, eye=eye, target=target,
                                dtype=phi.dtype, device=phi.device)
    out = render(phi, grid, origins, dirs, n_steps=n_march_steps,
                 hit_tol=0.25 * dx)
    return DifferentiableRender(image=out.image, depth=out.depth, phi=phi)


def image_loss_and_vertex_grad(vertices, elements, grid: Grid3D,
                               target_image, **kw):
    """L2 pixel loss ``0.5 sum (image - target)^2`` against a target image
    and its gradient with respect to the vertex positions: ``(loss,
    grad)``, both detached."""
    v = vertices.detach().requires_grad_(True)
    out = render_from_vertices(v, elements, grid, **kw)
    loss = 0.5 * torch.sum((out.image - target_image) ** 2)
    grad, = torch.autograd.grad(loss, v)
    return loss.detach(), grad
