"""End-to-end differentiable pipeline: STL vertices -> pixels (port of
``levelsetfortran_tpu/pipeline/differentiable.py``).

Exact signed-distance init (vertex-differentiable through each point's
nearest triangle), fixed-step reinitialization (kernels K1 forward, K5
backward), fixed-step min/max smoothing (K3 forward, K6 backward) and the
sphere-traced renderer (implicit-function backward): rendered pixels carry
gradients back to the mesh's vertex positions.  The grid is fixed, so the
gradients flow through the field values, not the grid's sizing.  With a
shard ``mesh`` the init and both solvers run per block (the block modes of
the kernels), and the vertex cotangents of every shard add up on the
vertices.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..grid.grid import Grid3D
from ..ops.init_sign import (signed_distance_init,
                              signed_distance_init_sharded)
from ..parallel.mesh import gather_everywhere
from ..parallel.sharded import minmax_fixed_sharded, reinit_fixed_sharded
from ..render.sphere_trace import camera_rays, render
from ..solvers.minmax_flow import minmax_flow_fixed
from ..solvers.reinit import reinit_fixed
from ..utils.profiling import span


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
    per-block candidate lists.

    ``mesh`` (a :class:`..parallel.mesh.ShardMesh`): the init runs per
    block on each shard's device (``culling`` ``"auto"`` or None), then
    :func:`..parallel.sharded.reinit_fixed_sharded` and
    :func:`..parallel.sharded.minmax_fixed_sharded`; the blocks are
    gathered onto the vertices' device for the renderer.  Under a process
    group (a mesh across processes) every rank passes the same vertices,
    steps its own blocks, and renders the same image from the field
    gathered on every rank; the vertex cotangents of every shard are added
    in shard order, so every rank gets the same gradient."""
    with span("lsf.render_from_vertices"):
        dx = grid.dx
        if mesh is not None:
            blocks = signed_distance_init_sharded(
                grid, vertices, elements, mesh, dtype=vertices.dtype,
                culling=culling)
            blocks = reinit_fixed_sharded(mesh, blocks, dx, reinit_cfl * dx,
                                          reinit_steps)
            if minmax_steps:
                blocks = minmax_fixed_sharded(
                    mesh, blocks, dx, minmax_cfl * dx * dx, minmax_steps)
            phi = gather_everywhere(mesh, blocks, vertices.device)
        else:
            phi = signed_distance_init(grid, vertices, elements,
                                       dtype=vertices.dtype,
                                       device=vertices.device,
                                       culling=culling)
            phi = reinit_fixed(phi, dx, reinit_cfl * dx, reinit_steps)
            if minmax_steps:
                phi = minmax_flow_fixed(phi, dx, minmax_cfl * dx * dx,
                                        minmax_steps)
        origins, dirs = camera_rays(height, width, eye=eye, target=target,
                                    dtype=phi.dtype, device=phi.device)
        out = render(phi, grid, origins, dirs, n_steps=n_march_steps,
                     hit_tol=0.25 * dx)
    return DifferentiableRender(image=out.image, depth=out.depth, phi=phi)


def image_loss_and_vertex_grad(vertices, elements, grid: Grid3D,
                               target_image, **kw):
    """L2 pixel loss ``0.5 sum (image - target)^2`` against a target image
    and its gradient with respect to the vertex positions: ``(loss,
    grad)``, both detached.  ``kw``: those of :func:`render_from_vertices`,
    ``mesh`` included."""
    v = vertices.detach().requires_grad_(True)
    out = render_from_vertices(v, elements, grid, **kw)
    loss = 0.5 * torch.sum((out.image - target_image) ** 2)
    with span("lsf.vertex_grad"):
        grad, = torch.autograd.grad(loss, v)
    return loss.detach(), grad
