"""The sharded cell's pipeline in plain PyTorch, on the whole grid: one
mesh through init, reinitialization, min/max flow, advection and the final
reinitialization, under the stop and band rules that the program's
domain-decomposed path (``ShardedLevelSet`` on a shard mesh) defines,
computed with no blocks.

Where these rules part from the unsharded pipeline (``pipeline.run_mesh``):

* the grid: each axis rounded up to a multiple of the mesh's shards (the
  sharded ``from_surface``), the extra points beyond the unsharded grid's
  last;
* the reinitializations (the initial one and the final one, through the
  same solver): the stop test after every step (one step per exchange),
  not at the end of each banded chunk; each step's live bricks are
  recomputed from the step's input, an 8^3 brick grid anchored on each
  block's origin (a block of 249 cells has bricks at 0, 8, ..., 248, the
  last one cut short), each brick live where the least |phi| over its
  cells dilated by 4, within the block and its 4-cell halo, lies below
  ``(band radius + h / dx) dx``;
* the min/max flow: the band fixed at its start and the stop test after
  every step, which on the whole grid is the dense solve (the update gate
  is each cell's own |phi| against the band, so a cell outside the band
  never changes and no brick mask can move a number);
* the sums of squared changes are added over the whole grid here, per
  block then over the blocks in the program, so an RMS read next to the
  tolerance may stop one step apart (``iters_gap`` 1);
* the init is the whole grid's, its 16^3 culling blocks anchored on the
  grid; the program anchors them on each block, and the cell's blocks are
  mostly not multiples of 16, so a point's candidates arrive in another
  order and a near-tie between triangles may sign a point on the surface
  the other way (ROADMAP H13, differences of ~2e-6).

The advection and everything else are the unsharded reference's.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import geometry, pipeline, solvers

#: A shard's halo on its sharded axes in the program's reinit (the order-8
#: stencil's radius, at one step per exchange).
HALO = 4
#: The band's dilation of a brick's cells (the WENO stencil's reach).
DILATE = 4


def grid_on(verts, dx: float, pad_cells: int, mesh_shape) -> geometry.Grid:
    """The unsharded grid, each axis rounded up to a multiple of the
    mesh."""
    g = geometry.from_surface(verts, dx, pad_cells)
    return geometry.Grid(tuple(-(-n // m) * m for n, m in
                               zip(g.shape, mesh_shape)), g.origin, dx)


def axis_bricks(n: int, m: int) -> list:
    """Along one axis of ``n`` points cut into ``m`` blocks: every brick of
    every block's brick grid that holds owned cells, as (first owned cell,
    one past the last, first cell of its window, one past the last)."""
    b, halo = n // m, (HALO if m > 1 else 0)
    out = []
    for off in range(0, n, b):
        for lo in range(off, off + b, solvers.BRICK):
            hi = lo + solvers.BRICK
            out.append((lo, min(hi, off + b), max(lo - DILATE, off - halo, 0),
                        min(hi + DILATE, off + b + halo, n)))
    return out


def live_cells(phi, bricks, thresh: float):
    """The cells of the bricks whose least |phi| over their window lies
    below ``thresh``: one separable minimum per axis, then each cell
    mapped to its brick."""
    a = torch.abs(phi)
    for d, ax in enumerate(bricks):
        a = torch.stack([a.narrow(d, w0, w1 - w0).amin(dim=d)
                         for _, _, w0, w1 in ax], dim=d)
    live = a < thresh
    for d, ax in enumerate(bricks):
        idx = torch.tensor([k for k, (c0, c1, _, _) in enumerate(ax)
                            for _ in range(c0, c1)], device=phi.device)
        live = live.index_select(d, idx)
    return live


def reinit_blocks(phi0, dx, h, iters: int, tol, *, mesh_shape,
                  band_radius=8.1):
    """(phi, iterations): one banded step at a time, the live bricks of
    :func:`live_cells` from the step's input, the stop rule after every
    step."""
    sc = solvers.reinit_scalars(dx, h)
    denom = solvers.rms_denominator(phi0.shape)
    bricks = [axis_bricks(n, m) for n, m in zip(phi0.shape, mesh_shape)]
    f32 = np.float32
    thresh = float(f32(band_radius + h / dx) * f32(dx))
    p, n = phi0, 0
    while n < iters:
        live = live_cells(p, bricks, thresh)
        q = solvers.ghost(torch.where(live, solvers.reinit_update(p, phi0,
                                                                  sc), p),
                          sc["dx"])
        del live
        rms = math.sqrt(solvers._dsq(q, p).item() / denom)
        p, n = q, n + 1
        if rms < tol or math.isnan(rms):
            break
    return p, n


def run_mesh(soup, dx, pad_cells, overrides, mesh_shape, device) -> dict:
    """One mesh (a float32 triangle soup) through the pipeline under the
    sharded rules on a mesh of ``mesh_shape`` shards."""
    s = pipeline.settings(overrides)
    verts, elems = geometry.soup_mesh(soup)
    grid = grid_on(verts, dx, pad_cells, mesh_shape)
    dxx = dx / geometry.surface_diag(verts)
    phi0 = pipeline._phi0(grid, verts, elems, s, device)
    phi_init, r_it = reinit_blocks(
        phi0, dx, s["reinit_cfl"] * dxx, s["reinit_iters"], s["reinit_tol"],
        mesh_shape=mesh_shape, band_radius=s["stencil_band_radius"])
    del phi0
    phi_s, m_it = solvers.minmax_dense(
        phi_init, dx, s["minmax_cfl"] * dxx, s["minmax_iters"],
        s["minmax_tol"], band_radius=s["band_radius"])
    out = dict(shape=grid.shape, phi_init=pipeline._host(phi_init),
               reinit_iters=r_it, minmax_iters=m_it)
    del phi_init
    nodes = solvers.advect(phi_s, grid, pipeline._nodes(verts, device), dx,
                           s["advect_iters"], s["advect_eps"])
    out["advected"] = pipeline._host(nodes)
    phi_final, _ = reinit_blocks(
        phi_s, dx, s["final_reinit_cfl"] * dxx, s["final_reinit_iters"],
        s["reinit_tol"], mesh_shape=mesh_shape,
        band_radius=s["stencil_band_radius"])
    out.update(phi_smoothed=pipeline._host(phi_s),
               phi_final=pipeline._host(phi_final))
    return out
