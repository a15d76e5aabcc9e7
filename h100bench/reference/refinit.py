"""The upstream program's own init and the pipeline after it, recomputed
in plain PyTorch from the mesh the benchmark made (``set3d.f90:196-308``).

The init: the grid points of the surface's bounding box widened by 3
cells (``set3d.f90:180-186``), each point's nearest triangle centroid
(``:222-236``), the sign of the triple product of the vectors to that
triangle's vertices (``:238-258``), smeared with gM = 1 (``phiSign``,
``subs.f90:152-172``), and +1 beyond the box.  A dense reinit, with the
stop rule after every step, grows that field into a distance
(``set3d.f90:298-308``); then the banded min/max flow, the advection and
the banded final reinit, as :func:`.pipeline.run_mesh` runs them.

Everything runs in float32, in the arithmetic the float32 program
states: the box from the float32 vertices, ``(lo - origin) / dx`` rounded
in float32; a point ``origin + dx i``; the distance term ``|c|^2 - 2 p.c``
with the dot product formed elementwise, its lowest index taken on a tie.
**Departure:** the upstream compares float64 squared distances.  The
points whose nearest centroid that rule would change are counted (a
reading, ``centroid_departures``, bounded by no limit).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import geometry, solvers
from .pipeline import _host, settings

F32 = np.float32
#: The box's margin in cells (``set3d.f90:180-186``).
MARGIN = 3
#: (point, centroid) pairs a step of the search holds: a few 256 MB
#: float32 temporaries.
PAIRS = 2 ** 26
#: A point is a near-tie when the gap between its two least float32
#: distance terms is at most this many float32 epsilons of
#: ``(|p| + max |c|)^2``: beyond it the float32 order is the float64 one.
TIE_EPS = 16
EPS32 = float(np.finfo(F32).eps)


def subbox(grid: geometry.Grid, verts, margin: int = MARGIN) -> list:
    """((i0, i1), (j0, j1), (k0, k1)): the box's index ranges, clamped
    to the grid, from the float32 vertices in float32 arithmetic."""
    v = np.asarray(verts, F32)
    lo, hi = v.min(0), v.max(0)
    out = []
    for a in range(3):
        o, d = F32(grid.origin[a]), F32(grid.dx)
        i0 = math.floor((lo[a] - o) / d) - margin
        i1 = math.floor((hi[a] - o) / d) + margin
        out.append((max(i0, 0), min(i1, grid.shape[a] - 1)))
    return out


def sign_field(grid: geometry.Grid, verts, elems, device) -> tuple:
    """(the smeared +-1 field, the box's points, the points whose nearest
    centroid float64 distances would change)."""
    v = torch.as_tensor(np.asarray(verts, F32), device=device)
    tri = v[torch.as_tensor(elems, dtype=torch.long, device=device)]
    cen = tri.mean(dim=1)
    cn = torch.sum(cen * cen, dim=-1)
    cmax = float(torch.sqrt(cn.max()))
    box = subbox(grid, verts)
    # each axis's float32 coordinates over the box: origin + dx i
    axes = [torch.as_tensor(F32(grid.origin[a]) + F32(grid.dx) * np.arange(
        i0, i1 + 1, dtype=F32), device=device)
        for a, (i0, i1) in enumerate(box)]
    pts = torch.stack(torch.meshgrid(*axes, indexing="ij"), -1).reshape(
        -1, 3)
    n = pts.shape[0]
    dx2 = float(F32(grid.dx) * F32(grid.dx))
    sgn = torch.empty(n, dtype=torch.float32, device=device)
    nearest = torch.empty(n, dtype=torch.long, device=device)
    tie = torch.empty(n, dtype=torch.bool, device=device)
    step = max(1, PAIRS // cen.shape[0])
    for p0 in range(0, n, step):
        p = pts[p0:p0 + step]
        dot = p[:, 0:1] * cen[:, 0] + p[:, 1:2] * cen[:, 1] \
            + p[:, 2:3] * cen[:, 2]
        d = cn - 2.0 * dot
        del dot
        near = torch.argmin(d, dim=1)
        nearest[p0:p0 + step] = near
        t = tri[near]
        a, b, c = (t[:, i] - p for i in range(3))
        ps = -torch.sum(torch.linalg.cross(a, b, dim=-1) * c, dim=-1)
        sgn[p0:p0 + step] = ps / torch.clamp_min(
            torch.sqrt(ps * ps + dx2), 1e-30)
        # near-ties: the two least terms within the float32 roundings
        first = torch.gather(d, 1, near[:, None])[:, 0]
        second = d.scatter(1, near[:, None], math.inf).amin(dim=1)
        tie[p0:p0 + step] = (second - first) <= TIE_EPS * EPS32 * (
            torch.linalg.vector_norm(p, dim=-1) + cmax) ** 2
        del d
    phi = torch.ones(grid.shape, dtype=torch.float32, device=device)
    (i0, i1), (j0, j1), (k0, k1) = box
    phi[i0:i1 + 1, j0:j1 + 1, k0:k1 + 1] = sgn.reshape(
        i1 - i0 + 1, j1 - j0 + 1, k1 - k0 + 1)
    return phi, n, _departures(grid, verts, elems, box, nearest, tie)


def _departures(grid, verts, elems, box, nearest, tie) -> int:
    """Of the near-tie points, those whose nearest centroid by float64
    squared distances, from float64 points and centroids, is another."""
    device = nearest.device
    idx = torch.nonzero(tie)[:, 0]
    cen = torch.as_tensor(np.asarray(verts, np.float64)[elems].mean(1),
                          device=device)
    nj = box[1][1] - box[1][0] + 1
    nk = box[2][1] - box[2][0] + 1
    ijk = torch.stack([idx // (nj * nk), (idx // nk) % nj, idx % nk], -1)
    q = (torch.tensor(grid.origin, dtype=torch.float64, device=device)
         + grid.dx * (ijk + torch.tensor([r[0] for r in box],
                                         device=device)).double())
    out = torch.zeros((), dtype=torch.long, device=device)
    step = max(1, PAIRS // 2 // cen.shape[0])
    for s in range(0, idx.numel(), step):
        d = torch.sum((q[s:s + step, None] - cen) ** 2, dim=-1)
        out += (torch.argmin(d, dim=1) != nearest[idx[s:s + step]]).sum()
    return int(out)


def run_mesh(soup, dx, pad_cells, overrides, device) -> dict:
    """One mesh (a float32 triangle soup) through the upstream's init, the
    dense initial reinit, the banded min/max flow, the advection and the
    banded final reinit; the outputs of :func:`.pipeline.run_mesh`, with
    ``subbox_points`` and ``centroid_departures`` besides."""
    over = dict(overrides)
    if over.pop("init_mode", "reference") != "reference":
        raise ValueError("this reference runs init_mode 'reference' only")
    s = settings(over)
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        verts, elems = geometry.soup_mesh(soup)
        grid = geometry.from_surface(verts, dx, pad_cells)
        dxx = dx / geometry.surface_diag(verts)
        phi0, n_pts, departures = sign_field(grid, verts, elems, device)
        phi_init, r_it = solvers.reinit_dense(
            phi0, dx, s["reinit_cfl"] * dxx, s["reinit_iters"],
            s["reinit_tol"])
        del phi0
        phi_s, m_it = solvers.minmax_banded(
            phi_init, dx, s["minmax_cfl"] * dxx, s["minmax_iters"],
            s["minmax_tol"], band_radius=s["band_radius"],
            refresh_every=s["minmax_nb_refresh_every"])
        nodes = solvers.advect(
            phi_s, grid, torch.as_tensor(verts, dtype=torch.float32,
                                         device=device),
            dx, s["advect_iters"], s["advect_eps"])
        phi_final, _ = solvers.reinit_banded(
            phi_s, dx, s["final_reinit_cfl"] * dxx,
            s["final_reinit_iters"], s["reinit_tol"],
            band_radius=s["stencil_band_radius"],
            refresh_every=s["nb_refresh_every"])
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    return dict(shape=grid.shape, phi_init=_host(phi_init),
                phi_smoothed=_host(phi_s), phi_final=_host(phi_final),
                advected=_host(nodes), reinit_iters=r_it, minmax_iters=m_it,
                subbox_points=n_pts, centroid_departures=departures)
