"""The three entries the cells drive, recomputed in plain PyTorch from the
meshes the benchmark made: one mesh through the whole pipeline, a batch
of meshes through the dense solver stages, and the gradient of a rendered
image's loss with respect to the vertices.

Settings default to the upstream program's literals (``set3d.f90``,
``subs.f90``); a configuration file may override them.
"""

from __future__ import annotations

import numpy as np
import torch

from . import geometry, init, render, solvers

#: The upstream literals the solver stages use.
SETTINGS = dict(
    reinit_iters=10000, reinit_cfl=0.1, reinit_tol=1e-5,
    minmax_iters=10000, minmax_cfl=0.01, minmax_tol=1e-7,
    band_radius=4.1, stencil_band_radius=8.1, nb_refresh_every=8,
    minmax_nb_refresh_every=16, advect_iters=1000, advect_eps=1e-13,
    final_reinit_iters=2000, final_reinit_cfl=0.001, init_cull_block=16)


def settings(overrides: dict) -> dict:
    unknown = set(overrides) - set(SETTINGS)
    if unknown:
        raise ValueError(f"the reference has no setting {sorted(unknown)}")
    return {**SETTINGS, **overrides}


def _phi0(grid, verts, elems, s, device):
    rows = geometry.culling_rows(grid, verts, elems,
                                 block=s["init_cull_block"])
    return init.signed_distance(grid, verts, elems, rows, device=device)


def _nodes(verts, device):
    return torch.as_tensor(verts, dtype=torch.float32, device=device)


def _host(t):
    return t.detach().to("cpu", torch.float64).numpy()


def run_mesh(soup, dx, pad_cells, overrides, device) -> dict:
    """One mesh (a float32 triangle soup) through init, the banded initial
    reinit, the banded min/max flow, the advection and the banded final
    reinit."""
    s = settings(overrides)
    verts, elems = geometry.soup_mesh(soup)
    grid = geometry.from_surface(verts, dx, pad_cells)
    dxx = dx / geometry.surface_diag(verts)
    phi0 = _phi0(grid, verts, elems, s, device)
    phi_init, r_it = solvers.reinit_banded(
        phi0, dx, s["reinit_cfl"] * dxx, s["reinit_iters"], s["reinit_tol"],
        band_radius=s["stencil_band_radius"],
        refresh_every=s["nb_refresh_every"])
    del phi0
    phi_s, m_it = solvers.minmax_banded(
        phi_init, dx, s["minmax_cfl"] * dxx, s["minmax_iters"],
        s["minmax_tol"], band_radius=s["band_radius"],
        refresh_every=s["minmax_nb_refresh_every"])
    nodes = solvers.advect(phi_s, grid, _nodes(verts, device), dx,
                           s["advect_iters"], s["advect_eps"])
    phi_final, _ = solvers.reinit_banded(
        phi_s, dx, s["final_reinit_cfl"] * dxx, s["final_reinit_iters"],
        s["reinit_tol"], band_radius=s["stencil_band_radius"],
        refresh_every=s["nb_refresh_every"])
    return dict(shape=grid.shape, phi_init=_host(phi_init),
                phi_smoothed=_host(phi_s), phi_final=_host(phi_final),
                advected=_host(nodes), reinit_iters=r_it, minmax_iters=m_it)


def run_batch(soups, dx, pad_cells, overrides, device) -> list:
    """Each mesh of a batch on the batch's common grid shape, through the
    init and the dense solver stages with per-step stop rules and its own
    float32 step sizes, then the advection."""
    s = settings(overrides)
    meshes = [geometry.soup_mesh(soup) for soup in soups]
    grids = geometry.common_grids([v for v, _ in meshes], dx, pad_cells)
    f32 = np.float32
    out = []
    for (verts, elems), grid in zip(meshes, grids):
        dxx = f32(dx / geometry.surface_diag(verts))
        h_r = float(f32(s["reinit_cfl"]) * dxx)
        h_m = float(f32(s["minmax_cfl"]) * dxx)
        phi0 = _phi0(grid, verts, elems, s, device)
        phi_init, r_it = solvers.reinit_dense(
            phi0, dx, h_r, s["reinit_iters"], s["reinit_tol"])
        del phi0
        phi_s, m_it = solvers.minmax_dense(
            phi_init, dx, h_m, s["minmax_iters"], s["minmax_tol"],
            band_radius=s["band_radius"])
        nodes = solvers.advect(phi_s, grid, _nodes(verts, device), dx,
                               s["advect_iters"], s["advect_eps"])
        out.append(dict(shape=grid.shape, phi_init=_host(phi_init),
                        phi_smoothed=_host(phi_s), advected=_host(nodes),
                        reinit_iters=r_it, minmax_iters=m_it))
    return out


def image_grad(vertices, elements, grid, rows, *, reinit_steps,
               minmax_steps, height, width, eye, target, n_march_steps,
               device) -> tuple:
    """(loss, vertex gradient) of ``0.5 sum(image^2)``: the image rendered
    from the field after ``reinit_steps`` dense reinit steps (the sign
    source the initial field) and ``minmax_steps`` dense min/max steps.
    The gradient runs backward step by step, each step recomputed from its
    stored input under autograd, then through the exact distance at each
    point's triangle; ``rows`` (:func:`.geometry.culling_rows`) holds the
    candidates, built with a margin that covers the vertices."""
    v = torch.as_tensor(np.asarray(vertices), dtype=torch.float32,
                        device=device).requires_grad_(True)
    phi0 = init.signed_distance(grid, v, elements, rows, device=device)
    dx = grid.dx
    h, h1 = 0.1 * dx, 0.01 * dx * dx
    msc = solvers.minmax_scalars(dx, h1)
    p0 = phi0.detach()
    seen_r, seen_m, p = [], [], p0
    with torch.no_grad():
        for _ in range(reinit_steps):
            seen_r.append(p)
            p = solvers.reinit_step(p, p0, dx, h)
        for _ in range(minmax_steps):
            seen_m.append(p)
            p = solvers.minmax_step(p, msc)
    leaf = p.detach().requires_grad_(True)
    origins, dirs = render.camera_rays(height, width, eye=eye, target=target,
                                       device=device)
    img = render.image(leaf, grid, origins, dirs, n_steps=n_march_steps,
                       hit_tol=0.25 * dx)
    loss = 0.5 * torch.sum(img ** 2)
    g, = torch.autograd.grad(loss, leaf)
    for x in reversed(seen_m):
        with torch.enable_grad():
            xl = x.detach().requires_grad_(True)
            g, = torch.autograd.grad(solvers.minmax_step(xl, msc), xl, g)
    g_sign = torch.zeros_like(p0)
    for x in reversed(seen_r):
        with torch.enable_grad():
            xl = x.detach().requires_grad_(True)
            sl = p0.detach().requires_grad_(True)
            g, gs = torch.autograd.grad(solvers.reinit_step(xl, sl, dx, h),
                                        (xl, sl), g)
        g_sign += gs
    vg, = torch.autograd.grad(phi0, v, g + g_sign)
    return float(loss.detach()), vg.detach().cpu().double().numpy()
