"""End-to-end pipeline: STL -> SDF init -> reinit -> min/max smoothing ->
node advection -> final reinit -> outputs (port of the single-device
branch of ``levelsetfortran_tpu/pipeline/run.py``; stage order of
``set3d.f90:85-654``).
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional

import numpy as np
import torch

from ..config import LevelSetConfig
from ..grid import grid as gridmod
from ..io.s3d import read_s3d, write_s3d
from ..io.stl import SurfaceMesh, read_stl
from ..io.vti import write_vti
from ..ops.init_sign import signed_distance_init
from ..solvers.advect import advect_nodes
from ..solvers.minmax_flow import minmax_flow, minmax_flow_narrowband
from ..solvers.reinit import reinit, reinit_narrowband, rms_denominator
from ..utils.logging import StageTimer, log_event


@dataclasses.dataclass
class PipelineResult:
    """Pipeline outputs; the three phi fields are host float64 numpy."""
    mesh: SurfaceMesh
    grid: gridmod.Grid3D
    phi_init: np.ndarray          # after initial reinit (vti #1 field)
    phi_smoothed: np.ndarray      # after min/max flow (vti #2 field)
    phi_final: np.ndarray         # after final reinit
    advected: np.ndarray          # (n_nodes, 3) advected node coords
    asymptotic_error: float       # RMS(phi_smoothed - phi_init)
    reinit_iters: int
    minmax_iters: int
    reinit_diverged: bool
    minmax_diverged: bool
    timers: dict


def run(stl_path: str, config: LevelSetConfig = LevelSetConfig(), *,
        out_dir: Optional[str] = None, write_outputs: bool = True
        ) -> PipelineResult:
    """Run the full pipeline on an STL (or .s3d) file; with
    ``write_outputs`` emit ``signedDistanceFunction.vti``,
    ``smoothedDistanceFunction.vti`` and ``<basename>.s3d`` into
    ``out_dir`` (default: alongside the input)."""
    timer = StageTimer()
    mesh = (read_s3d(stl_path) if stl_path.lower().endswith(".s3d")
            else read_stl(stl_path))
    return run_mesh(mesh, config, timer=timer,
                    out_dir=out_dir or os.path.dirname(stl_path) or ".",
                    base=os.path.splitext(os.path.basename(stl_path))[0],
                    write_outputs=write_outputs)


def run_mesh(mesh: SurfaceMesh, config: LevelSetConfig, *,
             timer: Optional[StageTimer] = None, out_dir: str = ".",
             base: str = "surface", write_outputs: bool = False
             ) -> PipelineResult:
    """Pipeline on an in-memory mesh."""
    timer = timer or StageTimer()
    cfg = config
    dtype = cfg.dtype
    device = cfg.torch_device()

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    # --- grid setup (set3d.f90:89-173) ---
    grid = gridmod.from_surface(mesh.vertices, cfg.dx, cfg.pad_cells)
    dxx = cfg.dx / gridmod.surface_diag(mesh.vertices)   # set3d.f90:301
    log_event("grid", shape=list(grid.shape), dx=cfg.dx, device=str(device))

    # --- exact signed-distance init ---
    phi0 = signed_distance_init(
        grid, mesh.vertices, mesh.elements, dtype=dtype, device=device,
        culling=None if cfg.init_culling == "off" else "auto",
        cull_block=cfg.init_cull_block)
    sync()
    timer.mark("search")                    # set3d.f90:271-273

    # --- initial reinitialization (set3d.f90:298-308) ---
    # "auto" and "on" band both reinits (the distance init is already
    # |grad| = 1, and the final reinit starts from a converged SDF)
    banded = cfg.narrow_band != "off"
    rkw = dict(eps_scale=cfg.weno_eps_scale, eps_floor=cfg.eps_floor,
               quirk_y_p5_zero=cfg.quirks.weno_y_p5_zero)
    if banded:
        r = reinit_narrowband(phi0, cfg.dx, cfg.reinit_cfl * dxx,
                              cfg.reinit_iters, cfg.reinit_tol,
                              band_radius=cfg.stencil_band_radius,
                              refresh_every=cfg.nb_refresh_every, **rkw)
    else:
        r = reinit(phi0, cfg.dx, cfg.reinit_cfl * dxx, cfg.reinit_iters,
                   cfg.reinit_tol, **rkw)
    phi_init = r.phi
    sync()
    timer.mark("initialization")            # set3d.f90:314-316

    # --- min/max smoothing (set3d.f90:394-462) ---
    mkw = dict(band_radius=cfg.band_radius, threshold=cfg.minmax_threshold)
    if banded and cfg.minmax_avg_halfwidth == 1:
        m = minmax_flow_narrowband(
            phi_init, cfg.dx, cfg.minmax_cfl * dxx, cfg.minmax_iters,
            cfg.minmax_tol, refresh_every=cfg.minmax_nb_refresh_every, **mkw)
    else:
        m = minmax_flow(phi_init, cfg.dx, cfg.minmax_cfl * dxx,
                        cfg.minmax_iters, cfg.minmax_tol,
                        avg_halfwidth=cfg.minmax_avg_halfwidth, **mkw)
    phi_smoothed = m.phi
    sync()
    timer.mark("minmax")

    # --- node advection (set3d.f90:470-501) ---
    adv = advect_nodes(phi_smoothed, grid,
                       torch.as_tensor(mesh.vertices, dtype=dtype,
                                       device=device),
                       cfg.dx, iters=cfg.advect_iters, eps=cfg.advect_eps,
                       order=cfg.advect_grad_order,
                       stencil_radius=cfg.stencil_band_radius,
                       quirk_deriv8_y=cfg.quirks.deriv8_y_jp1)
    sync()
    timer.mark("advect")

    # --- asymptotic error (set3d.f90:508-521) ---
    diff = phi_smoothed - phi_init
    asym = math.sqrt(float(torch.sum(diff * diff))
                     / rms_denominator(grid.shape))

    # --- final reinit (set3d.f90:576-582) ---
    fargs = (phi_smoothed, cfg.dx, cfg.final_reinit_cfl * dxx,
             cfg.final_reinit_iters, cfg.reinit_tol)
    if banded:
        rf = reinit_narrowband(*fargs, band_radius=cfg.stencil_band_radius,
                               refresh_every=cfg.nb_refresh_every, **rkw)
    else:
        rf = reinit(*fargs, **rkw)
    sync()
    timer.mark("total")                     # set3d.f90:652-654

    def host(t):
        return t.detach().to("cpu", torch.float64).numpy()

    phi_init_h, phi_smoothed_h, phi_final_h = (
        host(phi_init), host(phi_smoothed), host(rf.phi))
    advected_h = host(adv.positions)
    log_event("reinit", iterations=r.iterations, rms=r.final_rms,
              diverged=r.diverged)
    log_event("minmax", iterations=m.iterations, rms=m.final_rms,
              diverged=m.diverged)
    log_event("asymptotic_error", rms=asym)

    if write_outputs:
        os.makedirs(out_dir, exist_ok=True)
        write_vti(os.path.join(out_dir, "signedDistanceFunction.vti"),
                  phi_init_h, grid)
        write_vti(os.path.join(out_dir, "smoothedDistanceFunction.vti"),
                  phi_smoothed_h, grid)
        write_s3d(os.path.join(out_dir, base + ".s3d"), mesh, advected_h)
        log_event("outputs", dir=out_dir)

    return PipelineResult(
        mesh=mesh, grid=grid, phi_init=phi_init_h,
        phi_smoothed=phi_smoothed_h, phi_final=phi_final_h,
        advected=advected_h, asymptotic_error=asym,
        reinit_iters=r.iterations, minmax_iters=m.iterations,
        reinit_diverged=r.diverged, minmax_diverged=m.diverged,
        timers=dict(timer.marks))
