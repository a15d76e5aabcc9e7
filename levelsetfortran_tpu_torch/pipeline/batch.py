"""Batched serving: many geometries through init -> reinit -> min/max ->
advection (port of ``levelsetfortran_tpu/pipeline/batch.py``).

Every geometry's grid takes the batch's common shape (the per-axis max;
each grid keeps its own origin) and the fields stack into one
``(B, nx, ny, nz)`` tensor.  Each solver stage steps every geometry with
its own pseudo-time step (``cfl * dx / diag`` of its own surface,
``set3d.f90:301``) and its own stop rule: a geometry whose step RMS drops
below the tolerance, or is NaN, is frozen — its field and its count stop —
while the others go on, so each trajectory equals a solo run's.

Strategies (``run_batch``):
  * ``packed`` (and ``auto``, which means it): one launch per step for the
    whole batch, of the pack modes of kernels K1 and K3
    (:func:`..ops.weno_cuda.reinit_step_packed`,
    :func:`..ops.minmax_cuda.minmax_step_packed`); the (B,) RMS vector is
    read to the host once per step.  Fields and counts equal the solo
    dense solvers' bitwise.  On the CPU the pack modes run their plain
    versions, in any dtype; on the card they take float32 grids of at
    least 3 points per axis and raise on anything else.  A min/max average
    half-width other than 1, which no kernel takes, runs the solo
    :func:`..solvers.minmax_flow.minmax_flow` per geometry.
  * ``sequential``: the solo dense solvers per geometry.
There is no final reinit, as in the JAX package's batch pipeline.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import List, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from ..config import LevelSetConfig
from ..grid import grid as gridmod
from ..grid.grid import Grid3D
from ..io.s3d import read_s3d, write_s3d
from ..io.stl import SurfaceMesh, read_stl
from ..io.vti import write_vti
from ..ops import minmax_cuda, weno_cuda
from ..ops.init_sign import initialize_sign_field, signed_distance_init
from ..ops.weno_cuda import np_dtype, packed_vector
from ..solvers.advect import advect_nodes
from ..solvers.minmax_flow import minmax_flow
from ..solvers.reinit import reinit, rms_denominator
from ..utils.logging import StageTimer, log_event

MeshLike = Union[str, SurfaceMesh]
STRATEGIES = ("auto", "packed", "sequential")


# ---------------------------- batched solvers -----------------------------

class BatchSolve(NamedTuple):
    phi: torch.Tensor            # (B, nx, ny, nz)
    iterations: np.ndarray       # (B,) steps each geometry took
    final_rms: np.ndarray        # (B,) its last step's RMS
    diverged: np.ndarray         # (B,) NaN flags


def _batched_solve(phi0, iters: int, tol, step) -> BatchSolve:
    """The JAX package's per-geometry stop rule around ``step(p, out,
    live)``, which writes one step of the live geometries into ``out``
    (frozen ones copied) and returns ``(out, dsq)`` with the (B,) sums of
    squared changes.  One host read of that vector per step."""
    b = phi0.shape[0]
    denom = rms_denominator(phi0.shape[1:])
    counts = np.zeros(b, np.int64)
    rms = np.full(b, np.inf)
    done = np.zeros(b, bool)
    live = torch.ones(b, dtype=torch.int32, device=phi0.device)
    bufs = (torch.empty_like(phi0), torch.empty_like(phi0))
    p, n = phi0, 0
    while not done.all() and n < iters:
        p, dsq = step(p, bufs[n % 2], live)
        step_rms = np.sqrt(dsq.cpu().numpy() / denom)
        rms = np.where(done, rms, step_rms)
        counts += ~done
        now = done | (step_rms < tol) | np.isnan(step_rms)
        if (now != done).any():
            live = torch.as_tensor(~now, dtype=torch.int32,
                                   device=phi0.device)
        done, n = now, n + 1
    return BatchSolve(p, counts, rms, np.isnan(rms))


def reinit_batched_packed(phi0, dx, h, iters: int, tol, *, eps_scale=1e-6,
                          eps_floor=None,
                          quirk_y_p5_zero=False) -> BatchSolve:
    """Batched reinit, one packed K1 launch per step; ``h`` per geometry,
    the sign source frozen at ``phi0``.  Geometry b's field and count equal
    a solo :func:`..solvers.reinit.reinit` of ``phi0[b]`` bitwise."""
    hv = packed_vector(h, phi0.shape[0], phi0.dtype, phi0.device)
    sums = weno_cuda.solve_buffers(phi0, packed=True)

    def step(p, out, live):
        return weno_cuda.reinit_step_packed(
            p, phi0, dx, hv, live, out=out, with_rms=True,
            eps_scale=eps_scale, eps_floor=eps_floor,
            quirk_y_p5_zero=quirk_y_p5_zero, bufs=sums)

    return _batched_solve(phi0, iters, tol, step)


def minmax_batched_packed(phi0, dx, h1, iters: int, tol, *, band_radius=4.1,
                          threshold=0.0) -> BatchSolve:
    """Batched min/max flow, one packed K3 launch per step (the default
    half-width; K4 has no pack mode); ``h1`` per geometry."""
    hv = packed_vector(h1, phi0.shape[0], phi0.dtype, phi0.device)
    sums = weno_cuda.solve_buffers(phi0, packed=True)

    def step(p, out, live):
        return minmax_cuda.minmax_step_packed(
            p, dx, hv, live, band_radius, threshold, out=out, with_rms=True,
            bufs=sums)

    return _batched_solve(phi0, iters, tol, step)


# ------------------------------ grid stacking ------------------------------

def common_shape_grids(meshes: Sequence[SurfaceMesh], dx: float,
                       pad_cells: int) -> List[Grid3D]:
    """Per-mesh grids sharing one common (per-axis max) shape.  Each grid
    keeps its own origin, so the extra cells are far-field padding on the
    high side, which the narrow band never reaches."""
    grids = [gridmod.from_surface(m.vertices, dx, pad_cells) for m in meshes]
    shape = tuple(int(max(g.shape[i] for g in grids)) for i in range(3))
    return [Grid3D(shape=shape, origin=g.origin, dx=dx) for g in grids]


# -------------------------------- pipeline ---------------------------------

@dataclasses.dataclass
class BatchItem:
    """One geometry's outputs; the fields are host float64 numpy."""
    mesh: SurfaceMesh
    grid: Grid3D
    phi_init: np.ndarray
    phi_smoothed: np.ndarray
    advected: np.ndarray
    asymptotic_error: float
    reinit_iters: int
    minmax_iters: int
    name: str


def step_sizes(meshes: Sequence[SurfaceMesh], cfg: LevelSetConfig) -> tuple:
    """Each geometry's (reinit h, min/max h1), as the JAX package forms
    them (``batch.py:365-366``): the cfl times ``dx / diag`` of its own
    surface, in ``cfg.dtype`` arrays."""
    t = np_dtype(cfg.dtype)
    dxx = np.asarray([cfg.dx / gridmod.surface_diag(m.vertices)
                      for m in meshes], t)
    return t(cfg.reinit_cfl) * dxx, t(cfg.minmax_cfl) * dxx


def _load(m: MeshLike) -> tuple:
    if isinstance(m, SurfaceMesh):
        return m, "surface"
    name = os.path.splitext(os.path.basename(m))[0]
    return (read_s3d(m) if m.lower().endswith(".s3d") else read_stl(m)), name


def run_batch(inputs: Sequence[MeshLike],
              config: LevelSetConfig = LevelSetConfig(), *,
              out_dir: Optional[str] = None, write_outputs: bool = False,
              data_parallel=None, strategy: str = "auto",
              timer: Optional[StageTimer] = None) -> List[BatchItem]:
    """Serve a batch of geometries through init -> reinit -> min/max ->
    advection, each solver stage stepping the whole batch (see the module
    docstring for ``strategy``).  With ``write_outputs`` each geometry's
    ``signedDistanceFunction.vti``, ``smoothedDistanceFunction.vti`` and
    ``<name>.s3d`` go to ``out_dir/<name>/``.  ``data_parallel`` (the batch
    sharded over devices) is not ported yet."""
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}; known: "
                         f"{', '.join(STRATEGIES)}")
    if data_parallel:
        raise NotImplementedError("data_parallel needs torch.distributed: "
                                  "ROADMAP Queue 1 item 11c")
    timer = timer or StageTimer()
    cfg = config
    dtype = cfg.dtype
    device = cfg.torch_device()

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    loaded = [_load(m) for m in inputs]
    meshes = [m for m, _ in loaded]
    names = [n if n != "surface" else f"surface{i}"
             for i, (_, n) in enumerate(loaded)]
    grids = common_shape_grids(meshes, cfg.dx, cfg.pad_cells)
    shape = grids[0].shape
    log_event("batch_grid", shape=list(shape), b=len(meshes), dx=cfg.dx,
              device=str(device))

    # per-geometry init, either mode (JAX batch.py:358-363)
    if cfg.init_mode == "distance":
        culling = None if cfg.init_culling == "off" else "auto"

        def init(g, m):
            return signed_distance_init(
                g, m.vertices, m.elements, dtype=dtype, device=device,
                culling=culling, cull_block=cfg.init_cull_block)
    else:
        def init(g, m):
            return initialize_sign_field(g, m.vertices, m.elements,
                                         dtype=dtype, device=device)
    phi0 = torch.stack([init(g, m) for g, m in zip(grids, meshes)])
    sync()
    timer.mark("search")

    h_r, h_m = step_sizes(meshes, cfg)
    strategy = "packed" if strategy == "auto" else strategy
    log_event("batch_strategy", strategy=strategy)

    rkw = dict(eps_scale=cfg.weno_eps_scale, eps_floor=cfg.eps_floor,
               quirk_y_p5_zero=cfg.quirks.weno_y_p5_zero)
    mkw = dict(band_radius=cfg.band_radius, threshold=cfg.minmax_threshold)
    if strategy == "sequential":
        r = _stack([reinit(phi0[i], cfg.dx, float(h_r[i]), cfg.reinit_iters,
                           cfg.reinit_tol, **rkw) for i in range(len(meshes))])
    else:
        r = reinit_batched_packed(phi0, cfg.dx, h_r, cfg.reinit_iters,
                                  cfg.reinit_tol, **rkw)
    sync()
    timer.mark("initialization")

    if strategy == "sequential" or cfg.minmax_avg_halfwidth != 1:
        m = _stack([minmax_flow(r.phi[i], cfg.dx, float(h_m[i]),
                                cfg.minmax_iters, cfg.minmax_tol,
                                avg_halfwidth=cfg.minmax_avg_halfwidth, **mkw)
                    for i in range(len(meshes))])
    else:
        m = minmax_batched_packed(r.phi, cfg.dx, h_m, cfg.minmax_iters,
                                  cfg.minmax_tol, **mkw)
    sync()
    timer.mark("minmax")

    advected = [
        advect_nodes(m.phi[i], grids[i],
                     torch.as_tensor(meshes[i].vertices, dtype=dtype,
                                     device=device),
                     cfg.dx, iters=cfg.advect_iters, eps=cfg.advect_eps,
                     order=cfg.advect_grad_order,
                     stencil_radius=cfg.stencil_band_radius,
                     quirk_deriv8_y=cfg.quirks.deriv8_y_jp1).positions
        for i in range(len(meshes))]
    sync()
    timer.mark("advect")

    diff = m.phi - r.phi
    sums = torch.sum(diff * diff, dim=(1, 2, 3)).cpu().tolist()
    asym = [math.sqrt(s / rms_denominator(shape)) for s in sums]

    def host(x):
        return x.detach().to("cpu", torch.float64).numpy()

    log_event("batch_reinit", iterations=r.iterations.tolist(),
              rms=r.final_rms.tolist())
    log_event("batch_minmax", iterations=m.iterations.tolist(),
              rms=m.final_rms.tolist())
    items = []
    for i, (mesh, g, name) in enumerate(zip(meshes, grids, names)):
        item = BatchItem(
            mesh=mesh, grid=g, phi_init=host(r.phi[i]),
            phi_smoothed=host(m.phi[i]), advected=host(advected[i]),
            asymptotic_error=asym[i], reinit_iters=int(r.iterations[i]),
            minmax_iters=int(m.iterations[i]), name=name)
        items.append(item)
        if write_outputs:
            d = os.path.join(out_dir or ".", name)
            os.makedirs(d, exist_ok=True)
            write_vti(os.path.join(d, "signedDistanceFunction.vti"),
                      item.phi_init, g)
            write_vti(os.path.join(d, "smoothedDistanceFunction.vti"),
                      item.phi_smoothed, g)
            write_s3d(os.path.join(d, name + ".s3d"), mesh, item.advected)
    if write_outputs:
        log_event("batch_outputs", dir=out_dir or ".", n=len(items))
    timer.mark("total")
    return items


def _stack(results) -> BatchSolve:
    """Solo solver results as one batched result."""
    return BatchSolve(torch.stack([s.phi for s in results]),
                      np.asarray([s.iterations for s in results]),
                      np.asarray([s.final_rms for s in results]),
                      np.asarray([s.diverged for s in results]))
