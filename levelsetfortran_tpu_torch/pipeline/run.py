"""End-to-end pipeline: STL -> SDF init -> reinit -> min/max smoothing ->
node advection -> final reinit -> outputs (port of the single-device and
the ``mesh_shape`` branches of ``levelsetfortran_tpu/pipeline/run.py``;
stage order of ``set3d.f90:85-654``).

With ``config.mesh_shape`` the grid is cut into the blocks of a shard mesh
and stays in blocks from the init to the outputs: sharded init,
:class:`~..parallel.sharded.ShardedLevelSet` for the three solver stages,
sharded advection, ``.vti`` files streamed in z-slabs.  It is the way to
run a grid that one device does not hold.  Under a process group
(:func:`..parallel.distributed.init_distributed`) the mesh spans the
processes: every rank calls :func:`run` with the same arguments, steps
its own blocks, and gets the same iterations, RMS, asymptotic error and
advected nodes; the primary (rank 0) alone writes the ``.vti`` and
``.s3d`` files and, with ``gather_results``, holds the gathered fields
(None on the other ranks).

With ``config.checkpoint_dir`` the initial reinit and the min/max flow run
as chunked, resumable solves (:mod:`..solvers.checkpointed`) that save
their state into ``<dir>/reinit`` and ``<dir>/minmax`` every
``checkpoint_chunk`` iterations, with or without a mesh; a run on the same
directory resumes where a preempted one stopped.  Without a mesh these are
the dense solvers, as in the JAX package.  ``init_mode="reference"``
starts from the reference's smeared +-1 field, whose far field only a
dense initial reinit grows to distance (:func:`_banded`).
"""

from __future__ import annotations

import dataclasses
import math
import os
import threading
import weakref
from typing import Optional

import numpy as np
import torch

from ..config import LevelSetConfig
from ..grid import grid as gridmod
from ..io.s3d import read_s3d, write_s3d
from ..io.stl import SurfaceMesh, read_stl
from ..io.vti import write_vti, write_vti_streaming
from ..ops.derivs import first_derivative
from ..ops.init_sign import (initialize_sign_field, signed_distance_init,
                              signed_distance_init_sharded)
from ..parallel import distributed
from ..parallel.mesh import default_devices, make_mesh
from ..parallel.sharded import ShardedLevelSet, advect_nodes_sharded
from ..solvers.advect import advect_nodes
from ..solvers.checkpointed import (minmax_resumable,
                                    minmax_resumable_sharded,
                                    reinit_resumable, reinit_resumable_sharded)
from ..solvers.minmax_flow import minmax_flow, minmax_flow_narrowband
from ..solvers.converge import rms_denominator
from ..solvers.reinit import reinit, reinit_narrowband
from ..utils.checkpoint import FieldCheckpointer
from ..utils.logging import StageTimer, log_event
from ..utils.profiling import count, span


@dataclasses.dataclass
class PipelineResult:
    """Pipeline outputs.  The three phi fields are host float64 numpy of
    shape ``grid.shape`` (x, y, z), x fastest in memory (Fortran order,
    the ``.vti`` payload's: :func:`_host_field`); under a mesh with
    ``config.gather_results=False`` they stay lists of block tensors in
    shard order, each on its shard's device (None for another rank's
    block under a process group); with ``gather_results`` under a process
    group they are None on every rank but the primary."""
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
    with span("lsf.run_mesh"):
        return _run_mesh(mesh, config, timer or StageTimer(), out_dir, base,
                         write_outputs)


def _run_mesh(mesh, config, timer, out_dir, base, write_outputs):
    cfg = config
    dtype = cfg.dtype
    device = cfg.torch_device()
    if cfg.mesh_shape:
        return _run_mesh_sharded(mesh, cfg, device, timer, out_dir, base,
                                 write_outputs)
    ikw, rkw, mkw, akw = _stage_kw(cfg)

    # --- grid setup (set3d.f90:89-173) ---
    with span("lsf.run_mesh.grid"):
        grid = gridmod.from_surface(mesh.vertices, cfg.dx, cfg.pad_cells)
        dxx = cfg.dx / gridmod.surface_diag(mesh.vertices)   # set3d.f90:301
    log_event("grid", shape=list(grid.shape), dx=cfg.dx, device=str(device))

    # --- inside/outside classification (set3d.f90:196-268) ---
    if cfg.init_mode == "distance":
        phi0 = signed_distance_init(grid, mesh.vertices, mesh.elements,
                                    dtype=dtype, device=device, **ikw)
    else:
        phi0 = initialize_sign_field(grid, mesh.vertices, mesh.elements,
                                     dtype=dtype, device=device)
    # the three results' host memory, first touched while the card runs
    # the init: the first touch is most of a hand-over (_host_field)
    host = ([_host_array(grid.shape) for _ in range(3)] if _staged(phi0)
            else [None] * 3)
    _sync([device])
    timer.mark("search")                    # set3d.f90:271-273

    fkw = dict(rkw, metrics_every=cfg.metrics_every)
    h_r, h_m = cfg.reinit_cfl * dxx, cfg.minmax_cfl * dxx
    # --- initial reinitialization (set3d.f90:298-308) ---
    # checkpointed: chunked dense solves with resume and no metrics, as in
    # the JAX package (run.py:229-256)
    if cfg.checkpoint_dir:
        with FieldCheckpointer(
                os.path.join(cfg.checkpoint_dir, "reinit")) as ck:
            r = reinit_resumable(phi0, cfg.dx, h_r, cfg.reinit_iters,
                                 cfg.reinit_tol, ckpt=ck,
                                 chunk=cfg.checkpoint_chunk, **rkw)
    elif _banded(cfg, initial=True):
        r = reinit_narrowband(phi0, cfg.dx, h_r, cfg.reinit_iters,
                              cfg.reinit_tol,
                              band_radius=cfg.stencil_band_radius,
                              refresh_every=cfg.nb_refresh_every, **fkw)
    else:
        r = reinit(phi0, cfg.dx, h_r, cfg.reinit_iters, cfg.reinit_tol,
                   **fkw)
    phi_init = r.phi
    _sync([device])
    timer.mark("initialization")            # set3d.f90:314-316

    # --- min/max smoothing (set3d.f90:394-462) ---
    if cfg.checkpoint_dir:
        with FieldCheckpointer(
                os.path.join(cfg.checkpoint_dir, "minmax")) as ck:
            m = minmax_resumable(phi_init, cfg.dx, h_m, cfg.minmax_iters,
                                 cfg.minmax_tol, ckpt=ck,
                                 chunk=cfg.checkpoint_chunk,
                                 avg_halfwidth=cfg.minmax_avg_halfwidth,
                                 **mkw)
    elif _banded(cfg, initial=False) and cfg.minmax_avg_halfwidth == 1:
        m = minmax_flow_narrowband(
            phi_init, cfg.dx, h_m, cfg.minmax_iters, cfg.minmax_tol,
            refresh_every=cfg.minmax_nb_refresh_every,
            metrics_every=cfg.metrics_every, **mkw)
    else:
        m = minmax_flow(phi_init, cfg.dx, h_m, cfg.minmax_iters,
                        cfg.minmax_tol,
                        avg_halfwidth=cfg.minmax_avg_halfwidth,
                        metrics_every=cfg.metrics_every, **mkw)
    phi_smoothed = m.phi
    _sync([device])
    timer.mark("minmax")

    # --- node advection (set3d.f90:470-501) ---
    nodes = torch.as_tensor(mesh.vertices, dtype=dtype, device=device)
    adv = advect_nodes(phi_smoothed, grid, nodes, cfg.dx, **akw)
    _sync([device])
    timer.mark("advect")

    # --- asymptotic error (set3d.f90:508-521) ---
    with span("lsf.run_mesh.asym"):
        diff = phi_smoothed - phi_init
        asym = math.sqrt(float(torch.sum(diff * diff))
                         / rms_denominator(grid.shape))

    # --- final reinit (set3d.f90:576-582) ---
    fargs = (phi_smoothed, cfg.dx, cfg.final_reinit_cfl * dxx,
             cfg.final_reinit_iters, cfg.reinit_tol)
    if _banded(cfg, initial=False):
        rf = reinit_narrowband(*fargs, band_radius=cfg.stencil_band_radius,
                               refresh_every=cfg.nb_refresh_every, **fkw)
    else:
        rf = reinit(*fargs, **fkw)
    _sync([device])
    timer.mark("total")                     # set3d.f90:652-654

    with span("lsf.run_mesh.to_host"):
        phi_init_h, phi_smoothed_h, phi_final_h = (
            _host_field(f) if out is None else _host_field(f, out)
            for f, out in zip((phi_init, phi_smoothed, rf.phi), host))
        advected_h = _host(adv.positions)
    log_event("reinit", iterations=r.iterations, rms=r.final_rms,
              diverged=r.diverged)
    log_event("minmax", iterations=m.iterations, rms=m.final_rms,
              diverged=m.diverged)
    log_event("asymptotic_error", rms=asym)

    if write_outputs:
        with span("lsf.run_mesh.write"):
            os.makedirs(out_dir, exist_ok=True)
            write_vti(os.path.join(out_dir, "signedDistanceFunction.vti"),
                      phi_init_h, grid)
            write_vti(os.path.join(out_dir, "smoothedDistanceFunction.vti"),
                      phi_smoothed_h, grid)
            write_s3d(os.path.join(out_dir, base + ".s3d"), mesh,
                      advected_h)
        log_event("outputs", dir=out_dir)

    return PipelineResult(
        mesh=mesh, grid=grid, phi_init=phi_init_h,
        phi_smoothed=phi_smoothed_h, phi_final=phi_final_h,
        advected=advected_h, asymptotic_error=asym,
        reinit_iters=r.iterations, minmax_iters=m.iterations,
        reinit_diverged=r.diverged, minmax_diverged=m.diverged,
        timers=dict(timer.marks))


def _banded(cfg, *, initial: bool) -> bool:
    """Whether a solver stage runs on the narrow band (``run.py:42-57`` of
    the JAX package).

    float64 takes the dense solvers, as in the JAX package, whose banded
    solvers fall back to the dense ones wherever their kernel does not
    apply (every float64 run).  "on"/"off" are forced.  "auto" bands every
    stage except the initial reinit of a ``reference`` init: that field is
    a smeared +-1 whose far field must be grown to distance by full-grid
    relaxation, which frozen bricks would leave at +-1.  The min/max flow
    and the final reinit ask with ``initial=False``."""
    if cfg.dtype != torch.float32:
        return False
    if cfg.narrow_band != "auto":
        return cfg.narrow_band == "on"
    return not (initial and cfg.init_mode == "reference")


def _host(t):
    return t.detach().to("cpu", torch.float64).numpy()


def _host_field(t, out: Optional[np.ndarray] = None):
    """A 3-D grid field on the host as :func:`_host` gives it, with the
    same values and shape (x, y, z), but x fastest in memory: the field is
    permuted to (z, y, x) on its device before the copy, so the ``.vti``
    writer takes its payload as it lies, with no host transpose.

    A field on a card (:func:`_staged`) is copied as it is into the pinned
    buffer :data:`_staging` (one ``cudaMemcpyAsync`` and a wait on the
    stream), then widened from there straight into the float64 result by
    one ``torch`` copy, parallel over the intra-op threads: no pageable
    temporary, and the buffer never leaves this function.  The result is
    ``out`` where given (a :func:`_host_array` of the field's shape), else
    a new array.  Any other field takes ``.to("cpu", torch.float64)``."""
    zyx = t.detach().permute(2, 1, 0).contiguous()
    if not _staged(zyx):
        return zyx.to("cpu", torch.float64).numpy().transpose(2, 1, 0)
    if out is None:
        out = np.empty(t.shape, np.float64, order="F")
    assert (out.shape == t.shape and out.dtype == np.float64
            and out.flags.f_contiguous)
    nbytes = zyx.numel() * zyx.element_size()
    with _staging_lock:
        buf = _staging_buffer(nbytes)[:nbytes].view(zyx.dtype).view(zyx.shape)
        buf.copy_(zyx)
        torch.from_numpy(out.transpose(2, 1, 0)).copy_(buf)
    count("host.staged_bytes", nbytes)
    return out


def _host_array(shape) -> np.ndarray:
    """A float64 array of ``shape``, x fastest in memory, its pages
    touched: the first write to fresh host memory costs more than the
    widening into it (the kernel's page faults), so a caller that knows a
    field's shape while the card is busy takes that cost there."""
    out = np.empty(shape, np.float64, order="F")
    torch.from_numpy(out.transpose(2, 1, 0)).zero_()
    return out


#: The pinned host buffer a grid field on a card passes through on its way
#: to the host (:func:`_host_field`): kept across calls, regrown only for a
#: larger field.
_staging: Optional[torch.Tensor] = None
_staging_lock = threading.Lock()


def _staged(t) -> bool:
    """Whether a field goes to the host through :data:`_staging`."""
    return t.is_cuda


def _staging_buffer(nbytes: int) -> torch.Tensor:
    """:data:`_staging`, regrown to ``nbytes`` if it holds fewer; the old
    buffer is let go (and unpinned) before the new one is pinned."""
    global _staging
    if _staging is None or _staging.numel() < nbytes:
        _staging = None
        _staging = _pinned(nbytes)
    return _staging


def _pinned(nbytes: int) -> torch.Tensor:
    """``nbytes`` bytes of page-locked host memory: host memory registered
    with CUDA while the tensor lives (``pin_memory=True`` would round the
    size up to a power of two)."""
    buf = torch.empty(nbytes, dtype=torch.uint8)
    cudart = torch.cuda.cudart()
    portable = 1                            # cudaHostRegisterPortable
    err = int(cudart.cudaHostRegister(buf.data_ptr(), nbytes, portable))
    if err:
        raise RuntimeError(f"cudaHostRegister failed: cudaError {err}")
    weakref.finalize(buf, cudart.cudaHostUnregister, buf.data_ptr())
    return buf


def _sync(devices) -> None:
    """Wait for the cards among ``devices`` (a stage's end, timed)."""
    for d in set(devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _stage_kw(cfg) -> tuple:
    """The config's keyword arguments of the distance init (its culling),
    the reinit, the min/max flow and the node advection."""
    return (dict(culling=None if cfg.init_culling == "off" else "auto",
                 cull_block=cfg.init_cull_block),
            dict(eps_scale=cfg.weno_eps_scale, eps_floor=cfg.eps_floor,
                 quirk_y_p5_zero=cfg.quirks.weno_y_p5_zero),
            dict(band_radius=cfg.band_radius, threshold=cfg.minmax_threshold),
            dict(iters=cfg.advect_iters, eps=cfg.advect_eps,
                 order=cfg.advect_grad_order,
                 stencil_radius=cfg.stencil_band_radius,
                 quirk_deriv8_y=cfg.quirks.deriv8_y_jp1))


def _run_mesh_sharded(mesh, cfg, device, timer, out_dir, base,
                      write_outputs) -> PipelineResult:
    """The domain-decomposed pipeline (``run.py:108-228, 306-391`` of the
    JAX package): every O(grid) field is a list of blocks throughout, but
    for a reference init, computed on the whole grid and then cut.  One
    solver runs the three stages, banded as the initial reinit is
    (``_banded(initial=True)``, as in the JAX package).  Under a process
    group each rank holds its own blocks; the sums are added in shard
    order, the outputs written by the primary."""
    dtype = cfg.dtype
    ikw, rkw, mkw, akw = _stage_kw(cfg)
    banded = _banded(cfg, initial=True)
    if cfg.overlap and (cfg.narrow_band != "off"
                        or cfg.steps_per_exchange != 1):
        raise ValueError(
            "overlap runs the exchange beside the dense single-step "
            "kernel: it needs narrow_band='off' and steps_per_exchange=1")
    if cfg.minmax_avg_halfwidth != 1:
        raise NotImplementedError(
            "minmax_avg_halfwidth != 1 under mesh_shape: the sharded "
            "min/max step takes the reference's 3x3x3 average only")
    devices = default_devices(device)
    # "auto": one shard per device, under a process group one per rank
    smesh = make_mesh(None if cfg.mesh_shape == "auto" else cfg.mesh_shape,
                      devices)
    mine = [d for d in smesh.devices if d is not None]

    # --- grid setup: every axis a multiple of the mesh ---
    grid = gridmod.from_surface(mesh.vertices, cfg.dx, cfg.pad_cells,
                                smesh.shape)
    dxx = cfg.dx / gridmod.surface_diag(mesh.vertices)   # set3d.f90:301

    # --- the solver: its constructor checks the blocks' sizes ---
    solver = ShardedLevelSet(
        smesh, grid.shape, cfg.dx, **rkw,
        steps_per_exchange=cfg.steps_per_exchange, narrow_band=banded,
        band_radius=cfg.stencil_band_radius, overlap=cfg.overlap,
        metrics_every=cfg.metrics_every)
    log_event("grid", shape=list(grid.shape), dx=cfg.dx, device=str(device),
              mesh=list(smesh.shape), devices=sorted({str(d) for d in mine}),
              steps_per_exchange=solver.k, narrow_band=banded,
              overlap=solver.use_overlap)

    # --- init: sharded exact distance, or the whole-grid reference init
    # cut into blocks (JAX run.py:149-152, 182, 208) ---
    if cfg.init_mode == "distance":
        phi0 = signed_distance_init_sharded(
            grid, mesh.vertices, mesh.elements, smesh, dtype=dtype, **ikw)
    else:
        phi0 = solver.device_put(initialize_sign_field(
            grid, mesh.vertices, mesh.elements, dtype=dtype,
            device=mine[0]))
    _sync(mine)
    timer.mark("search")

    # --- the solver stages on the blocks ---
    def stage(name, resumable, solve, phi, *args, **kw):
        """One solver stage: with ``checkpoint_dir`` resumable chunks of
        the sharded solver, saved block by block (JAX run.py:173-214)."""
        if not cfg.checkpoint_dir:
            out, it, rms = solve(phi, *args, **kw)
            return out, it, rms, math.isnan(rms)
        with FieldCheckpointer(os.path.join(cfg.checkpoint_dir, name)) as ck:
            rr = resumable(solver, phi, *args, ckpt=ck,
                           chunk=cfg.checkpoint_chunk, **kw)
        return rr.phi, rr.iterations, rr.final_rms, rr.diverged

    h_r, h_m = cfg.reinit_cfl * dxx, cfg.minmax_cfl * dxx
    phi_init, r_it, r_rms, r_div = stage(
        "reinit", reinit_resumable_sharded, solver.reinit, phi0, h_r,
        cfg.reinit_iters, cfg.reinit_tol)
    _sync(mine)
    timer.mark("initialization")

    phi_smoothed, m_it, m_rms, m_div = stage(
        "minmax", minmax_resumable_sharded, solver.minmax_flow, phi_init,
        h_m, cfg.minmax_iters, cfg.minmax_tol, **mkw)
    _sync(mine)
    timer.mark("minmax")

    # --- node advection: phi stays in blocks, the nodes are replicated;
    # its span closes once the mesh's cards are done ---
    with span("lsf.sharded.advect"):
        adv = advect_nodes_sharded(
            smesh, phi_smoothed, grid,
            torch.as_tensor(mesh.vertices, dtype=dtype, device=mine[0]),
            cfg.dx, **akw)
        _sync(mine)
    timer.mark("advect")

    # --- asymptotic error from the blocks (set3d.f90:508-521): the
    # per-block sums added in shard order, across processes too ---
    sums = [None if a is None else torch.sum((a - b) * (a - b))
            for a, b in zip(phi_smoothed, phi_init)]
    asym = math.sqrt(distributed.shard_order_sum(sums, smesh.owners)
                     / rms_denominator(grid.shape))

    # --- final reinit (set3d.f90:576-582) ---
    phi_final, _, f_rms = solver.reinit(
        phi_smoothed, cfg.final_reinit_cfl * dxx, cfg.final_reinit_iters,
        cfg.reinit_tol)
    _sync(mine)
    timer.mark("total")

    advected_h = _host(adv.positions)
    log_event("reinit", iterations=r_it, rms=r_rms, diverged=r_div)
    log_event("minmax", iterations=m_it, rms=m_rms, diverged=m_div)
    log_event("asymptotic_error", rms=asym)

    if write_outputs:
        # collective: the primary writes, the other ranks send it slabs
        primary = distributed.is_primary()
        if primary:
            os.makedirs(out_dir, exist_ok=True)
        write_vti_streaming(
            os.path.join(out_dir, "signedDistanceFunction.vti"), phi_init,
            grid, smesh)
        write_vti_streaming(
            os.path.join(out_dir, "smoothedDistanceFunction.vti"),
            phi_smoothed, grid, smesh)
        if primary:
            write_s3d(os.path.join(out_dir, base + ".s3d"), mesh,
                      advected_h)
        log_event("outputs", dir=out_dir)

    fields = (phi_init, phi_smoothed, phi_final)
    if cfg.gather_results:
        fields = tuple(None if g is None else _host_field(g) for g in (
            solver.gather(f, "cpu") for f in fields))
    return PipelineResult(
        mesh=mesh, grid=grid, phi_init=fields[0], phi_smoothed=fields[1],
        phi_final=fields[2], advected=advected_h, asymptotic_error=asym,
        reinit_iters=r_it, minmax_iters=m_it, reinit_diverged=r_div,
        minmax_diverged=m_div, timers=dict(timer.marks))


def gradient_magnitude(phi, dx, order: int = 2):
    """Diagnostic |grad phi| via central differences (set3d.f90:528-536),
    on ``phi``'s device (a numpy array becomes a CPU tensor)."""
    _, mag = first_derivative(torch.as_tensor(phi), dx, order=order)
    return mag
