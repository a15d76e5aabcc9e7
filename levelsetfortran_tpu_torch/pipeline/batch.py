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
  * ``packed``: one launch per step for the whole batch, of the pack
    modes of kernels K1 and K3 (:func:`..ops.weno_cuda.reinit_step_packed`,
    :func:`..ops.minmax_cuda.minmax_step_packed`); the (B,) RMS vector is
    read to the host once per step.  Fields and counts equal the solo
    dense solvers' bitwise.  On the CPU the pack modes run their plain
    versions; on the card float32 grids launch them (an axis under 3
    points raises), bfloat16 and float64 run the plain versions there.  A
    min/max average half-width other than 1, which no kernel takes, runs
    the solo :func:`..solvers.minmax_flow.minmax_flow` per geometry.
  * ``sequential``: the solo dense solvers per geometry.
  * ``auto``: ``packed`` where the pack kernels take the batch's dtype
    (float32: :func:`..ops.weno_cuda.kernel_supported`, the JAX package's
    ``packed_applicable``), else ``sequential``, as the JAX package's auto
    strategy picks (``batch.py:370-385``; it has no vmap strategy here).
There is no final reinit, as in the JAX package's batch pipeline.

Data parallelism (``run_batch(data_parallel=...)``, the CLI's
``--data-parallel``): the batch is cut into N contiguous shares, each on a
card taken round-robin over the visible cards, and each share is
initialised, stepped (its own pack-mode launch per step) and advected on
its card.  Every share's step is launched before any share's RMS vector
is read, so the cards step together.  Departure: the JAX package pads the
batch to a multiple of the devices with copies of its last geometry and
drops their results; each share here is its own launch and needs no
copies.  The results are the same: each geometry equals its solo run.
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
from ..ops.weno_cuda import (kernel_supported, packed_vector, round_to,
                              route)
from ..parallel.mesh import default_devices
from ..solvers.advect import advect_nodes
from ..solvers.minmax_flow import minmax_flow
from ..solvers.converge import rms_denominator, stops
from ..solvers.reinit import reinit
from ..utils.logging import StageTimer, log_event
from ..utils.profiling import count, span
from .run import _host, _host_field, _stage_kw, _sync

MeshLike = Union[str, SurfaceMesh]
STRATEGIES = ("auto", "packed", "sequential")


# ---------------------------- batched solvers -----------------------------

class BatchSolve(NamedTuple):
    phi: torch.Tensor            # (B, nx, ny, nz)
    iterations: np.ndarray       # (B,) steps each geometry took
    final_rms: np.ndarray        # (B,) its last step's RMS
    diverged: np.ndarray         # (B,) NaN flags


class _Solve:
    """One batch's state under the JAX package's per-geometry stop rule:
    ``step(p, out, live)`` writes one step of the live geometries into
    ``out`` (frozen ones copied) and returns ``(out, dsq)`` with the (B,)
    sums of squared changes."""

    def __init__(self, phi0, step):
        b = phi0.shape[0]
        self.step, self.p = step, phi0
        self.denom = rms_denominator(phi0.shape[1:])
        self.counts = np.zeros(b, np.int64)
        self.rms = np.full(b, np.inf)
        self.done = np.zeros(b, bool)
        self.live = torch.ones(b, dtype=torch.int32, device=phi0.device)
        self.bufs = (torch.empty_like(phi0), torch.empty_like(phi0))

    def launch(self, n: int):
        self.p, dsq = self.step(self.p, self.bufs[n % 2], self.live)
        return dsq

    def settle(self, dsq, tol) -> None:
        """The host read of this step's (B,) vector and the stop rule."""
        count("batch.host_reads")
        step_rms = np.sqrt(dsq.cpu().numpy() / self.denom)
        self.rms = np.where(self.done, self.rms, step_rms)
        self.counts += ~self.done
        now = self.done | stops(step_rms, tol)
        if (now != self.done).any():
            self.live = torch.as_tensor(~now, dtype=torch.int32,
                                        device=self.p.device)
        self.done = now

    def result(self) -> "BatchSolve":
        return BatchSolve(self.p, self.counts, self.rms, np.isnan(self.rms))


def _batched_solves(problems, iters: int, tol) -> list:
    """Solve several batches (``(phi0, step)`` pairs, each on its own
    device) side by side: each step launches every running batch before it
    reads any batch's RMS vector, so their devices work together.  Each
    batch's result is the one it would have alone."""
    with span("lsf.batched_solve"):
        solves = [_Solve(phi0, step) for phi0, step in problems]
        for n in range(iters):
            running = [s for s in solves if not s.done.all()]
            if not running:
                break
            count("batch.steps")
            dsqs = [s.launch(n) for s in running]
            for s, dsq in zip(running, dsqs):
                s.settle(dsq, tol)
        return [s.result() for s in solves]


def _reinit_packed_step(phi0, dx, h, *, eps_scale=1e-6, eps_floor=None,
                        quirk_y_p5_zero=False):
    hv = packed_vector(h, phi0.shape[0], phi0.dtype, phi0.device)
    sums = weno_cuda.solve_buffers(phi0, packed=True)
    packed = route(phi0, weno_cuda.reinit_step_packed,
                   weno_cuda.reinit_step_packed_plain)

    def step(p, out, live):
        return packed(
            p, phi0, dx, hv, live, out=out, with_rms=True,
            eps_scale=eps_scale, eps_floor=eps_floor,
            quirk_y_p5_zero=quirk_y_p5_zero, bufs=sums)

    return step


def _minmax_packed_step(phi0, dx, h1, *, band_radius=4.1, threshold=0.0):
    hv = packed_vector(h1, phi0.shape[0], phi0.dtype, phi0.device)
    sums = weno_cuda.solve_buffers(phi0, packed=True)
    packed = route(phi0, minmax_cuda.minmax_step_packed,
                   minmax_cuda.minmax_step_packed_plain)

    def step(p, out, live):
        return packed(
            p, dx, hv, live, band_radius, threshold, out=out, with_rms=True,
            bufs=sums)

    return step


def reinit_batched_packed(phi0, dx, h, iters: int, tol, *, eps_scale=1e-6,
                          eps_floor=None,
                          quirk_y_p5_zero=False) -> BatchSolve:
    """Batched reinit, one packed K1 launch per step; ``h`` per geometry,
    the sign source frozen at ``phi0``.  Geometry b's field and count equal
    a solo :func:`..solvers.reinit.reinit` of ``phi0[b]`` bitwise."""
    step = _reinit_packed_step(phi0, dx, h, eps_scale=eps_scale,
                               eps_floor=eps_floor,
                               quirk_y_p5_zero=quirk_y_p5_zero)
    return _batched_solves([(phi0, step)], iters, tol)[0]


def minmax_batched_packed(phi0, dx, h1, iters: int, tol, *, band_radius=4.1,
                          threshold=0.0) -> BatchSolve:
    """Batched min/max flow, one packed K3 launch per step (the default
    half-width; K4 has no pack mode); ``h1`` per geometry."""
    step = _minmax_packed_step(phi0, dx, h1, band_radius=band_radius,
                               threshold=threshold)
    return _batched_solves([(phi0, step)], iters, tol)[0]


# ------------------------------ grid stacking ------------------------------

def common_shape_grids(meshes: Sequence[SurfaceMesh], dx: float,
                       pad_cells: int,
                       multiple_of=(1, 1, 1)) -> List[Grid3D]:
    """Per-mesh grids sharing one common (per-axis max) shape, each axis
    rounded as :func:`..grid.grid.from_surface` rounds it with
    ``multiple_of``.  Each grid keeps its own origin, so the extra cells are
    far-field padding on the high side, which the narrow band never
    reaches."""
    grids = [gridmod.from_surface(m.vertices, dx, pad_cells, multiple_of)
             for m in meshes]
    shape = tuple(int(max(g.shape[i] for g in grids)) for i in range(3))
    return [Grid3D(shape=shape, origin=g.origin, dx=dx) for g in grids]


# -------------------------------- pipeline ---------------------------------

@dataclasses.dataclass
class BatchItem:
    """One geometry's outputs; the fields are host float64 numpy of shape
    ``grid.shape`` (x, y, z), x fastest in memory (the ``.vti`` payload's
    order, made on the card: ``run._host_field``)."""
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
    surface, in ``cfg.dtype`` (CPU tensors)."""
    dxx = round_to([cfg.dx / gridmod.surface_diag(m.vertices)
                    for m in meshes], cfg.dtype)
    return (round_to(cfg.reinit_cfl, cfg.dtype) * dxx,
            round_to(cfg.minmax_cfl, cfg.dtype) * dxx)


def _load(m: MeshLike) -> tuple:
    if isinstance(m, SurfaceMesh):
        return m, "surface"
    name = os.path.splitext(os.path.basename(m))[0]
    return (read_s3d(m) if m.lower().endswith(".s3d") else read_stl(m)), name


def _shares(b: int, n: int) -> list:
    """``n`` contiguous shares of ``b`` geometries (the first ``b % n`` one
    larger), empty ones dropped."""
    q, r = divmod(b, n)
    shares, lo = [], 0
    for i in range(n):
        hi = lo + q + (i < r)
        if hi > lo:
            shares.append(range(lo, hi))
        lo = hi
    return shares


def run_batch(inputs: Sequence[MeshLike],
              config: LevelSetConfig = LevelSetConfig(), *,
              out_dir: Optional[str] = None, write_outputs: bool = False,
              data_parallel: Union[bool, int, None] = None,
              strategy: str = "auto",
              timer: Optional[StageTimer] = None) -> List[BatchItem]:
    """Serve a batch of geometries through init -> reinit -> min/max ->
    advection, each solver stage stepping the whole batch (see the module
    docstring for ``strategy``).  With ``write_outputs`` each geometry's
    ``signedDistanceFunction.vti``, ``smoothedDistanceFunction.vti`` and
    ``<name>.s3d`` go to ``out_dir/<name>/``.

    ``data_parallel``: ``True`` (one share per visible device of the
    config's device type) or an int N cuts the batch into N contiguous
    shares, each on a device taken round-robin over the visible ones (so N
    = 2 runs on one card too; more shares than geometries leave some
    empty).  Each share runs the chosen strategy on its own device; the
    results equal the undivided batch's."""
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}; known: "
                         f"{', '.join(STRATEGIES)}")
    with span("lsf.run_batch"):
        return _run_batch(inputs, config, out_dir, write_outputs,
                          data_parallel, strategy, timer or StageTimer())


def _run_batch(inputs, config, out_dir, write_outputs, data_parallel,
               strategy, timer):
    cfg = config
    dtype = cfg.dtype
    device = cfg.torch_device()

    with span("lsf.run_batch.load"):
        loaded = [_load(m) for m in inputs]
    meshes = [m for m, _ in loaded]
    names = [n if n != "surface" else f"surface{i}"
             for i, (_, n) in enumerate(loaded)]
    grids = common_shape_grids(meshes, cfg.dx, cfg.pad_cells)
    shape = grids[0].shape
    log_event("batch_grid", shape=list(shape), b=len(meshes), dx=cfg.dx,
              device=str(device))

    if data_parallel:
        visible = default_devices(device)
        n_shares = (len(visible) if data_parallel is True
                    else int(data_parallel))
        shares = _shares(len(meshes), n_shares)
        devices = [visible[i % len(visible)] for i in range(len(shares))]
        log_event("batch_dp", shares=[len(s) for s in shares],
                  devices=[str(d) for d in devices])
    else:
        shares, devices = [range(len(meshes))], [device]

    ikw, rkw, mkw, akw = _stage_kw(cfg)
    # per-geometry init, either mode (JAX batch.py:358-363), on its share's
    # device
    if cfg.init_mode == "distance":
        def init(g, m, dev):
            with span("lsf.run_batch.init"):
                return signed_distance_init(
                    g, m.vertices, m.elements, dtype=dtype, device=dev,
                    **ikw)
    else:
        def init(g, m, dev):
            with span("lsf.run_batch.init"):
                return initialize_sign_field(g, m.vertices, m.elements,
                                             dtype=dtype, device=dev)
    phi0 = [torch.stack([init(grids[j], meshes[j], dev) for j in share])
            for share, dev in zip(shares, devices)]
    _sync(devices)
    timer.mark("search")

    h_r, h_m = step_sizes(meshes, cfg)
    if strategy == "auto":
        # the pack kernels take a batch exactly where the solo kernels
        # take its grids (the JAX package's packed_applicable)
        strategy = ("packed" if kernel_supported(shape, dtype)
                    else "sequential")
    log_event("batch_strategy", strategy=strategy)

    if strategy == "sequential":
        r = [_stack([reinit(p[k], cfg.dx, float(h_r[j]), cfg.reinit_iters,
                            cfg.reinit_tol, **rkw)
                     for k, j in enumerate(share)])
             for p, share in zip(phi0, shares)]
    else:
        r = _batched_solves(
            [(p, _reinit_packed_step(p, cfg.dx, h_r[list(share)], **rkw))
             for p, share in zip(phi0, shares)],
            cfg.reinit_iters, cfg.reinit_tol)
    _sync(devices)
    timer.mark("initialization")

    if strategy == "sequential" or cfg.minmax_avg_halfwidth != 1:
        m = [_stack([minmax_flow(rs.phi[k], cfg.dx, float(h_m[j]),
                                 cfg.minmax_iters, cfg.minmax_tol,
                                 avg_halfwidth=cfg.minmax_avg_halfwidth,
                                 **mkw)
                     for k, j in enumerate(share)])
             for rs, share in zip(r, shares)]
    else:
        m = _batched_solves(
            [(rs.phi, _minmax_packed_step(rs.phi, cfg.dx, h_m[list(share)],
                                          **mkw))
             for rs, share in zip(r, shares)],
            cfg.minmax_iters, cfg.minmax_tol)
    _sync(devices)
    timer.mark("minmax")

    # (share, index in it) of each geometry, in batch order
    where = [(s, k) for s, share in enumerate(shares)
             for k in range(len(share))]
    with span("lsf.run_batch.advect"):
        advected = [
            advect_nodes(m[s].phi[k], grids[i],
                         torch.as_tensor(meshes[i].vertices, dtype=dtype,
                                         device=devices[s]),
                         cfg.dx, **akw).positions
            for i, (s, k) in enumerate(where)]
    _sync(devices)
    timer.mark("advect")

    r_iters = np.concatenate([rs.iterations for rs in r])
    m_iters = np.concatenate([ms.iterations for ms in m])
    log_event("batch_reinit", iterations=r_iters.tolist(),
              rms=np.concatenate([rs.final_rms for rs in r]).tolist())
    log_event("batch_minmax", iterations=m_iters.tolist(),
              rms=np.concatenate([ms.final_rms for ms in m]).tolist())
    with span("lsf.run_batch.to_host"):
        sums = []
        for rs, ms in zip(r, m):
            diff = ms.phi - rs.phi
            sums += torch.sum(diff * diff, dim=(1, 2, 3)).cpu().tolist()
        asym = [math.sqrt(v / rms_denominator(shape)) for v in sums]
        items = []
        for i, (mesh, g, name) in enumerate(zip(meshes, grids, names)):
            s, k = where[i]
            items.append(BatchItem(
                mesh=mesh, grid=g, phi_init=_host_field(r[s].phi[k]),
                phi_smoothed=_host_field(m[s].phi[k]),
                advected=_host(advected[i]),
                asymptotic_error=asym[i], reinit_iters=int(r_iters[i]),
                minmax_iters=int(m_iters[i]), name=name))
    if write_outputs:
        with span("lsf.run_batch.write"):
            for item in items:
                d = os.path.join(out_dir or ".", item.name)
                os.makedirs(d, exist_ok=True)
                write_vti(os.path.join(d, "signedDistanceFunction.vti"),
                          item.phi_init, item.grid)
                write_vti(os.path.join(d, "smoothedDistanceFunction.vti"),
                          item.phi_smoothed, item.grid)
                write_s3d(os.path.join(d, item.name + ".s3d"), item.mesh,
                          item.advected)
        log_event("batch_outputs", dir=out_dir or ".", n=len(items))
    timer.mark("total")
    return items


def _stack(results) -> BatchSolve:
    """Solo solver results as one batched result."""
    return BatchSolve(torch.stack([s.phi for s in results]),
                      np.asarray([s.iterations for s in results]),
                      np.asarray([s.final_rms for s in results]),
                      np.asarray([s.diverged for s in results]))
