"""Domain-decomposed solver steps: reinitialization and min/max flow on a
grid cut into blocks, with halo exchange between the blocks (port of
``levelsetfortran_tpu/parallel/sharded.py``).

The 3-D grid is block-sharded over a :class:`~.mesh.ShardMesh`; a sharded
field is a list of block tensors, each on its shard's device.  Every mask
the single-device ops derive from the array shape is derived here from
GLOBAL coordinates (block origin + local index, on all three axes), so a
sharded step equals the single-device step cell for cell; only the fused
convergence sum is added in another order (per shard, then over the shards
on the host in float64).

Three families of steps:

* the plain block steps ``reinit_step_local``, ``reinit_k_steps_local``,
  ``reinit_step_local_overlap`` and ``minmax_step_local``: exchange, then
  the kernels' plain PyTorch versions on every block, any dtype, any
  device.  They are what the tests and the kernel checks hold the kernel
  route against;
* the kernel-route steps ``reinit_k_steps_persistent``,
  ``reinit_step_overlap_persistent`` and ``minmax_step_persistent`` on
  persistently padded blocks: one block-mode launch of K1 or K3 per shard
  (:func:`~..ops.weno_cuda.reinit_step_block`,
  :func:`~..ops.minmax_cuda.minmax_step_block`; on CPU tensors their plain
  versions; bfloat16 and float64 blocks run the plain versions on every
  device, the route the JAX package takes by dtype).
  :class:`ShardedLevelSet` runs these and nothing else: there is no second
  route to fall back to;
* the differentiable fixed-step solvers :func:`reinit_fixed_sharded` (dense
  and banded) and :func:`minmax_fixed_sharded`: K1/K3 block mode forward,
  the block modes of the adjoint kernels K5/K6 backward, in gather form
  (the upstream cotangent exchanged, each owned cell's cotangent gathered
  in the solo kernel's order), so values and gradients are the solo fixed
  solvers' bitwise; the scalar cotangents are per-shard sums added in
  shard order.  An average half-width other than 1 has no kernel (in the
  JAX package neither): its plain block step runs under autograd, each
  step checkpointed, the exchange's backward its transpose.

Departures from the JAX package: origins on three axes (z may be sharded
with the kernels, which keep no axis whole); the overlap step's shell is up
to six slabs of bricks, not four strips of tiles; the min/max halo is one
cell wide; the solver loops are Python loops with one host read of the
global sum per check; the adjoints gather from a wider halo (6 cells for
K5, 2 for K6) where the JAX route scatters onto the halo and sends it back
with :func:`~.halo.halo_exchange_transpose`; the metrics stream gets one
event per check for the whole mesh (the JAX package emits from shard
(0, 0, 0), with that shard's tile count), whose ``band_tiles`` is the
active bricks of every shard.

Across processes (a :class:`~.mesh.ShardMesh` made under a process group,
:mod:`.distributed`), every function here steps this rank's shards only
(None in the list for the others'), its exchanges cross the processes
(:mod:`.halo`), and every global sum (the RMS, the scalar cotangents) is
the per-shard sums all-gathered and added in shard order, so every rank
takes the one-process solve's stop decision and returns its scalars.
:func:`dryrun` checks every sharded path on tiny shapes.
"""

from __future__ import annotations

import contextlib
import math
from typing import Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..ops import advect_cuda, minmax_cuda, reverse, weno_cuda
from ..ops.derivs import second_derivative
from ..ops.minmax import seven_point_average
from ..ops.stencil import global_clamped_inner, global_interior_mask
from ..ops.weno_cuda import BRICK, BlockGeom
from ..solvers.converge import converge, step_rms
from ..utils.profiling import count, span
from .distributed import comm_device, shard_order_sum
from .halo import (crop, halo_exchange, halo_exchange_transpose,
                   local_offsets, refresh_halos)
from .mesh import (ShardMesh, default_devices, factor3, gather_blocks,
                   make_mesh, replicate, split_blocks)

HALO = 4   # max stencil radius: WENO5 needs 3, order-8 derivatives need 4


def _each(fn, *lists) -> list:
    """``fn`` over the shards of this process: ``lists`` side by side in
    shard order, None where the first holds another rank's (None) block."""
    return [None if args[0] is None else fn(*args) for args in zip(*lists)]


def _route(blocks, kernel, plain):
    """The block step of this field's dtype (:func:`~..ops.weno_cuda.route`
    of one of this rank's blocks): the block-mode wrapper for float32, its
    plain version for bfloat16 and float64, on every device."""
    mine = next((b for b in blocks if b is not None), None)
    return kernel if mine is None else weno_cuda.route(mine, kernel, plain)


# ----------------------- global-coordinate masks -----------------------

_global_interior_mask = global_interior_mask


def _local_boundary_extrapolate(phi_l, dx, offs, gshape):
    """Global-boundary ghost extrapolation applied to one block: each
    global-face cell takes the value at its global index clamped to
    ``[1, n-2]`` (its diagonal-inner neighbour, always in the same block)
    plus dx — the clamped-index form of the reference BC
    (subs.f90:858-897)."""
    in_grid = _global_interior_mask(phi_l.shape, offs, gshape, 0,
                                    phi_l.device)
    face = in_grid & ~_global_interior_mask(phi_l.shape, offs, gshape, 1,
                                            phi_l.device)
    return torch.where(face, global_clamped_inner(phi_l, offs, gshape) + dx,
                       phi_l)


def sharded_widths(mesh: ShardMesh, width: int) -> Tuple[int, int, int]:
    """``width`` halo cells on the sharded axes, none on an unsharded one."""
    return tuple(width if m > 1 else 0 for m in mesh.shape)


def reinit_geoms(mesh: ShardMesh, gshape, widths) -> list:
    """K1's block geometry per shard: the padded array starts ``widths``
    before the owned origin, the brick grid covers the whole padded array
    and is anchored on the owned block (a brick boundary falls on the owned
    origin), the fused sum counts the owned range."""
    b = mesh.block_shape(gshape)
    return [BlockGeom(tuple(gshape),
                      origin=tuple(o - w for o, w in zip(off, widths)),
                      brick_origin=tuple(-((-w) % BRICK) for w in widths),
                      rms_box=tuple(v for o, n in zip(off, b)
                                    for v in (o, o + n)))
            for off in local_offsets(mesh, b)]


def minmax_geoms(mesh: ShardMesh, gshape, widths) -> list:
    """K3's block geometry per shard: as :func:`reinit_geoms`, but the
    brick grid covers the owned cells only (the one-cell halo never needs
    computing), so ``active`` is the owned block's own brick mask."""
    b = mesh.block_shape(gshape)
    return [BlockGeom(tuple(gshape),
                      origin=tuple(o - w for o, w in zip(off, widths)),
                      brick_origin=tuple(widths), cover=b,
                      rms_box=tuple(v for o, n in zip(off, b)
                                    for v in (o, o + n)))
            for off in local_offsets(mesh, b)]


# ------------------------- plain block steps -------------------------

def reinit_k_steps_local(blocks, sign_blocks, dx, h, k, *, gshape,
                         mesh: ShardMesh, width=None, eps_scale=1e-6,
                         eps_floor=None, quirk_y_p5_zero=False):
    """``k`` Jacobi reinit steps per ONE halo exchange (halo-deep
    pipelining), plain version: exchange a halo of ``width`` (default
    ``3k``: WENO radius 3 per step) cells, step ``k`` times on the padded
    blocks, crop.  Validity shrinks by 3 cells per step, so the owned cells
    are exact: bitwise the cells of ``k`` single-exchange steps."""
    widths = sharded_widths(mesh, 3 * int(k) if width is None else width)
    pads = halo_exchange(blocks, widths, mesh)
    spads = halo_exchange(sign_blocks, widths, mesh)
    geoms = reinit_geoms(mesh, gshape, widths)
    for _ in range(int(k)):
        pads = [weno_cuda.reinit_step_block_plain(
            p, s, dx, h, g, eps_scale=eps_scale, eps_floor=eps_floor,
            quirk_y_p5_zero=quirk_y_p5_zero)
            for p, s, g in zip(pads, spads, geoms)]
    return [crop(p, widths).contiguous() for p in pads]


def reinit_step_local(blocks, sign_blocks, dx, h, *, gshape, mesh, **kw):
    """One Jacobi reinit step on every block, plain version (a halo of
    ``HALO`` cells)."""
    return reinit_k_steps_local(blocks, sign_blocks, dx, h, 1, gshape=gshape,
                                mesh=mesh, width=HALO, **kw)


def reinit_step_local_overlap(blocks, sign_blocks, dx, h, *, gshape,
                              mesh: ShardMesh, eps_scale=1e-6,
                              eps_floor=None, quirk_y_p5_zero=False):
    """One Jacobi reinit step shaped for overlapping the halo exchange with
    the interior compute, plain version: an interior pass that reads only
    the block's own cells (valid 3 or more cells from a shard-internal
    face), the exchange, which does not depend on it, then the cells
    within the WENO radius of a shard face recomputed from 9-wide slabs of
    the exchanged block and pasted over the interior pass's values there.
    Bitwise equal to :func:`reinit_step_local`: every cell is evaluated by
    the same global-mask arithmetic on the same neighbour values."""
    W = 3                               # WENO radius = exchange width
    widths = sharded_widths(mesh, W)
    b = mesh.block_shape(gshape)
    offsets = local_offsets(mesh, b)
    sc = weno_cuda.step_scalars(blocks[0].dtype, dx, h, eps_scale, eps_floor)

    def update_on(vals, svals, o):
        deep = _global_interior_mask(vals.shape, o, gshape, 4, vals.device)
        return weno_cuda._interior_update(vals, svals, sc, quirk_y_p5_zero,
                                          deep=deep)

    upds = [update_on(p, s, o)
            for p, s, o in zip(blocks, sign_blocks, offsets)]
    pads = halo_exchange(blocks, widths, mesh)
    spads = halo_exchange(sign_blocks, widths, mesh)
    out = []
    for phi_l, upd, pad, spad, offs in zip(blocks, upds, pads, spads,
                                           offsets):
        pad_offs = [o - w for o, w in zip(offs, widths)]
        upd = upd.clone()
        for a in range(3):
            if not widths[a]:
                continue
            for side in (0, 1):
                lo = 0 if side == 0 else pad.shape[a] - 3 * W
                o = list(pad_offs)
                o[a] += lo
                shell = update_on(pad.narrow(a, lo, 3 * W),
                                  spad.narrow(a, lo, 3 * W), o)
                shell = shell.narrow(a, W, W)       # the W true shell cells
                for c in range(3):                  # crop other axes' halos
                    if c != a and widths[c]:
                        shell = shell.narrow(c, W, shell.shape[c] - 2 * W)
                upd.narrow(a, 0 if side == 0 else b[a] - W, W).copy_(shell)
        interior = _global_interior_mask(b, offs, gshape, 1, phi_l.device)
        out.append(_local_boundary_extrapolate(
            torch.where(interior, upd, phi_l), sc["dx"], offs, gshape))
    return out


def minmax_step_local(blocks, dx, h1, *, gshape, mesh: ShardMesh,
                      band_radius=4.1, threshold=0.0):
    """One Jacobi min/max smoothing step on every block, plain version (a
    halo of one cell; default average half-width)."""
    widths = sharded_widths(mesh, 1)
    pads = halo_exchange(blocks, widths, mesh)
    geoms = minmax_geoms(mesh, gshape, widths)
    return [crop(minmax_cuda.minmax_step_block_plain(
        p, dx, h1, g, band_radius, threshold), widths).contiguous()
        for p, g in zip(pads, geoms)]


# ------------------------- kernel-route steps -------------------------

def reinit_k_steps_persistent(pads, outs, sign_pads, dx, h, k, *, geoms,
                              widths, mesh, band_radius=None, with_rms=False,
                              **kw):
    """``k`` K1 block-mode steps on PERSISTENTLY padded blocks: refresh the
    halo frame of ``pads`` in place (:func:`~.halo.refresh_halos`: no
    re-padding), then step every block ``k`` times between ``pads`` and the
    spare buffers ``outs``.  The sign source stays padded across the whole
    solve (it is frozen).  ``band_radius`` composes the narrow band with
    the decomposition: each shard's brick activity comes from its freshly
    exchanged block (halo cells are real neighbour cells) with a drift
    margin of ``k*h/dx`` cells, and holds for the ``k`` steps until the
    next exchange.  The fused sum of the last step counts the owned range
    only, so it is right at ``k > 1`` too.

    Returns ``(pads, outs, dsqs)``: the buffers that now hold the iterate,
    the spare ones, and each shard's sum (None without ``with_rms``)."""
    refresh_halos(pads, widths, mesh)
    actives = [None] * len(pads)
    if band_radius is not None:
        actives = _each(lambda p, g: weno_cuda.tile_activity(
            p, dx, band_radius, k * h / dx, window="band4", geom=g),
            pads, geoms)
    dsqs = None
    step = _route(pads, weno_cuda.reinit_step_block,
                  weno_cuda.reinit_step_block_plain)
    for i in range(int(k)):
        rms = with_rms and i == int(k) - 1
        res = _each(lambda p, o, s, g, a: step(
            p, s, dx, h, g, active=a, out=o, with_rms=rms, **kw),
            pads, outs, sign_pads, geoms, actives)
        if rms:
            dsqs = [None if r is None else r[1] for r in res]
        pads, outs = outs, pads
    return pads, outs, dsqs


def overlap_ranges(geom: BlockGeom, pad_shape, widths, block):
    """The brick sub-boxes of the overlap step for one block: ``(interior,
    shells)``, each ``((bx0, by0, bz0), (nbx, nby, nbz))``.  Interior
    bricks hold only cells 3 or more cells inside the owned range on every
    sharded axis, so they read no halo cell; the shell is the rest of the
    brick grid, cut into up to six slabs (two per sharded axis).  None when
    no brick is interior."""
    nb = geom.bricks(pad_shape)
    lo, hi = [], []
    for a in range(3):
        if not widths[a]:
            lo.append(0)
            hi.append(nb[a])
            continue
        c = geom.brick_origin[a]
        lo.append(-(-(widths[a] + 3 - c) // BRICK))
        hi.append((widths[a] + block[a] - 3 - c) // BRICK)
    if any(h <= l for l, h in zip(lo, hi)):
        return None
    shells = []
    t0, tn = [0, 0, 0], list(nb)
    for a in range(3):
        for first, count in ((0, lo[a]), (hi[a], nb[a] - hi[a])):
            if count:
                s0, sn = list(t0), list(tn)
                s0[a], sn[a] = first, count
                shells.append((tuple(s0), tuple(sn)))
        t0[a], tn[a] = lo[a], hi[a] - lo[a]
    return (tuple(t0), tuple(tn)), shells


def _overlapped(pads, side_streams, interior, exchange):
    """Run ``interior()`` on every device's current stream while
    ``exchange()`` runs on a second stream per device; afterwards the
    current streams wait for the exchange.  The second streams first wait
    for the work already queued (the previous step), because the exchange
    reads what that step wrote.  Across processes the exchange's waits for
    the other ranks' slabs (and their copies into the halos) are queued on
    the second streams too, so the shells wait for them.  On the CPU: one
    after the other."""
    devs = sorted({p.device for p in pads
                   if p is not None and p.device.type == "cuda"}, key=str)
    for d in devs:
        if d not in side_streams:
            side_streams[d] = torch.cuda.Stream(d)
        side_streams[d].wait_stream(torch.cuda.current_stream(d))
    interior()
    with contextlib.ExitStack() as stack:
        for d in devs:
            stack.enter_context(torch.cuda.stream(side_streams[d]))
        exchange()
    for d in devs:
        torch.cuda.current_stream(d).wait_stream(side_streams[d])


def reinit_step_overlap_persistent(pads, outs, sign_pads, dx, h, *, geoms,
                                   widths, mesh, ranges, side_streams,
                                   with_rms=False, **kw):
    """One K1 block-mode step with the halo exchange OVERLAPPED with the
    interior compute, on persistently padded blocks:

    1. a launch over the interior bricks of every block, which read only
       owned cells of the not yet refreshed ``pads``, on the compute stream;
    2. :func:`~.halo.refresh_halos` on a second stream at the same time
       (it writes halo cells only, and reads owned cells only);
    3. once the halos have arrived, the shell slabs, writing into the
       output the interior launch part-filled.

    Bitwise equal to the plain persistent step: every brick reads the same
    values either way, and the brick partition is disjoint, so nothing is
    computed twice.  Same returns as :func:`reinit_k_steps_persistent`."""
    shards = list(zip(pads, outs, sign_pads, geoms, ranges))
    parts = [[] for _ in shards]
    step = _route(pads, weno_cuda.reinit_step_block,
                  weno_cuda.reinit_step_block_plain)

    def launch(n, p, o, s, g, tile_range):
        r = step(p, s, dx, h, g, tile_range=tile_range, out=o,
                 with_rms=with_rms, **kw)
        if with_rms:
            parts[n].append(r[1])

    def interior():
        for n, (p, o, s, g, (inner, _)) in enumerate(shards):
            if p is not None:
                launch(n, p, o, s, g, inner)

    _overlapped(pads, side_streams, interior,
                lambda: refresh_halos(pads, widths, mesh))
    for n, (p, o, s, g, (_, shells)) in enumerate(shards):
        for tile_range in shells if p is not None else ():
            launch(n, p, o, s, g, tile_range)
    dsqs = None
    if with_rms:
        dsqs = [torch.stack(ps).sum() if ps else None for ps in parts]
    return outs, pads, dsqs


def minmax_tile_activity_local(blocks, dx, band_radius) -> list:
    """Per-shard brick activity for the banded min/max step: the owned
    block's own brick mask.  A solve-long mask is sound: a frozen cell
    never changes, and the update gate is the cell's OWN value, so it can
    never enter the band."""
    return _each(lambda b: weno_cuda.tile_activity(b, dx, band_radius,
                                                    window="owned"), blocks)


def minmax_step_persistent(pads, outs, dx, h1, band_radius, threshold, *,
                           geoms, widths, mesh, actives=None,
                           with_rms=False):
    """One K3 block-mode step on persistently padded blocks (a halo of one
    cell): refresh the halos of ``pads`` in place, then one launch per
    shard into ``outs``.  Same returns as
    :func:`reinit_k_steps_persistent`."""
    refresh_halos(pads, widths, mesh)
    actives = actives or [None] * len(pads)
    step = _route(pads, minmax_cuda.minmax_step_block,
                  minmax_cuda.minmax_step_block_plain)
    res = _each(lambda p, o, g, a: step(
        p, dx, h1, g, band_radius, threshold, active=a, out=o,
        with_rms=with_rms), pads, outs, geoms, actives)
    dsqs = [None if r is None else r[1] for r in res] if with_rms else None
    return outs, pads, dsqs


def _global_rms(dsqs, gshape, mesh: ShardMesh) -> float:
    """A check's RMS from the shards' sums, the same number on every rank
    (:func:`~..solvers.converge.step_rms`)."""
    return step_rms(dsqs, gshape, mesh.owners)


# --------------------------- public wrapper ---------------------------

class ShardedLevelSet:
    """Domain-decomposed solver bound to a shard mesh.

    Usage::

        s = ShardedLevelSet(mesh, gshape, dx)
        blocks = s.device_put(phi)            # a list of block tensors
        blocks, n, rms = s.reinit(blocks, h, iters, tol)
        phi = s.gather(blocks)

    ``steps_per_exchange`` (k) steps the reinit k times per exchange of a
    ``3k``-cell halo; ``narrow_band`` skips bricks farther than
    ``band_radius`` cells from the interface (reinit: mask per exchange;
    min/max: one solve-long mask); ``overlap`` (k = 1, dense) runs the
    exchange beside the interior launch.  Every block step is the K1/K3
    block-mode kernel on float32 CUDA blocks and its plain version on CPU
    blocks and on bfloat16 or float64 blocks anywhere.
    ``metrics_every``: one metrics event per check for the whole mesh
    (``"reinit"`` / ``"minmax"``) when the iteration count is a multiple.
    On a mesh across processes the lists hold this rank's blocks (None for
    the others') and every rank runs the same loop.
    """

    def __init__(self, mesh: ShardMesh, gshape, dx: float, *,
                 eps_scale=1e-6, eps_floor=None, quirk_y_p5_zero=False,
                 steps_per_exchange: int = 1, narrow_band: bool = False,
                 band_radius: float = 8.1, overlap: bool = False,
                 metrics_every: int = 0):
        self.mesh = mesh
        self.metrics_every = int(metrics_every)
        self.mesh_shape = tuple(mesh.shape)
        self.gshape = tuple(int(g) for g in gshape)
        self.dx = dx
        self.narrow_band = bool(narrow_band)
        self.band_radius = float(band_radius)
        self.overlap = bool(overlap)
        self.k = int(steps_per_exchange)
        if self.k < 1:
            raise ValueError("steps_per_exchange must be >= 1")
        halo_need = max(HALO, 3 * self.k)
        for g, m in zip(self.gshape, self.mesh_shape):
            if g % m:
                raise ValueError(
                    f"global shape {self.gshape} not divisible by mesh "
                    f"{self.mesh_shape}; use mesh.pad_to_multiple")
            if m > 1 and g // m < halo_need:
                raise ValueError(
                    f"shard blocks need >= {halo_need} cells along sharded "
                    f"axes (axis has {g // m}); single-hop halo exchange "
                    f"cannot reach past the adjacent shard")
        self.block = mesh.block_shape(self.gshape)
        self._step_kw = dict(eps_scale=eps_scale, eps_floor=eps_floor,
                             quirk_y_p5_zero=quirk_y_p5_zero)
        self.widths = sharded_widths(mesh, halo_need)
        self._rgeoms = reinit_geoms(mesh, self.gshape, self.widths)
        self.mwidths = sharded_widths(mesh, 1)
        self._mgeoms = minmax_geoms(mesh, self.gshape, self.mwidths)
        pad_shape = tuple(b + 2 * w for b, w in zip(self.block, self.widths))
        self._ranges = [overlap_ranges(g, pad_shape, self.widths, self.block)
                        for g in self._rgeoms]
        #: exchange beside the interior launch: needs k = 1, the dense
        #: kernel and an interior brick box in every block
        self.use_overlap = (self.overlap and self.k == 1
                            and not self.narrow_band
                            and max(self.mesh_shape) > 1
                            and all(r is not None for r in self._ranges))
        self._side_streams = {}

    @staticmethod
    def auto_mesh(devices=None) -> ShardMesh:
        """One shard per device (per process under a process group),
        balanced factors (the CUDA kernels keep no axis whole, so no
        ``(a, b, 1)`` preference as on the TPU)."""
        return make_mesh(None, devices)

    def device_put(self, phi) -> list:
        """Cut a global field (tensor or array) into this mesh's blocks."""
        phi = torch.as_tensor(phi)
        if tuple(phi.shape[:3]) != self.gshape:
            raise ValueError(f"field shape {tuple(phi.shape)} != global "
                             f"shape {self.gshape}")
        return split_blocks(self.mesh, phi)

    def gather(self, blocks, device=None):
        """The global field (across processes on rank 0; None on the
        others)."""
        return gather_blocks(self.mesh, blocks, device)

    def _padded(self, blocks, widths):
        spec = [v for w in reversed(widths) for v in (w, w)]
        return _each(lambda b: F.pad(b, spec).contiguous(), blocks)

    def _cropped(self, pads, widths):
        return _each(lambda p: crop(p, widths).contiguous(), pads)

    def reinit_step(self, blocks, sign_blocks, h) -> list:
        """One reinit step of a sharded field (exchange, one block-mode
        launch per shard, crop)."""
        pads = self._padded(blocks, self.widths)
        outs = _each(torch.zeros_like, pads)
        spads = _each(torch.Tensor.contiguous,
                      halo_exchange(sign_blocks, self.widths, self.mesh))
        pads, _, _ = self._reinit_once(pads, outs, spads, h, 1, False)
        return self._cropped(pads, self.widths)

    def _reinit_once(self, pads, outs, spads, h, k, with_rms):
        if self.use_overlap and k == 1:
            return reinit_step_overlap_persistent(
                pads, outs, spads, self.dx, h, geoms=self._rgeoms,
                widths=self.widths, mesh=self.mesh, ranges=self._ranges,
                side_streams=self._side_streams, with_rms=with_rms,
                **self._step_kw)
        return reinit_k_steps_persistent(
            pads, outs, spads, self.dx, h, k, geoms=self._rgeoms,
            widths=self.widths, mesh=self.mesh,
            band_radius=self.band_radius if self.narrow_band else None,
            with_rms=with_rms, **self._step_kw)

    def reinit(self, blocks, h, iters: int, tol: float, sign_src=None):
        """Up to ``iters`` reinit steps (in exchanges of k), stopping at
        global RMS < tol or NaN: ``(blocks, iterations, rms)``.  The state
        stays in the padded layout for the whole solve; the sign source is
        exchanged once.  Traced as ``lsf.sharded.solve``, its steps
        counted in ``sharded.steps``."""
        with span("lsf.sharded.solve"):
            return self._reinit(blocks, h, iters, tol, sign_src)

    def _reinit(self, blocks, h, iters, tol, sign_src):
        sign = blocks if sign_src is None else sign_src
        spads = _each(torch.Tensor.contiguous,
                      halo_exchange(sign, self.widths, self.mesh))
        return self._converge(
            lambda pads, outs: self._reinit_once(pads, outs, spads, h,
                                                 self.k, True),
            blocks, iters, tol, "reinit", self.widths, self.k)

    def minmax_flow(self, blocks, h1, iters: int, tol: float, *,
                    band_radius=4.1, threshold=0.0):
        """Up to ``iters`` min/max steps with the global RMS early exit:
        ``(blocks, iterations, rms)``.  Traced as ``lsf.sharded.solve``,
        its steps counted in ``sharded.steps``."""
        with span("lsf.sharded.solve"):
            return self._minmax_flow(blocks, h1, iters, tol, band_radius,
                                     threshold)

    def _minmax_flow(self, blocks, h1, iters, tol, band_radius, threshold):
        actives = None
        if self.narrow_band:
            actives = minmax_tile_activity_local(blocks, self.dx,
                                                 band_radius)
        return self._converge(
            lambda pads, outs: minmax_step_persistent(
                pads, outs, self.dx, h1, band_radius, threshold,
                geoms=self._mgeoms, widths=self.mwidths, mesh=self.mesh,
                actives=actives, with_rms=True),
            blocks, iters, tol, "minmax", self.mwidths, 1, actives)

    def _converge(self, step, blocks, iters, tol, stage, widths, k,
                  actives=None):
        """The loop of :mod:`..solvers.converge` over ``step(pads, outs) ->
        (pads, outs, dsqs)`` (``k`` steps) on the blocks padded by
        ``widths``: ``(cropped blocks, iterations, rms)``."""
        def advance(state, n):
            pads, outs, dsqs = step(*state)
            count("sharded.steps", k)
            return (pads, outs), k, dsqs, actives
        pads = self._padded(blocks, widths)
        (pads, _), n, rms, _ = converge(
            advance, (pads, _each(torch.zeros_like, pads)), iters, tol,
            stage=stage, shape=self.gshape, metrics_every=self.metrics_every,
            owners=self.mesh.owners)
        return self._cropped(pads, widths), n, rms


# ------------------ differentiable fixed-step solvers ------------------

def _global_shape(mesh: ShardMesh, blocks) -> tuple:
    mine = next(b for b in blocks if b is not None)
    return tuple(int(b) * m for b, m in zip(mine.shape, mesh.shape))


def _check_block_sizes(mesh: ShardMesh, gshape, width, what):
    for g, m in zip(gshape, mesh.shape):
        if m > 1 and g // m < width:
            raise ValueError(f"{what}: shard blocks need >= {width} cells "
                             f"along sharded axes (axis has {g // m}): the "
                             f"halo of one exchange comes from the adjacent "
                             f"shard only")


def _shard_order_sum(parts, mesh: ShardMesh) -> torch.Tensor:
    """Per-shard float64 sums (None for another rank's shard) added in
    shard order (:func:`~.distributed.shard_order_sum`), a 0-d float64
    tensor: the same number in one process and on every rank."""
    return torch.tensor(shard_order_sum(parts, mesh.owners),
                        dtype=torch.float64)


def _scratch_for(cache, pad):
    """K5's pad.shape scratch (one float per cell between its passes), one
    per device and shape for a whole backward sweep (the launches on one
    card run in order on its stream); None on the CPU and for a dtype the
    kernel does not take, whose plain version needs none."""
    if pad.device.type != "cuda" or not weno_cuda.kernel_supported(
            tuple(pad.shape), pad.dtype):
        return None
    key = (pad.device, tuple(pad.shape))
    if key not in cache:
        cache[key] = torch.empty(tuple(pad.shape), dtype=pad.dtype,
                                 device=pad.device)
    return cache[key]


def _adjoint_masks(actives, mesh: ShardMesh):
    """The backward brick masks of a banded sharded chunk.  Each shard's
    forward mask is right on its OWNED bricks only (a halo brick's band4
    window reaches past the exchanged cells); the adjoint evaluates stencil
    cotangents on halo cells too, where the neighbour's forward ran with
    the neighbour's mask.  So every shard's owned bricks go to the
    neighbours by an exchange one brick wide.  Needs blocks that are
    multiples of 8 on the sharded axes: then the brick grids of neighbours
    coincide, and the forward (halo 4) and backward (halo 6) brick grids of
    a shard start at the same global cell, 8 before the owned origin."""
    def own(a):
        for ax, m in enumerate(mesh.shape):
            if m > 1:
                a = a.narrow(ax, 1, a.shape[ax] - 2)
        return a
    return halo_exchange(_each(own, actives), sharded_widths(mesh, 1), mesh)


class _ReinitFixedSharded(torch.autograd.Function):
    """``steps`` K1 block-mode steps on every shard (halo ``HALO``), the
    sign source frozen at the input blocks; the backward runs K5's block
    mode per shard per step in reverse, in gather form: the iterate, the
    sign source and the upstream cotangent exchanged ``VJP_HALO["reinit"]``
    wide, each owned cell's cotangent gathered as the solo kernel gathers
    it, so the gradient is the solo solve's bitwise and no transpose
    exchange runs.  Dense: the flat stash or the sqrt-N recompute, decided
    from one block's bytes (``reverse.last_branch["reinit_fixed_sharded"]``).
    Banded: per chunk masks from the freshly exchanged chunk start,
    recomputed in the backward, K5 in block + banded mode
    (``sharded.py:949-1139`` of the JAX package)."""

    @staticmethod
    def forward(ctx, dx, h, spec, *blocks):
        mesh, gshape, steps, band_radius, refresh_every, kw = spec
        dxf, hf = float(dx), float(h)
        wf = sharded_widths(mesh, HALO)
        geoms = reinit_geoms(mesh, gshape, wf)
        spads = halo_exchange(blocks, wf, mesh)
        step = _route(blocks, weno_cuda.reinit_step_block,
                      weno_cuda.reinit_step_block_plain)

        def fstep(p, actives=(None,) * len(geoms)):
            return _each(lambda pad, sp, g, a: crop(
                step(pad, sp, dxf, hf, g, active=a, **kw), wf).contiguous(),
                halo_exchange(p, wf, mesh), spads, geoms, actives)

        def masks(p, n):
            return _each(lambda pad, g: weno_cuda.tile_activity(
                pad, dxf, band_radius, n * hf / dxf, window="band4", geom=g),
                halo_exchange(p, wf, mesh), geoms)

        p = list(blocks)
        if band_radius is None:
            p, ctx.traj = reverse.run_forward(fstep, p, steps)
        else:
            ctx.chunks = weno_cuda.chunk_lengths(steps, refresh_every)
            ctx.starts = []
            for n in ctx.chunks:
                ctx.starts.append(p)
                actives = masks(p, n)
                for _ in range(n):
                    p = fstep(p, actives)
        ctx.fns = (fstep, masks)
        ctx.save_for_backward(*blocks)
        ctx.args = (spec, dxf, hf)
        ctx.meta = (reverse.scalar_meta(dx), reverse.scalar_meta(h))
        return tuple(p) if steps else tuple(_each(torch.clone, blocks))

    @staticmethod
    def backward(ctx, *gs):
        blocks = ctx.saved_tensors
        (mesh, gshape, steps, band_radius, _, kw), dxf, hf = ctx.args
        fstep, masks = ctx.fns
        wb = sharded_widths(mesh, weno_cuda.VJP_HALO["reinit"])
        geoms = reinit_geoms(mesh, gshape, wb)
        spads = halo_exchange(blocks, wb, mesh)
        scratch = {}
        vjp = _route(blocks, weno_cuda.reinit_step_block_vjp,
                     weno_cuda.reinit_step_block_vjp_plain)

        def bstep(carry, p_in, actives=(None,) * len(geoms)):
            gp, cs, cdx, ch = carry
            out = [[], [], [], []]
            for i, (pad, sp, gpad, g, a) in enumerate(zip(
                    halo_exchange(p_in, wb, mesh), spads,
                    halo_exchange(gp, wb, mesh), geoms, actives)):
                if pad is None:
                    for acc in out:
                        acc.append(None)
                    continue
                cp, csi, cdxi, chi = vjp(
                    pad, sp, gpad, dxf, hf, g, active=a,
                    scratch=_scratch_for(scratch, pad), **kw)
                for acc, v in zip(out, (cp, cs[i] + csi, cdx[i] + cdxi,
                                        ch[i] + chi)):
                    acc.append(v)
            return tuple(out)

        zeros = _each(lambda b: torch.zeros((), dtype=torch.float64,
                                            device=b.device), blocks)
        carry = (_each(torch.Tensor.contiguous, gs),
                 _each(torch.zeros_like, blocks), zeros, zeros)
        if band_radius is None:
            carry = reverse.run_reverse("reinit_fixed_sharded", fstep, bstep,
                                        list(blocks), carry, steps, ctx.traj)
            ctx.traj = None
        else:
            for p, n in zip(reversed(ctx.starts), reversed(ctx.chunks)):
                actives = masks(p, n)
                back = _adjoint_masks(actives, mesh)
                traj = [p]
                for _ in range(n - 1):
                    traj.append(fstep(traj[-1], actives))
                for p_in in reversed(traj):
                    carry = bstep(carry, p_in, back)
            ctx.starts = None
        gp, cs, cdx, ch = carry
        # the sign source IS the input: both cotangent paths land on it
        return (reverse.scalar_cotangent(ctx.meta[0],
                                         _shard_order_sum(cdx, mesh)),
                reverse.scalar_cotangent(ctx.meta[1],
                                         _shard_order_sum(ch, mesh)),
                None, *_each(torch.add, gp, cs))


def reinit_fixed_sharded(mesh: ShardMesh, blocks, dx, h, steps: int, *,
                         eps_scale=1e-6, eps_floor=None,
                         quirk_y_p5_zero=False, band_radius=None,
                         refresh_every: int = 8) -> list:
    """``steps`` reinit steps of a sharded field (a list of blocks, one per
    shard of ``mesh``), reverse-mode differentiable in the blocks and (as
    0-d tensors) ``dx`` and ``h`` — the port of
    ``parallel/sharded.py:reinit_fixed_sharded`` of the JAX package on its
    fused-kernel route.  Forward: K1's block mode per shard per step;
    backward: K5's block mode, each owned cell's cotangent bitwise the solo
    :func:`~..solvers.reinit.reinit_fixed`'s.

    ``band_radius`` runs the banded x sharded x differentiable composition:
    8^3-brick masks per chunk of ``refresh_every`` steps from each shard's
    exchanged chunk start, frozen bricks copying forward and passing
    cotangents through backward (K5 in block + banded mode); on blocks that
    are multiples of 8 it equals :func:`~..ops.weno_cuda.reinit_scan_banded`
    bitwise.  Needs blocks of >= 6 cells on the sharded axes, and multiples
    of 8 with ``band_radius``."""
    gshape = _global_shape(mesh, blocks)
    _check_block_sizes(mesh, gshape, weno_cuda.VJP_HALO["reinit"],
                       "reinit_fixed_sharded")
    if band_radius is not None and any(
            m > 1 and (g // m) % BRICK for g, m in zip(gshape, mesh.shape)):
        raise ValueError(f"reinit_fixed_sharded(band_radius=...): blocks "
                         f"{mesh.block_shape(gshape)} must be multiples of "
                         f"{BRICK} on the sharded axes of {mesh.shape}, so "
                         f"that the shards' brick masks coincide")
    kw = dict(eps_scale=eps_scale, eps_floor=eps_floor,
              quirk_y_p5_zero=quirk_y_p5_zero)
    spec = (mesh, gshape, int(steps),
            None if band_radius is None else float(band_radius),
            int(refresh_every), kw)
    return list(_ReinitFixedSharded.apply(dx, h, spec, *blocks))


class _MinmaxFixedSharded(torch.autograd.Function):
    """``steps`` K3 block-mode steps on every shard (halo 1); the backward
    runs K6's block mode per shard per step in reverse, in gather form: the
    iterate and the upstream cotangent exchanged ``VJP_HALO["minmax"]``
    wide, each owned cell's cotangent the solo kernel's bitwise
    (``sharded.py:1182-1267`` of the JAX package)."""

    @staticmethod
    def forward(ctx, dx, h1, band_radius, threshold, spec, *blocks):
        mesh, gshape, steps = spec
        args = (float(dx), float(h1), float(band_radius), float(threshold))
        wf = sharded_widths(mesh, 1)
        geoms = minmax_geoms(mesh, gshape, wf)
        step = _route(blocks, minmax_cuda.minmax_step_block,
                      minmax_cuda.minmax_step_block_plain)

        def fstep(p):
            return _each(lambda pad, g: crop(step(
                pad, args[0], args[1], g, *args[2:]), wf).contiguous(),
                halo_exchange(p, wf, mesh), geoms)

        p, ctx.traj = reverse.run_forward(fstep, list(blocks), steps)
        ctx.fstep = fstep
        ctx.save_for_backward(*blocks)
        ctx.args = (spec, args)
        ctx.meta = tuple(reverse.scalar_meta(x)
                         for x in (dx, h1, band_radius, threshold))
        return tuple(p) if steps else tuple(_each(torch.clone, blocks))

    @staticmethod
    def backward(ctx, *gs):
        blocks = ctx.saved_tensors
        (mesh, gshape, steps), args = ctx.args
        wb = sharded_widths(mesh, weno_cuda.VJP_HALO["minmax"])
        geoms = minmax_geoms(mesh, gshape, wb)

        bufs = []                     # per shard, made at the first step
        vjp = _route(blocks, minmax_cuda.minmax_step_block_vjp,
                     minmax_cuda.minmax_step_block_vjp_plain)

        def bstep(gp, p_in):
            pads = halo_exchange(p_in, wb, mesh)
            if not bufs:
                bufs.extend(_each(lambda pad, g: minmax_cuda.VjpBuffers(
                    pad, *args, geom=g, name="minmax_step_block_vjp"),
                    pads, geoms))
            return _each(lambda pad, gpad, g, b: vjp(
                             pad, gpad, args[0], args[1], g, *args[2:],
                             bufs=b)[0],
                         pads, halo_exchange(gp, wb, mesh), geoms, bufs)

        zeros = _each(lambda b: torch.zeros((), dtype=torch.float64,
                                            device=b.device), blocks)
        gp = reverse.run_reverse(
            "minmax_fixed_sharded", ctx.fstep, bstep, list(blocks),
            _each(torch.Tensor.contiguous, gs), steps, ctx.traj)
        cdx = _each(lambda b: b.sums[0], bufs) or zeros
        ch = _each(lambda b: b.sums[1], bufs) or zeros
        ctx.traj = None
        zero = torch.zeros((), dtype=torch.float64)
        # band_radius and threshold enter through comparisons only
        return (reverse.scalar_cotangent(ctx.meta[0],
                                         _shard_order_sum(cdx, mesh)),
                reverse.scalar_cotangent(ctx.meta[1],
                                         _shard_order_sum(ch, mesh)),
                reverse.scalar_cotangent(ctx.meta[2], zero),
                reverse.scalar_cotangent(ctx.meta[3], zero), None, *gp)


class _Exchange(torch.autograd.Function):
    """:func:`~.halo.halo_exchange` as an autograd op on a shard list (None
    for another rank's block): the backward is its transpose,
    :func:`~.halo.halo_exchange_transpose`, in one process and across
    processes."""

    @staticmethod
    def forward(ctx, mesh, widths, *blocks):
        ctx.spec = (mesh, widths)
        return tuple(halo_exchange(list(blocks), widths, mesh))

    @staticmethod
    def backward(ctx, *gs):
        mesh, widths = ctx.spec
        cots = halo_exchange_transpose(
            [None if g is None else g.contiguous() for g in gs], widths,
            mesh)
        return (None, None, *cots)


def minmax_step_blocks_plain(blocks, dxs, h1s, *, gshape, mesh: ShardMesh,
                             band_radius=4.1, threshold=0.0,
                             avg_halfwidth=1) -> list:
    """One min/max step of every block with any average half-width, in the
    JAX package's jnp block form (``sharded.py:434-445``): a halo of
    ``max(1, avg_halfwidth)`` cells exchanged (:class:`_Exchange`,
    differentiable), the Laplacian and the average on the padded block,
    cropped; the update gated by the cell's own band and, as in the solo
    step, the global interior.  ``dxs`` and ``h1s``: the scalars, one per
    shard (:func:`~.mesh.replicate`).  Each owned cell is the solo
    :func:`~..solvers.minmax_flow.minmax_step`'s bitwise wherever the band
    stays off the global faces (there the solo step's average wraps around
    the grid and the halo holds zeros)."""
    widths = sharded_widths(mesh, max(1, int(avg_halfwidth)))
    pads = _Exchange.apply(mesh, widths, *blocks)
    offs = local_offsets(mesh, mesh.block_shape(gshape))

    def step(phi_l, pad, dx, h1, origin):
        pure, _ = second_derivative(pad, dx)
        curv = crop(pure.sum(dim=-1), widths)
        pave = crop(seven_point_average(pad, avg_halfwidth), widths)
        f = torch.where(pave < threshold, torch.clamp_max(curv, 0.0),
                        torch.clamp_min(curv, 0.0))
        gate = (torch.abs(phi_l) < band_radius * dx) & global_interior_mask(
            phi_l.shape, origin, gshape, 1, phi_l.device)
        return torch.where(gate, phi_l + h1 * f, phi_l)

    return _each(step, blocks, pads, dxs, h1s, offs)


def _per_shard(mesh: ShardMesh, x) -> list:
    """A scalar for every shard: a tensor replicated with a backward that
    adds the shards' cotangents in shard order (:func:`~.mesh.replicate`),
    a number as it is."""
    if isinstance(x, torch.Tensor):
        return replicate(mesh, x)
    return [x] * mesh.n_shards


def minmax_fixed_sharded(mesh: ShardMesh, blocks, dx, h1, steps: int, *,
                         band_radius=4.1, threshold=0.0,
                         avg_halfwidth=1) -> list:
    """``steps`` min/max steps of a sharded field, reverse-mode
    differentiable in the blocks and (as 0-d tensors) ``dx``, ``h1``,
    ``band_radius`` and ``threshold`` — the port of
    ``parallel/sharded.py:minmax_fixed_sharded``.  The default half-width:
    its fused-kernel route, K3's block mode forward, K6's block mode
    backward (gather form), each owned cell bitwise the solo
    :func:`~..solvers.minmax_flow.minmax_flow_fixed`'s; needs blocks of >= 2
    cells on the sharded axes.  Another half-width: its jnp route,
    :func:`minmax_step_blocks_plain` under autograd, each step
    checkpointed (``jax.checkpoint`` there; the exchange runs again in the
    backward), the scalars' cotangents added over the shards in shard
    order; needs blocks of at least the half-width on the sharded axes."""
    gshape = _global_shape(mesh, blocks)
    if avg_halfwidth != 1:
        w = max(1, int(avg_halfwidth))
        _check_block_sizes(mesh, gshape, w, "minmax_fixed_sharded")
        dxs, h1s = _per_shard(mesh, dx), _per_shard(mesh, h1)
        return reverse.remat_scan(lambda p: minmax_step_blocks_plain(
            p, dxs, h1s, gshape=gshape, mesh=mesh, band_radius=band_radius,
            threshold=threshold, avg_halfwidth=avg_halfwidth),
            list(blocks), steps)
    _check_block_sizes(mesh, gshape, weno_cuda.VJP_HALO["minmax"],
                       "minmax_fixed_sharded")
    return list(_MinmaxFixedSharded.apply(dx, h1, band_radius, threshold,
                                          (mesh, gshape, int(steps)),
                                          *blocks))


# ------------------------- sharded advection -------------------------

def advection_fields(mesh: ShardMesh, blocks, dx, *, order: int = 8,
                     stencil_radius: float = 8.1,
                     quirk_deriv8_y: bool = False):
    """What the sharded advection samples: per shard (None for another
    rank's) its block's phi and banded order-8 gradient as one
    ``(X, Y, Z, 4)`` field with a halo of one cell on the sharded axes,
    and its :class:`~..ops.advect_cuda.BlockSpec`.  The gradient comes
    from a periodic exchange of ``HALO`` cells, exactly as the
    single-device :func:`~..solvers.advect.banded_gradient` with its
    circular shifts."""
    from ..ops.band import narrow_band
    from ..ops.derivs import first_derivative
    b = next(tuple(x.shape) for x in blocks if x is not None)
    w4 = (HALO,) * 3

    def masked_gradient(phi_l, pad):
        g, _ = first_derivative(pad, dx, order=order,
                                quirk_deriv8_y=quirk_deriv8_y)
        _, sb = narrow_band(phi_l, dx, stencil_radius, stencil_radius)
        g = crop(g, w4)
        return torch.where(sb[..., None], g, torch.zeros_like(g))

    grads = _each(masked_gradient, blocks,
                  halo_exchange(blocks, w4, mesh, periodic=True))
    w1 = sharded_widths(mesh, 1)
    fields = _each(lambda p, g: torch.cat([p[..., None], g], dim=-1),
                   halo_exchange(blocks, w1, mesh),
                   halo_exchange(grads, w1, mesh))
    specs = [advect_cuda.BlockSpec(off, tuple(o + n for o, n in zip(off, b)),
                                   w1)
             for off in local_offsets(mesh, b)]
    return fields, specs


def advect_nodes_sharded(mesh: ShardMesh, blocks, grid, positions, dx,
                         iters: int = 1000, *, eps: float = 1e-13,
                         order: int = 8, stencil_radius: float = 8.1,
                         quirk_deriv8_y: bool = False):
    """Node advection with phi kept in blocks (set3d.f90:470-501): the
    O(grid) field is never gathered.  The node batch is small, so it is
    replicated: every shard sees all nodes each iteration, but a node's
    trilinear sample is computed only by the shard that owns its base cell
    ``i0`` (blocks partition the grid, so a node on a seam has exactly one
    owner; a halo of one cell covers the ``i0+1`` corner), and the shards'
    ``(n_nodes, 4)`` samples (phi, grad) are added in shard order, the
    others contributing zeros.

    Across processes each rank adds its own shards' samples, then one sum
    all-reduce per iteration adds the ranks' (``positions`` on every rank,
    on the rank's own device).  That is the one-process total bit for bit
    in any order: a node's owner adds its sample and every other shard
    +0.0, so each sum is exact (an all-gather of the per-shard samples
    would move ``world`` times the bytes for the same numbers).

    Float32 blocks on the card take K8's block mode
    (:mod:`~..ops.advect_cuda`): in one process every iteration in one
    launch per card (:func:`~..ops.advect_cuda.advect_blocks`, nodes
    handed between cards only where they cross a seam between them);
    across processes one launch per shard and iteration
    (:func:`~..ops.advect_cuda.sample_block`) before the all-reduce.  CPU,
    bfloat16 and float64 blocks run the plain loop
    (:func:`~..ops.advect_cuda.sample_block_plain` per shard and
    iteration).  Every route is bitwise the plain loop's.  The nodes
    sample the fields of :func:`advection_fields`."""
    from ..solvers.advect import AdvectResult
    fields, specs = advection_fields(mesh, blocks, dx, order=order,
                                     stencil_radius=stencil_radius,
                                     quirk_deriv8_y=quirk_deriv8_y)
    mine = [(f, sp) for f, sp in zip(fields, specs) if f is not None]
    home = positions.device
    kernel = all(advect_cuda.takes_kernel(f) for f, _ in mine)
    if kernel and not mesh.spans_processes:
        x, p = advect_cuda.advect_blocks(
            [f for f, _ in mine], [sp for _, sp in mine], grid, positions,
            iters, eps, zero_sign=mesh.n_shards > 1)
        return AdvectResult(positions=x, phi_surf=p)

    if kernel:
        tables = [advect_cuda.block_table([f], [sp], f.device)
                  for f, sp in mine]

        def sample_one(n, f, sp, x):
            return advect_cuda.sample_block(f, sp, grid, x, tables[n])
    else:
        consts = [advect_cuda.block_consts(f, sp, grid, positions.dtype)
                  for f, sp in mine]

        def sample_one(n, f, sp, x):
            return advect_cuda.sample_block_plain(f, sp, grid, x, consts[n])

    def sample(x):
        total = None
        for n, (f, sp) in enumerate(mine):
            s = sample_one(n, f, sp, x).to(home)
            total = s if total is None else total + s
        if mesh.spans_processes:
            buf = total.to(comm_device(total))
            dist.all_reduce(buf)
            total = buf.to(home)
        return total

    x = positions
    for _ in range(iters):
        x = advect_cuda.move(x, sample(x), eps)
    return AdvectResult(positions=x, phi_surf=sample(x)[:, 0])


# ------------------------------ dry run ------------------------------

def _dryrun_field(gshape, device) -> torch.Tensor:
    """The JAX dry run's distorted sphere: ``2 (|x| - 0.5)`` on
    ``linspace(-1, 1)`` points, float32."""
    axes = [torch.linspace(-1.0, 1.0, g, dtype=torch.float32) for g in gshape]
    gx, gy, gz = torch.meshgrid(*axes, indexing="ij")
    return (2.0 * (torch.sqrt(gx ** 2 + gy ** 2 + gz ** 2) - 0.5)).to(device)


def _finite(what, *values) -> None:
    for v in values:
        ok = (math.isfinite(v) if isinstance(v, float)
              else all(bool(torch.isfinite(t).all()) for t in v))
        if not ok:
            raise RuntimeError(f"dryrun: {what} is not finite")


def dryrun(n_devices: int, device="cuda") -> None:
    """Run every sharded path once on tiny shapes over an ``n_devices``-shard
    mesh, in one process (``parallel/sharded.py:1370-1466`` of the JAX
    package, check by check): the sharded reinit and min/max, two steps per
    exchange, the overlapped step, the auto mesh, a gradient through a
    one-step sharded reinit, the sharded reverse on the kernels, and the
    banded sharded reverse.  Raises when a result is not finite.

    The shards go round-robin over the visible devices of ``device``'s
    type (:func:`~.mesh.default_devices`): with fewer cards than shards
    several share a card, where the JAX package falls back to CPU devices;
    there is no fall back to the CPU here.  JAX's check that the auto mesh
    keeps z whole (``(a, b, 1)``, for its TPU kernel) is left out: the CUDA
    kernels keep no axis whole, so the auto mesh is the balanced one."""
    visible = default_devices(device)
    devs = [visible[i % len(visible)] for i in range(int(n_devices))]
    mesh_shape = factor3(len(devs))
    mesh = make_mesh(mesh_shape, devs)
    gshape = tuple(max(16, 2 * m) for m in mesh_shape)
    dx = 0.1
    h = 0.1 * dx
    phi0 = _dryrun_field(gshape, devs[0])

    # the sharded reinit (global RMS) and a min/max step
    solver = ShardedLevelSet(mesh, gshape, dx)
    phi, _, rms = solver.reinit(solver.device_put(phi0), h, 3, 0.0)
    phi, _, rms2 = solver.minmax_flow(phi, 0.01 * dx, 2, 0.0)
    _finite("the sharded reinit and min/max", rms, rms2, phi)

    # halo-deep pipelining: two local steps per exchange of 6 cells
    solver2 = ShardedLevelSet(mesh, gshape, dx, steps_per_exchange=2)
    phi2, _, rms3 = solver2.reinit(solver2.device_put(phi0), h, 4, 0.0)
    _finite("two steps per exchange", rms3, phi2)

    # the exchange overlapped with the interior launch, on blocks of 24
    # along the sharded axes (the least that holds interior bricks)
    g_ov = tuple(24 * m if m > 1 else 16 for m in mesh_shape)
    solver_ov = ShardedLevelSet(mesh, g_ov, dx, overlap=True)
    if solver_ov.use_overlap != (max(mesh_shape) > 1):
        raise RuntimeError("dryrun: the overlapped step did not engage")
    phi_ov, _, rms_ov = solver_ov.reinit(
        solver_ov.device_put(_dryrun_field(g_ov, devs[0])), h, 2, 0.0)
    _finite("the overlapped step", rms_ov, phi_ov)

    # the auto mesh (one shard per device, balanced)
    mesh2 = ShardedLevelSet.auto_mesh(devs)
    g2 = (16 * max(1, len(devs) // 2), 32, 16)
    p2 = _dryrun_field(g2, devs[0])
    solver3 = ShardedLevelSet(mesh2, g2, dx)
    phi3, _, rms4 = solver3.reinit(solver3.device_put(p2), h, 2, 0.0)
    _finite("the auto mesh", rms4, phi3)

    def grad_of(step_fn, blocks):
        blocks = [b.detach().requires_grad_() for b in blocks]
        out = step_fn(blocks)
        loss = sum((o * o).sum().double().to(devs[0]) for o in out)
        return torch.autograd.grad(loss, blocks)

    # a gradient through one sharded reinit step (K1 block forward, K5
    # block backward)
    g = grad_of(lambda b: reinit_fixed_sharded(mesh, b, dx, h, 1),
                solver.device_put(phi0))
    _finite("the gradient through a sharded reinit step", g)

    # the sharded reverse on the auto mesh, and its banded form
    gf = grad_of(lambda b: reinit_fixed_sharded(mesh2, b, dx, h, 1),
                 solver3.device_put(p2))
    _finite("the sharded reverse", gf)
    gb = grad_of(lambda b: reinit_fixed_sharded(
        mesh2, b, dx, h, 2, band_radius=4.1, refresh_every=2),
        solver3.device_put(p2))
    _finite("the banded sharded reverse", gb)
