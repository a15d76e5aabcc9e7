"""Kernels K3 (one min/max step), K4 (K fused min/max steps) and K6 (the
VJP of one step) with their plain PyTorch versions.

K3 (``csrc/minmax_step.cu``) replaces
``levelsetfortran_tpu/ops/minmax_pallas.py:minmax_step_padded`` and K4
replaces ``minmax_fusedk_padded``.  One step: the 6-neighbour sum feeds the
Laplacian proxy and the 7-point average, F = min(lap, 0) where the average
is below the threshold else max(lap, 0), and phi += h1 F where
|phi| < band_radius dx on the interior.  What bounds them on the H100 is
bytes (~15 operations per cell against 8 bytes of traffic): K3 marches a
column of cells along x, its planes prefetched into a shared ring; K4
walks the same way for K steps at once.  Face rule: face
cells never update and an interior cell's +-1 reads never leave the grid,
so the port neither wraps (jnp path) nor clamps (TPU kernel).  K3's pack
mode (:func:`minmax_step_packed`) steps B same-shape geometries per launch,
each with its own h1 and sum, as ``minmax_step_padded(pack=B)`` does.

K3's block mode (:func:`minmax_step_block`) is the kernel's ``offsets``
argument: one shard's block with a halo of one neighbour cell, the face rule
and the fused sum's box in global coordinates.

K6 (``csrc/minmax_bwd.cu``) replaces ``minmax_pallas.py:minmax_bwd_padded``:
the gather-form adjoint on K3's march, each cell's Laplacian cotangent
evaluated once and gathered by its six neighbours, the two float64 sums
finished in the same launch; its banded mode
(:func:`minmax_step_vjp_banded`) passes frozen bricks through, its block
mode (:func:`minmax_step_block_vjp`) gathers one shard's owned cells from a
2-cell halo.  A backward solve passes :class:`VjpBuffers`, which also add
the scalar cotangents up on the device.  :func:`minmax_scan` is the differentiable fixed-step scan,
dense or banded (bitwise the same values and gradients).

The wrappers run the plain version only for a CPU tensor; for a CUDA tensor
they launch the kernel or raise.  A solver passes ``bufs``
(:func:`..weno_cuda.solve_buffers`) so that its launches reuse one set of
sum buffers, the stream and the device; the scalars are rounded once per
distinct input.  K4 is bitwise equal to K launches of K3
(one shared cell update, built with ``--fmad=false``).
"""

from __future__ import annotations

import functools
import types
from typing import Optional

import torch

from .. import cuda_build
from . import reverse
from .stencil import global_interior_mask, interior_mask, shift
from .weno_cuda import (VJP_HALO, BlockGeom, SolveBuffers, _sum_args,
                        _tickets,
                        box_cells, brick_cells, brick_grid,
                        check_adjoint_geom, check_block, check_cuda,
                        check_inputs, check_packed, chunk_lengths,
                        finish_block_plain, finish_plain, live_vector,
                        np_dtype, on_device, owned_slices, packed_vector,
                        ptr, rms_buffers, run_packed_plain, tile_activity)


def minmax_scalars(dtype, dx, h1, band_radius, threshold):
    """Scalar constants rounded once in ``dtype``, as the TPU kernel forms
    them from its f32 scalar inputs; cached by the inputs, so a solve's
    launches round them once (a read-only mapping)."""
    return _minmax_scalars(dtype, float(dx), float(h1), float(band_radius),
                           float(threshold))


@functools.lru_cache(maxsize=256)
def _minmax_scalars(dtype, dx, h1, band_radius, threshold):
    t = np_dtype(dtype)
    dxv = t(dx)
    return types.MappingProxyType(dict(
        dx=float(dxv), h1=float(t(h1)), inv_dx2=float(t(1) / (dxv * dxv)),
        band_dx=float(t(band_radius) * dxv), threshold=float(t(threshold))))


def _dense_step(phi, sc, interior=None):
    """One dense min/max step in whole-grid tensor ops; ``interior``: the
    cells that may update (default: all but ``phi``'s own faces)."""
    sum6 = (shift(phi, 0, -1) + shift(phi, 0, 1) + shift(phi, 1, -1)
            + shift(phi, 1, 1) + shift(phi, 2, 1) + shift(phi, 2, -1))
    lap = (sum6 - 6.0 * phi) * sc["inv_dx2"]
    pave = (sum6 + phi) * (1.0 / 7.0)
    f = torch.where(pave < sc["threshold"], torch.clamp_max(lap, 0.0),
                    torch.clamp_min(lap, 0.0))
    if interior is None:
        interior = interior_mask(phi.shape, 1, phi.device)
    gate = interior & (torch.abs(phi) < sc["band_dx"])
    return torch.where(gate, phi + sc["h1"] * f, phi)


def minmax_fusedk_plain(phi, dx, h1, band_radius=4.1, threshold=0.0, *,
                        ksteps, active=None, out=None, mint=True,
                        with_rms=False):
    """The plain version of :func:`minmax_fusedk` (same arguments, any
    dtype, any device): ``ksteps`` dense steps, then the banded write; the
    sum of squared changes is the last step's."""
    sc = minmax_scalars(phi.dtype, dx, h1, band_radius, threshold)
    prev, new = phi, phi
    for _ in range(ksteps):
        prev, new = new, _dense_step(new, sc)
    if active is not None:
        cells = brick_cells(active, phi.shape)
        keep = phi if mint else out
        new = torch.where(cells, new, keep)
        prev = torch.where(cells, prev, keep)
    return finish_plain(new, phi, out, with_rms, base=prev)


def minmax_step_plain(phi, dx, h1, band_radius=4.1, threshold=0.0, *,
                      active=None, out=None, mint=True, with_rms=False):
    """The plain version of :func:`minmax_step`."""
    return minmax_fusedk_plain(phi, dx, h1, band_radius, threshold,
                               ksteps=1, active=active, out=out, mint=mint,
                               with_rms=with_rms)


def minmax_step(phi, dx, h1, band_radius=4.1, threshold=0.0, *,
                active=None, out=None, mint=True, with_rms=False,
                bufs: Optional[SolveBuffers] = None):
    """One min/max step of ``phi`` into ``out`` (K3).  ``active``/``mint``
    as in :func:`..weno_cuda.reinit_step`; ``with_rms`` adds the float64
    sum of squared changes; ``bufs`` (:func:`..weno_cuda.solve_buffers` of
    ``phi``): a solve's reused device, stream and sum buffers."""
    if phi.device.type == "cpu":
        return minmax_step_plain(phi, dx, h1, band_radius, threshold,
                                 active=active, out=out, mint=mint,
                                 with_rms=with_rms)
    if out is None:
        out = torch.empty_like(phi)
    check_cuda("minmax_step", phi, out, active)
    sc = minmax_scalars(phi.dtype, dx, h1, band_radius, threshold)
    partials, dsq, tickets, stream = _sum_args("minmax_step", phi, with_rms,
                                               bufs)
    with on_device(phi.device):
        cuda_build.launch(
            "lsf_minmax_step_f32", phi.data_ptr(), out.data_ptr(),
            *phi.shape, sc["h1"], sc["inv_dx2"], sc["band_dx"],
            sc["threshold"], ptr(active), int(mint), ptr(partials),
            ptr(dsq), ptr(tickets), stream)
    minmax_step.launches += 1
    return (out, dsq) if with_rms else out


minmax_step.launches = 0


def minmax_step_block_plain(pad, dx, h1, geom: BlockGeom, band_radius=4.1,
                            threshold=0.0, *, active=None, out=None,
                            with_rms=False):
    """The plain version of :func:`minmax_step_block` (any dtype, any
    device): the solo plain step with the face rule in global coordinates
    (``parallel/sharded.py:434-445`` of the JAX package), on the cells the
    kernel's brick grid covers."""
    sc = minmax_scalars(pad.dtype, dx, h1, band_radius, threshold)
    shape, dev = pad.shape, pad.device
    interior = (global_interior_mask(shape, geom.origin, geom.gshape, 1, dev)
                & interior_mask(shape, 1, dev))
    new = _dense_step(pad, sc, interior)
    ones = torch.ones(geom.bricks(shape), dtype=torch.int32, device=dev)
    written = brick_cells(ones, shape, geom.brick_origin)
    if active is not None:
        new = torch.where(brick_cells(active, shape, geom.brick_origin), new,
                          pad)
    return finish_block_plain(new, written, pad, out, with_rms, geom)


def minmax_step_block(pad, dx, h1, geom: BlockGeom, band_radius=4.1,
                      threshold=0.0, *, active=None, out=None,
                      with_rms=False):
    """One min/max step of one shard's padded block (K3's block mode):
    ``pad`` holds the owned cells and a halo of one neighbour cell on the
    sharded axes, ``geom`` places it in the global grid and lays the brick
    grid over the owned cells.  Cells the brick grid covers are written
    into ``out`` (a copy of ``pad`` when None); bricks with ``active == 0``
    copy.  ``with_rms`` adds the float64 sum over ``geom``'s box."""
    if pad.device.type == "cpu":
        return minmax_step_block_plain(pad, dx, h1, geom, band_radius,
                                       threshold, active=active, out=out,
                                       with_rms=with_rms)
    if out is None:
        out = pad.clone()
    check_block("minmax_step_block", pad, out, active, geom)
    sc = minmax_scalars(pad.dtype, dx, h1, band_radius, threshold)
    partials, dsq, tickets, stream = _sum_args(
        "minmax_step_block", pad, with_rms, None, geom=geom)
    with on_device(pad.device):
        cuda_build.launch(
            "lsf_minmax_step_block_f32", pad.data_ptr(), out.data_ptr(),
            *pad.shape, geom.ints(pad.shape), sc["h1"], sc["inv_dx2"],
            sc["band_dx"], sc["threshold"], ptr(active), ptr(partials),
            ptr(dsq), ptr(tickets), stream)
    minmax_step_block.launches += 1
    return (out, dsq) if with_rms else out


minmax_step_block.launches = 0


def minmax_fusedk(phi, dx, h1, band_radius=4.1, threshold=0.0, *, ksteps,
                  active=None, out=None, mint=True, with_rms=False):
    """``ksteps`` (1..4) fused min/max steps (K4).  ``with_rms`` gives the
    LAST inner step's sum of squared changes."""
    if not 1 <= ksteps <= 4:
        raise ValueError(f"ksteps must be 1..4, got {ksteps}")
    if phi.device.type == "cpu":
        return minmax_fusedk_plain(phi, dx, h1, band_radius, threshold,
                                   ksteps=ksteps, active=active, out=out,
                                   mint=mint, with_rms=with_rms)
    if out is None:
        out = torch.empty_like(phi)
    check_cuda("minmax_fusedk", phi, out, active)
    sc = minmax_scalars(phi.dtype, dx, h1, band_radius, threshold)
    partials, dsq = rms_buffers(phi, with_rms)
    with on_device(phi.device):
        cuda_build.launch(
            "lsf_minmax_fusedk_f32", phi.data_ptr(), out.data_ptr(),
            *phi.shape, sc["h1"], sc["inv_dx2"], sc["band_dx"],
            sc["threshold"], int(ksteps), ptr(active), int(mint),
            ptr(partials), ptr(dsq),
            torch.cuda.current_stream(phi.device).cuda_stream)
    minmax_fusedk.launches += 1
    return (out, dsq) if with_rms else out


minmax_fusedk.launches = 0


def minmax_step_packed_plain(phi, dx, h1, live, band_radius=4.1,
                             threshold=0.0, *, out=None, with_rms=False):
    """The plain version of :func:`minmax_step_packed` (any dtype, any
    device): the solo plain step per live geometry."""
    hv = packed_vector(h1, phi.shape[0], phi.dtype, "cpu").tolist()
    return run_packed_plain(phi, out, live, with_rms, lambda g, o, rms: (
        minmax_step_plain(phi[g], dx, hv[g], band_radius, threshold, out=o,
                          with_rms=rms)))


def minmax_step_packed(phi, dx, h1, live, band_radius=4.1, threshold=0.0, *,
                       out=None, with_rms=False,
                       bufs: Optional[SolveBuffers] = None):
    """One dense min/max step of each of B same-shape geometries in ONE
    launch (K3's pack mode; replaces ``minmax_step_padded(pack=B)``).
    ``h1`` per geometry and ``live`` as in
    :func:`..weno_cuda.reinit_step_packed`; each live geometry equals a solo
    :func:`minmax_step` with its h1 bitwise, a frozen one is copied.
    ``bufs``: :func:`..weno_cuda.solve_buffers` of ``phi`` with
    ``packed=True``."""
    if phi.device.type == "cpu":
        return minmax_step_packed_plain(phi, dx, h1, live, band_radius,
                                        threshold, out=out,
                                        with_rms=with_rms)
    if out is None:
        out = torch.empty_like(phi)
    check_packed("minmax_step_packed", phi, out)
    b = phi.shape[0]
    hv = packed_vector(h1, b, phi.dtype, phi.device)
    lv = live_vector(live, b, phi.device)
    sc = minmax_scalars(phi.dtype, dx, 0.0, band_radius, threshold)
    partials, dsq, tickets, stream = _sum_args(
        "minmax_step_packed", phi, with_rms, bufs, packed=True)
    with on_device(phi.device):
        cuda_build.launch(
            "lsf_minmax_step_packed_f32", phi.data_ptr(), out.data_ptr(),
            *phi.shape, hv.data_ptr(), sc["inv_dx2"], sc["band_dx"],
            sc["threshold"], lv.data_ptr(), ptr(partials), ptr(dsq),
            ptr(tickets), stream)
    minmax_step_packed.launches += 1
    return (out, dsq) if with_rms else out


minmax_step_packed.launches = 0


def _vjp_cells(phi, g, sc, origin, gshape, live, owned):
    """The gather-form VJP of one step on an array whose cell 0 lies at
    global ``origin`` of a ``gshape`` grid (the face rule in global
    coordinates); ``live``: the cells of active bricks, which gather (None:
    all; the others pass ``g`` through), ``owned``: the cells the sums
    count.  Returns the array-shaped ``cot_phi`` (right where the
    neighbours lie in the array) and the per-cell terms of the two sums,
    ``cot_lap * lap`` and ``F g`` (0 where not counted)."""
    sum6 = (shift(phi, 0, -1) + shift(phi, 0, 1) + shift(phi, 1, -1)
            + shift(phi, 1, 1) + shift(phi, 2, 1) + shift(phi, 2, -1))
    lap = (sum6 - 6.0 * phi) * sc["inv_dx2"]
    sel_min = (sum6 + phi) * (1.0 / 7.0) < sc["threshold"]
    f = torch.where(sel_min, torch.clamp_max(lap, 0.0),
                    torch.clamp_min(lap, 0.0))
    gate = (global_interior_mask(phi.shape, origin, gshape, 1, phi.device)
            & (torch.abs(phi) < sc["band_dx"]))
    zero = torch.zeros_like(phi)
    tie = torch.where(lap == 0.0, 0.5 + zero, zero)
    dlap = torch.where(sel_min, torch.where(lap < 0.0, 1.0 + zero, tie),
                       torch.where(lap > 0.0, 1.0 + zero, tie))
    cot_lap = torch.where(gate, sc["h1"] * g, zero) * dlap
    cs6 = cot_lap * sc["inv_dx2"]
    cot_phi = (g - (6.0 * sc["inv_dx2"]) * cot_lap
               + shift(cs6, 0, 1) + shift(cs6, 0, -1) + shift(cs6, 1, 1)
               + shift(cs6, 1, -1) + shift(cs6, 2, -1) + shift(cs6, 2, 1))
    counted = gate
    if live is not None:
        cot_phi = torch.where(live, cot_phi, g + 0.0)
        counted = counted & live
    if owned is not None:
        counted = counted & owned
    return (cot_phi, torch.where(counted, cot_lap * lap, zero),
            torch.where(counted, f * g, zero))


def _vjp_plain(phi, g, sc, origin, gshape, live, owned):
    """:func:`_vjp_cells` with the sums: ``(cot_phi, cot_dx, cot_h1)``."""
    cot_phi, tdx, th = _vjp_cells(phi, g, sc, origin, gshape, live, owned)
    return (cot_phi, (-2.0 / sc["dx"]) * tdx.double().sum(),
            th.double().sum())


def minmax_step_vjp_plain(phi, g, dx, h1, band_radius=4.1, threshold=0.0, *,
                          active=None):
    """The plain version of :func:`minmax_step_vjp` and, with ``active``, of
    :func:`minmax_step_vjp_banded` (any dtype, any device), the gather-form
    adjoint of ``minmax_pallas._make_bwd_kernel`` (:742-757):
    ``cot_phi = g - 6/dx^2 cot_lap + gather_6(cot_lap / dx^2)`` with
    ``d min(lap, 0)/d lap`` = 1, 0.5 at ``lap == 0``, else 0 (JAX's
    convention for ``lax.min``; ``torch.clamp`` would give 1 at the tie);
    an inactive brick passes ``g`` through."""
    sc = minmax_scalars(phi.dtype, dx, h1, band_radius, threshold)
    live = None if active is None else brick_cells(active, phi.shape)
    return _vjp_plain(phi, g, sc, (0, 0, 0), tuple(phi.shape), live, None)


class VjpBuffers:
    """What K6's wrappers resolve once per backward solve and reuse in each
    of its launches, as K3's :class:`..weno_cuda.SolveBuffers`: the scalars
    rounded once, the block record (``geom``), the brick grid and the owned
    box, the device and its current stream, the float64 partials and the
    ticket counter; and ``sums``, the solve's running ``(cot_dx, cot_h1)``
    (float64, zero at first): each launch adds its two scalar cotangents
    into them on the device, as a caller adds each step's to its total
    (``total + step``, in launch order).  For a CPU tensor only ``sums``
    (the plain versions add into it).  ``running=False``: one launch's own
    sums, written, not added (a call without buffers)."""

    def __init__(self, phi, dx, h1, band_radius=4.1, threshold=0.0, *,
                 geom: Optional[BlockGeom] = None, name="minmax_step_vjp",
                 running=True):
        self.args = (dx, h1, band_radius, threshold)
        self.geom, self.shape, self.device = geom, tuple(phi.shape), \
            phi.device
        if geom is None:
            self.nb, self.owned = brick_grid(phi.shape), self.shape
        else:
            check_adjoint_geom(name, phi.shape, geom, VJP_HALO["minmax"], 0)
            self.nb = geom.bricks(phi.shape)
            self.owned = tuple(s.stop - s.start for s in owned_slices(geom))
        self.sc = sc = minmax_scalars(phi.dtype, dx, h1, band_radius,
                                      threshold)
        make = torch.zeros if running else torch.empty
        self.sums = make(2, dtype=torch.float64, device=phi.device)
        if phi.device.type != "cuda":
            return
        self.scal = (sc["h1"], sc["inv_dx2"], sc["band_dx"], sc["threshold"])
        self.scale = -2.0 / sc["dx"]
        self.ints = None if geom is None else geom.ints(self.shape)
        self.stream = torch.cuda.current_stream(phi.device).cuda_stream
        self.partials = torch.empty(2 * self.nb[0] * self.nb[1] * self.nb[2],
                                    dtype=torch.float64, device=phi.device)
        self.tickets = _tickets(phi.device, self.stream, 1)

    def check(self, name, phi, args, geom):
        """Raise unless this launch is the one the buffers were made for."""
        if (self.shape != tuple(phi.shape) or self.device != phi.device
                or self.args != args
                or (self.geom is not geom and self.geom != geom)):
            raise ValueError(f"{name}: the buffers are for another grid, "
                             f"device, geometry or scalars")


def _with_bufs(name, phi, args, geom, bufs, plain):
    """A plain VJP's result (``plain()``), its sums added into ``bufs``
    when given."""
    if bufs is None:
        return plain()
    bufs.check(name, phi, args, geom)
    res = plain()
    bufs.sums += torch.stack(res[1:])
    return res[0], None, None


def _minmax_vjp_cuda(name, phi, g, dx, h1, band_radius, threshold, geom,
                     active, bufs):
    """Launch K6 on a solo grid (``geom`` None) or on one shard's padded
    block; ``cot_phi`` has the owned box's shape.  With ``bufs`` the scalar
    cotangents go into ``bufs.sums`` and None takes their place."""
    args = (dx, h1, band_radius, threshold)
    if bufs is None:
        nb = brick_grid(phi.shape) if geom is None else geom.bricks(phi.shape)
        check_inputs(name, phi, (g,), active, nb)
        b = VjpBuffers(phi, *args, geom=geom, name=name, running=False)
    else:
        bufs.check(name, phi, args, geom)
        check_inputs(name, phi, (g,), active, bufs.nb)
        b = bufs
    cot_phi = torch.empty(b.owned, dtype=phi.dtype, device=phi.device)
    with on_device(phi.device):
        if geom is None:
            cuda_build.launch(
                "lsf_minmax_bwd_f32", phi.data_ptr(), g.data_ptr(),
                cot_phi.data_ptr(), *b.shape, *b.scal, ptr(active),
                b.partials.data_ptr(), b.sums.data_ptr(),
                b.tickets.data_ptr(), int(bufs is not None), b.scale,
                b.stream)
        else:
            cuda_build.launch(
                "lsf_minmax_bwd_block_f32", phi.data_ptr(), g.data_ptr(),
                cot_phi.data_ptr(), *b.shape, b.ints, *b.scal,
                b.partials.data_ptr(), b.sums.data_ptr(),
                b.tickets.data_ptr(), int(bufs is not None), b.scale,
                b.stream)
    if bufs is not None:
        return cot_phi, None, None
    return cot_phi, b.sums[0], b.sums[1]


def minmax_step_vjp(phi, g, dx, h1, band_radius=4.1, threshold=0.0, *,
                    bufs: Optional[VjpBuffers] = None):
    """VJP of the dense :func:`minmax_step` at ``(phi, dx, h1)`` for the
    output cotangent ``g`` (kernel K6, ``csrc/minmax_bwd.cu``).

    Returns ``(cot_phi, cot_dx, cot_h1)``, the scalars as float64 0-d
    tensors; ``band_radius`` and ``threshold`` enter through comparisons
    only, so their cotangents are exactly zero (``minmax_pallas.py:1116``)
    and are not returned.  ``bufs`` (:class:`VjpBuffers` of ``phi`` and the
    same scalars): a backward solve's reused state; the scalar cotangents
    are then added into ``bufs.sums`` and returned as None."""
    if phi.device.type == "cpu":
        return _with_bufs(
            "minmax_step_vjp", phi, (dx, h1, band_radius, threshold), None,
            bufs, lambda: minmax_step_vjp_plain(phi, g, dx, h1, band_radius,
                                                threshold))
    res = _minmax_vjp_cuda("minmax_step_vjp", phi, g, dx, h1, band_radius,
                           threshold, None, None, bufs)
    minmax_step_vjp.launches += 1
    return res


minmax_step_vjp.launches = 0


def minmax_step_vjp_banded(phi, g, dx, h1, active, band_radius=4.1,
                           threshold=0.0, *,
                           bufs: Optional[VjpBuffers] = None):
    """K6's banded mode (the TPU kernel's ``active``): bricks with
    ``active == 0`` pass ``g`` through.  With the ``band4`` mask of the
    chunk-start iterate of a banded min/max solve it equals
    :func:`minmax_step_vjp` bitwise (no cell within 4 of a frozen brick
    updates in the chunk).  Returns what :func:`minmax_step_vjp` returns;
    ``bufs`` as there."""
    if phi.device.type == "cpu":
        return _with_bufs(
            "minmax_step_vjp_banded", phi, (dx, h1, band_radius, threshold),
            None, bufs, lambda: minmax_step_vjp_plain(
                phi, g, dx, h1, band_radius, threshold, active=active))
    res = _minmax_vjp_cuda("minmax_step_vjp_banded", phi, g, dx, h1,
                           band_radius, threshold, None, active, bufs)
    minmax_step_vjp_banded.launches += 1
    return res


minmax_step_vjp_banded.launches = 0


def minmax_step_block_vjp_plain(pad, g_pad, dx, h1, geom: BlockGeom,
                                band_radius=4.1, threshold=0.0):
    """The plain version of :func:`minmax_step_block_vjp` (any dtype, any
    device): the solo plain VJP with the face rule in global coordinates,
    cropped to the owned box; the sums count the owned cells."""
    check_adjoint_geom("minmax_step_block_vjp", pad.shape, geom,
                       VJP_HALO["minmax"], 0)
    sc = minmax_scalars(pad.dtype, dx, h1, band_radius, threshold)
    cot_phi, cdx, ch = _vjp_plain(pad, g_pad, sc, geom.origin, geom.gshape,
                                  None, box_cells(geom, pad.shape,
                                                   pad.device))
    return cot_phi[owned_slices(geom)].contiguous(), cdx, ch


def minmax_step_block_vjp(pad, g_pad, dx, h1, geom: BlockGeom,
                          band_radius=4.1, threshold=0.0, *,
                          bufs: Optional[VjpBuffers] = None):
    """VJP of one block-mode min/max step at one shard's padded block (K6's
    block mode, the TPU kernel's ``offsets``), in gather form: ``pad`` and
    the exchanged upstream cotangent ``g_pad`` hold the owned box and
    ``VJP_HALO["minmax"]`` cells around it, ``geom`` places the array and
    lays the brick grid over the owned box.  Returns ``(cot_phi, cot_dx,
    cot_h1)`` for the owned cells, each cell bitwise the solo kernel's;
    ``bufs`` (:class:`VjpBuffers` of ``pad`` with ``geom``) as in
    :func:`minmax_step_vjp`."""
    if pad.device.type == "cpu":
        return _with_bufs(
            "minmax_step_block_vjp", pad, (dx, h1, band_radius, threshold),
            geom, bufs, lambda: minmax_step_block_vjp_plain(
                pad, g_pad, dx, h1, geom, band_radius, threshold))
    res = _minmax_vjp_cuda("minmax_step_block_vjp", pad, g_pad, dx, h1,
                           band_radius, threshold, geom, None, bufs)
    minmax_step_block_vjp.launches += 1
    return res


minmax_step_block_vjp.launches = 0


# ---------------------- differentiable fixed-step scan ----------------------

class _MinmaxScanBanded(torch.autograd.Function):
    """``steps`` min/max steps with bricks skipped in both sweeps
    (``minmax_pallas.py:_banded_scan_mm``): forward chunks step with the
    ``owned`` mask of the chunk-start iterate (exact: a cell updates only
    when its own value is in band), the backward recomputes each chunk's
    trajectory and runs K6's banded mode with the ``band4`` mask of the same
    iterate.  Values and gradients equal the dense solve's bitwise."""

    @staticmethod
    def forward(ctx, phi0, dx, h1, band_radius, threshold, steps,
                refresh_every):
        args = (float(dx), float(h1), float(band_radius), float(threshold))
        ctx.chunks = chunk_lengths(steps, refresh_every)
        ctx.starts = []
        p = phi0
        for n in ctx.chunks:
            ctx.starts.append(p)
            active = tile_activity(p, args[0], args[2], window="owned")
            for _ in range(n):
                p = minmax_step(p, *args, active=active)
        ctx.args = args
        ctx.meta = tuple(reverse.scalar_meta(x)
                         for x in (dx, h1, band_radius, threshold))
        return p if ctx.chunks else phi0.clone()

    @staticmethod
    def backward(ctx, g):
        args = ctx.args
        zero = torch.zeros((), dtype=torch.float64, device=g.device)
        gp = g.contiguous()
        bufs = VjpBuffers(gp, *args)
        for p, n in zip(reversed(ctx.starts), reversed(ctx.chunks)):
            act_f = tile_activity(p, args[0], args[2], window="owned")
            act_b = tile_activity(p, args[0], args[2], window="band4")
            traj = [p]
            for _ in range(n - 1):
                traj.append(minmax_step(traj[-1], *args, active=act_f))
            for p_in in reversed(traj):
                gp = minmax_step_vjp_banded(p_in, gp, args[0], args[1],
                                            act_b, *args[2:], bufs=bufs)[0]
        cdx, ch = bufs.sums[0], bufs.sums[1]
        ctx.starts = None
        # band_radius and threshold enter through comparisons only
        return (gp, reverse.scalar_cotangent(ctx.meta[0], cdx),
                reverse.scalar_cotangent(ctx.meta[1], ch),
                reverse.scalar_cotangent(ctx.meta[2], zero),
                reverse.scalar_cotangent(ctx.meta[3], zero), None, None)


def minmax_scan(phi0, dx, h1, steps: int, *, band_radius=4.1, threshold=0.0,
                banded=False, refresh_every: int = 16):
    """``steps`` min/max steps, reverse-mode differentiable — the port of
    ``minmax_pallas.py:minmax_scan_pallas``.  Dense: the fixed-step solver
    :func:`..solvers.minmax_flow.minmax_flow_fixed` (K3 forward, K6
    backward).  ``banded=True``: the same values and gradients, with
    frozen bricks skipped in both sweeps (:class:`_MinmaxScanBanded`, the
    banded modes of K3 and K6), the masks refreshed every
    ``refresh_every`` steps."""
    if not banded:
        from ..solvers.minmax_flow import minmax_flow_fixed
        return minmax_flow_fixed(phi0, dx, h1, steps,
                                 band_radius=band_radius, threshold=threshold)
    return _MinmaxScanBanded.apply(phi0, dx, h1, band_radius, threshold,
                                   int(steps), int(refresh_every))
