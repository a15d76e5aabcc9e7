"""Kernels K1 — the fused reinitialization step — and K5 — its VJP — with
their plain PyTorch versions, and the narrow-band brick activity mask.

K1 (``csrc/reinit_step.cu``) replaces the TPU kernel
``levelsetfortran_tpu/ops/weno_pallas.py:_pallas_step_padded``: one Jacobi
step of ``phi_t = sgn(phi_0)(1 - |grad phi|)`` — HJ-WENO5 + Godunov on raw
differences, smeared sign, interior Euler update, ghost BC read after the
update — plus the fused sum of squared cell changes and the banded
``active``/``carry`` modes.  What bounds it on the H100 is arithmetic
(~400 float operations with 13 IEEE divisions per cell against 12 bytes of
unique traffic); the kernel keeps every intermediate in registers, one
thread per cell in 8^3-cell bricks whose stencil re-reads hit L1, and skips
inactive bricks.  The TPU layout (x/y aprons, 128-lane z padding) is not
ported: the tensor is the unpadded ``(nx, ny, nz)`` grid and every mask is
in global coordinates.

K1's pack mode (:func:`reinit_step_packed`) replaces the TPU kernel's
``pack`` argument: B same-shape geometries ``(B, nx, ny, nz)`` per launch,
each with its own h, its own sum and a frozen flag.  The batch is a leading
dimension (the launch grid's x-brick axis times B), not the TPU's
x-concatenated aprons, and each geometry's cells and sum equal a solo
launch's bitwise.

K1's block mode (:func:`reinit_step_block`) replaces the TPU kernel's
``offsets``, ``rms_bounds`` and ``tile_range`` + ``out_init`` arguments: the
tensor is one shard's halo-padded block of a domain-decomposed grid
(:class:`BlockGeom` places it), every mask is in global coordinates on all
three axes, the fused sum counts the owned range only, and a launch may
cover a sub-box of the brick grid.  A block's cells equal the solo kernel's
on the whole grid bitwise.

K5 (``csrc/reinit_bwd.cu``) replaces ``weno_pallas.py:_pallas_bwd_padded``:
the hand-chained adjoint of the step with respect to (phi, sign source, dx,
h), in two deterministic passes (per-cell stencil cotangents, then a
gather).  Its banded mode (:func:`reinit_step_vjp_banded`, the TPU
kernel's ``active``) is the transpose of K1's banded mode; its block mode
(:func:`reinit_step_block_vjp`, the TPU kernel's ``offsets``) gathers each
owned cell of one shard's block from a 6-cell halo, bitwise the solo
kernel's.  :func:`reinit_scan_banded` is the differentiable narrow-band
scan that runs the banded modes of K1 and K5.

:func:`reinit_step` and :func:`reinit_step_vjp` run the plain version only
for a CPU tensor; for a CUDA tensor they launch the kernel or raise.  K1
and its plain version evaluate the same expressions in the same order on
scalars rounded once in the working dtype (:func:`step_scalars`), so they
agree to the last bits; K5 also sums its stencil and ghost-BC terms in
its plain version's order, so only its float64 scalar sums differ in
order.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import types
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import cuda_build
from . import reverse
from .stencil import (clamped_inner, global_clamped_inner,
                      global_interior_mask, interior_mask, shift)
from .weno import default_eps_floor

#: Brick edge in cells: the narrow-band mask granularity and the CUDA
#: kernels' block shape (``csrc/common.cuh``).
BRICK = 8


def np_dtype(dtype: torch.dtype):
    return np.float32 if dtype == torch.float32 else np.float64


def step_scalars(dtype, dx, h, eps_scale=1e-6, eps_floor=None):
    """The step's scalar constants, each rounded once in ``dtype`` exactly
    as the TPU kernel forms them (``_scaled_eps_floor`` :464).  ``ef_dx``
    is d(eps_floor)/d(dx) of the scaled floor, 0 where the floor is
    clamped (``_axis_gsq_bwd`` :639).  Cached by the inputs: a solve's
    launches round them once (a read-only mapping)."""
    return _step_scalars(dtype, float(dx), float(h), float(eps_scale),
                         None if eps_floor is None else float(eps_floor))


@functools.lru_cache(maxsize=256)
def _step_scalars(dtype, dx, h, eps_scale, eps_floor):
    t = np_dtype(dtype)
    if eps_floor is None:
        eps_floor = default_eps_floor(dtype)
    dxv = t(dx)
    dx2 = dxv * dxv
    floor = t(1e-18 if dtype == torch.float32 else 1e-99)
    scaled = t(eps_floor) * dx2
    return types.MappingProxyType(dict(
        dx=float(dxv), h=float(t(h)), dx2=float(dx2),
        inv_dx2=float(t(1) / dx2), eps_scale=float(t(eps_scale)),
        eps_floor=float(max(scaled, floor)),
        ef_dx=float(t(2.0 * eps_floor) * dxv) if scaled >= floor else 0.0))


# ----------------------------- plain version ------------------------------

def _weno5_pair(p0, p1, p2, p3, p4, p5, eps_scale, eps_floor, ratio_floor,
                p5_zero):
    """(d_minus, d_plus) from six one-sided raw differences — the TPU
    kernel's ``_weno5_pair`` :74, operation for operation."""
    ap, am = p5 - p4, p1 - p0
    bp, bm = p4 - p3, p2 - p1
    cp = p3 - p2
    ab_p, ab_m = ap - bp, am - bm
    bc_p, bc_m = bp - cp, bm - cp
    sq_ab_p, sq_ab_m = ab_p * ab_p, ab_m * ab_m
    sq_bc_p, sq_bc_m = bc_p * bc_p, bc_m * bc_m

    def is_term(sq_diff, c):
        return 13.0 * sq_diff + 3.0 * (c * c)

    is0p = is_term(sq_ab_p, ab_p - 2.0 * bp)
    is0m = is_term(sq_ab_m, ab_m - 2.0 * bm)
    is1p = is_term(sq_bc_p, bp + cp)
    is1m = is_term(sq_bc_m, bm + cp)
    is2p = is_term(sq_bc_m, 3.0 * cp - bm)
    is2m = is_term(sq_bc_p, 3.0 * cp - bp)
    common4 = torch.maximum(torch.maximum(p1 * p1, p2 * p2),
                            torch.maximum(p3 * p3, p4 * p4))
    if p5_zero:
        epsp = eps_scale * common4 + eps_floor
    else:
        epsp = eps_scale * torch.maximum(common4, p5 * p5) + eps_floor
    epsm = eps_scale * torch.maximum(common4, p0 * p0) + eps_floor

    def weights(eps, is0, is1, is2):
        d0, d1, d2 = eps + is0, eps + is1, eps + is2
        inv_max = 1.0 / torch.maximum(d0, torch.maximum(d1, d2))
        d0 = torch.clamp_min(d0 * inv_max, ratio_floor)
        d1 = torch.clamp_min(d1 * inv_max, ratio_floor)
        d2 = torch.clamp_min(d2 * inv_max, ratio_floor)
        q0, q1, q2 = d1 * d2, d0 * d2, d0 * d1
        t0 = q0 * q0
        t1 = 6.0 * (q1 * q1)
        t2 = 3.0 * (q2 * q2)
        r = 1.0 / (t0 + t1 + t2)
        return t0 * r, t2 * r

    w0p, w2p = weights(epsp, is0p, is1p, is2p)
    w0m, w2m = weights(epsm, is0m, is1m, is2m)
    pwp = (w0p * (ab_p - bc_p) * (1.0 / 3.0)
           + (w2p - 0.5) * (bc_p + bc_m) * (1.0 / 6.0))
    pwm = (w0m * (ab_m - bc_m) * (1.0 / 3.0)
           + (w2m - 0.5) * (bc_m + bc_p) * (1.0 / 6.0))
    common = (7.0 * (p2 + p3) - (p1 + p4)) * (1.0 / 12.0)
    return common - pwm, common + pwp


def _interior_update(phi, sign_src, sc, quirk_y_p5_zero, deep=None):
    """Euler-updated values of the interior cells (face cells: garbage).
    ``deep``: the WENO5 region (default: 4 cells inside ``phi``'s own
    faces; a block of a larger grid passes its global-coordinate mask)."""
    f64 = phi.dtype == torch.float64
    ratio_floor = 1e-70 if f64 else 1e-7
    if deep is None:
        deep = interior_mask(phi.shape, 4, phi.device)
    pos = sign_src > 0.0
    total = None
    for axis in range(3):
        vm3, vm2, vm1 = (shift(phi, axis, o) for o in (-3, -2, -1))
        vp1, vp2, vp3 = (shift(phi, axis, o) for o in (1, 2, 3))
        p2, p3 = phi - vm1, vp1 - phi
        w_m, w_p = _weno5_pair(vm2 - vm3, vm1 - vm2, p2, p3, vp2 - vp1,
                               vp3 - vp2, sc["eps_scale"], sc["eps_floor"],
                               ratio_floor, quirk_y_p5_zero and axis == 1)
        d_m = torch.where(deep, w_m, p2)
        d_p = torch.where(deep, w_p, p3)
        g = torch.where(pos,
                        torch.clamp_min(torch.maximum(d_m, -d_p), 0.0),
                        torch.clamp_min(torch.maximum(d_p, -d_m), 0.0))
        total = g * g if total is None else total + g * g
    gm = torch.sqrt(total * sc["inv_dx2"])
    d2 = sign_src * sign_src + sc["dx2"] * gm
    sg = sign_src / torch.sqrt(torch.clamp_min(d2, 1e-30 if f64 else 1e-20))
    return phi + sc["h"] * sg * (1.0 - gm)


def _ghost_bc(upd, dx):
    """Face cell = clamped inner neighbour's UPDATED value + dx."""
    return torch.where(interior_mask(upd.shape, 1, upd.device), upd,
                       clamped_inner(upd) + dx)


# --------------------------- narrow-band bricks ---------------------------

def brick_grid(shape) -> tuple:
    return tuple(-(-n // BRICK) for n in shape)


@dataclasses.dataclass(frozen=True)
class BlockGeom:
    """Where one shard's padded block lies in a domain-decomposed grid, and
    how its brick grid is laid (``csrc/common.cuh:BlockGeom``).  Per axis:

    ``gshape``: the global grid; ``origin``: the global index of the
    array's cell 0 (negative where a halo reaches past a global face);
    ``brick_origin``: the array index of brick (0, 0, 0)'s first cell, so
    that the brick grid and the ``active`` mask are anchored on the owned
    block, a halo width into the array; ``cover``: cells the brick grid
    covers from there (None: to the array's end); ``rms_box``: the global
    half-open box ``(x0, x1, y0, y1, z0, z1)`` whose cells the fused sum
    counts (None: the whole grid)."""
    gshape: Tuple[int, int, int]
    origin: Tuple[int, int, int] = (0, 0, 0)
    brick_origin: Tuple[int, int, int] = (0, 0, 0)
    cover: Optional[Tuple[int, int, int]] = None
    rms_box: Optional[Tuple[int, ...]] = None

    def bricks(self, shape) -> tuple:
        """The brick grid's dimensions for an array of ``shape``."""
        cover = self.cover or tuple(n - c for n, c in
                                    zip(shape, self.brick_origin))
        return tuple(-(-n // BRICK) for n in cover)

    def box(self) -> tuple:
        g = self.gshape
        return tuple(self.rms_box or (0, g[0], 0, g[1], 0, g[2]))

    @functools.lru_cache(maxsize=256)
    def ints(self, shape, tile_range=None):
        """The host record a block-mode launch reads (cached: a solve
        launches the same few records every step); ``tile_range``
        ``((bx0, by0, bz0), (nbx, nby, nbz))`` is the launch's sub-box of
        the brick grid (None: all of it)."""
        nb = self.bricks(shape)
        t0, tn = tile_range or ((0, 0, 0), nb)
        if any(a < 0 or n < 1 or a + n > m for a, n, m in zip(t0, tn, nb)):
            raise ValueError(f"tile range {tile_range} outside the brick "
                             f"grid {nb}")
        vals = (*self.gshape, *self.origin, *self.brick_origin, *nb, *t0,
                *self.box(), *tn)
        return (ctypes.c_int * len(vals))(*map(int, vals))


def tile_activity(phi, dx, radius_cells, margin_cells=0.0,
                  window="band4", geom: Optional[BlockGeom] = None
                  ) -> torch.Tensor:
    """(nbx, nby, nbz) int32 brick activity mask of ``phi``.

    The port of ``weno_pallas.tile_activity`` (:1334) at Hopper's
    granularity: 8^3 bricks instead of the TPU's whole-z columns.  A brick
    is active when the min |phi| over its window is below
    ``(radius_cells + margin_cells) * dx``; cells outside the grid are
    ignored.  ``window="owned"``: the brick's own cells (exact for min/max,
    whose update gate is the cell's own value).  ``"band4"``: the own cells
    dilated by 4 in every axis (reinit: every cell feeding an in-band
    cell's stencil keeps computing).

    ``geom`` (the TPU function's ``offsets``): ``phi`` is one shard's
    padded block; its brick grid starts at ``geom.brick_origin``, cells
    past a global face are ignored, and freshly exchanged halo cells take
    part, so a brick at a shard seam sees the band across it."""
    t = np_dtype(phi.dtype)
    thresh = float(t(radius_cells + margin_cells) * t(dx))
    a = torch.abs(phi)
    inf = float("inf")
    if geom is None:
        nb, lead = brick_grid(phi.shape), (0, 0, 0)
    else:
        nb = geom.bricks(phi.shape)
        lead = tuple(-c for c in geom.brick_origin)
        if min(lead) < 0:
            raise ValueError("tile_activity: the brick grid must start at "
                             "or before the array's first cell")
        a = torch.where(global_interior_mask(phi.shape, geom.origin,
                                             geom.gshape, 0, phi.device),
                        a, torch.full_like(a, inf))
    pad = []
    for n, b, l in zip(reversed(phi.shape), reversed(nb), reversed(lead)):
        pad += [l, b * BRICK - n - l]
    a = F.pad(a, pad, value=inf)
    half = BRICK // 2
    m1 = a.reshape(2 * nb[0], half, 2 * nb[1], half, 2 * nb[2], half).amin(
        dim=(1, 3, 5))                          # 4^3 sub-block minima
    if window == "owned":
        m = m1.reshape(nb[0], 2, nb[1], 2, nb[2], 2).amin(dim=(1, 3, 5))
    elif window == "band4":
        # brick b covers sub-blocks 2b, 2b+1; +-4 cells = 2b-1 .. 2b+2
        m1p = F.pad(m1, (1, 1, 1, 1, 1, 1), value=inf)
        m = -F.max_pool3d(-m1p[None, None], kernel_size=4, stride=2)[0, 0]
    else:
        raise ValueError(f"unknown window {window!r}")
    return (m < thresh).to(torch.int32).contiguous()


def brick_cells(active, shape, brick_origin=(0, 0, 0)) -> torch.Tensor:
    """Boolean per-cell view of a brick mask whose brick (0, 0, 0) starts
    at array index ``brick_origin``; cells no brick covers are False."""
    m = active.bool()
    for ax in range(3):
        m = m.repeat_interleave(BRICK, dim=ax)
    if tuple(brick_origin) == (0, 0, 0):
        return m[:shape[0], :shape[1], :shape[2]]
    full = torch.zeros(tuple(shape), dtype=torch.bool, device=active.device)
    dst, src = [], []
    for n, c, e in zip(shape, brick_origin, m.shape):
        lo, hi = max(c, 0), min(c + e, n)
        dst.append(slice(lo, hi))
        src.append(slice(lo - c, hi - c))
    full[tuple(dst)] = m[tuple(src)]
    return full


def finish_plain(res, phi, out, with_rms, base=None):
    """Copy a plain version's result into ``out``; with ``with_rms`` also
    return the float64 sum of squared changes against ``base`` (default
    ``phi``), as the kernels' fused reduction does."""
    if out is None:
        out = torch.empty_like(phi)
    out.copy_(res)
    if not with_rms:
        return out
    d = (out - (phi if base is None else base)).double()
    return out, (d * d).sum()


def reinit_step_plain(phi, sign_src, dx, h, *, eps_scale=1e-6,
                      eps_floor=None, quirk_y_p5_zero=False, active=None,
                      out=None, mint=True, with_rms=False):
    """The plain version of :func:`reinit_step` (same arguments, any dtype,
    any device): whole-grid tensor ops, then the banded write."""
    sc = step_scalars(phi.dtype, dx, h, eps_scale, eps_floor)
    upd = _interior_update(phi, sign_src, sc, quirk_y_p5_zero)
    if active is not None:
        upd = torch.where(brick_cells(active, phi.shape), upd,
                          phi if mint else out)
    return finish_plain(_ghost_bc(upd, sc["dx"]), phi, out, with_rms)


def _range_cells(geom, shape, tile_range, device):
    """Cells of the bricks ``tile_range`` of ``geom``'s grid (None: all)."""
    nb = geom.bricks(shape)
    t0, tn = tile_range or ((0, 0, 0), nb)
    m = torch.zeros(nb, dtype=torch.int32, device=device)
    m[t0[0]:t0[0] + tn[0], t0[1]:t0[1] + tn[1], t0[2]:t0[2] + tn[2]] = 1
    return brick_cells(m, shape, geom.brick_origin)


def box_cells(geom, shape, device):
    """Cells inside ``geom``'s fused-sum box."""
    masks = []
    for ax, (n, o) in enumerate(zip(shape, geom.origin)):
        idx = o + torch.arange(n, device=device)
        lo, hi = geom.box()[2 * ax:2 * ax + 2]
        bshape = [1, 1, 1]
        bshape[ax] = n
        masks.append(((idx >= lo) & (idx < hi)).reshape(bshape))
    return masks[0] & masks[1] & masks[2]


def finish_block_plain(res, written, pad, out, with_rms, geom):
    """Write ``res`` where ``written`` into ``out`` (a copy of ``pad`` when
    None); with ``with_rms`` also the float64 sum of squared changes over
    the written cells of ``geom``'s box."""
    if out is None:
        out = pad.clone()
    out.copy_(torch.where(written, res, out))
    if not with_rms:
        return out
    d = torch.where(written & box_cells(geom, pad.shape, pad.device),
                    res - pad, torch.zeros_like(pad)).double()
    return out, (d * d).sum()


def reinit_step_block_plain(pad, sign_pad, dx, h, geom: BlockGeom, *,
                            eps_scale=1e-6, eps_floor=None,
                            quirk_y_p5_zero=False, active=None,
                            tile_range=None, out=None, with_rms=False):
    """The plain version of :func:`reinit_step_block` (same arguments, any
    dtype, any device): the solo plain step's tensor ops with every mask in
    global coordinates (``parallel/sharded.py:84-103`` of the JAX package),
    written where the kernel writes: in-grid cells whose stencil stays
    inside the array, frozen bricks copied."""
    sc = step_scalars(pad.dtype, dx, h, eps_scale, eps_floor)
    shape, dev = pad.shape, pad.device
    g, o = geom.gshape, geom.origin
    deep = global_interior_mask(shape, o, g, 4, dev)
    upd = _interior_update(pad, sign_pad, sc, quirk_y_p5_zero, deep=deep)
    live = None
    if active is not None:
        live = brick_cells(active, shape, geom.brick_origin)
        upd = torch.where(live, upd, pad)
    in_grid = global_interior_mask(shape, o, g, 0, dev)
    face = in_grid & ~global_interior_mask(shape, o, g, 1, dev)
    res = torch.where(face, global_clamped_inner(upd, o, g) + sc["dx"], upd)
    # a cell's stencil (radius 3 where deep, else 1) must stay in the array;
    # a face cell evaluates its clamped inner neighbour's
    ok3, ok1 = (interior_mask(shape, r, dev) for r in (3, 1))
    valid = global_clamped_inner(torch.where(deep, ok3, ok1), o, g)
    written = in_grid & valid
    if live is not None:
        written = in_grid & (valid | (~face & ~live))
    if tile_range is not None:
        written = written & _range_cells(geom, shape, tile_range, dev)
    return finish_block_plain(res, written, pad, out, with_rms, geom)


# ------------------------- plain version of the VJP ------------------------

def _weights_fwd(eps, is0, is1, is2, ratio_floor):
    """Normalized WENO weights (w0, w2) and the residuals their adjoint
    reads (``_weno5_pair_hand.weights_fwd`` :218)."""
    d0, d1, d2 = eps + is0, eps + is1, eps + is2
    m12 = torch.maximum(d1, d2)
    inv = 1.0 / torch.maximum(d0, m12)
    r0, r1, r2 = d0 * inv, d1 * inv, d2 * inv
    h0 = torch.clamp_min(r0, ratio_floor)
    h1 = torch.clamp_min(r1, ratio_floor)
    h2 = torch.clamp_min(r2, ratio_floor)
    u0, u1, u2 = h1 * h2, h0 * h2, h0 * h1
    t0 = u0 * u0
    t2 = 3.0 * (u2 * u2)
    r = 1.0 / (t0 + 6.0 * (u1 * u1) + t2)
    w0, w2 = t0 * r, t2 * r
    return w0, w2, (d0, d1, d2, m12, inv, r0, r1, r2, h0, h1, h2, u0, u1,
                    u2, r, w0, w2)


def _weights_bwd(res, cot_w0, cot_w2, ratio_floor):
    """Quotient-rule adjoint of :func:`_weights_fwd` with argmax routing
    (ties to the lower-index operand): (cot_eps, cot_is0..2)."""
    (d0, d1, d2, m12, inv, r0, r1, r2, h0, h1, h2, u0, u1, u2, r, w0,
     w2) = res
    sigma = r * (cot_w0 * w0 + cot_w2 * w2)
    cot_u0 = (2.0 * (r * cot_w0 - sigma)) * u0
    cot_u1 = (-12.0 * sigma) * u1
    cot_u2 = (6.0 * (r * cot_w2 - sigma)) * u2
    zero = torch.zeros_like(cot_u0)
    cr0 = torch.where(r0 >= ratio_floor, cot_u1 * h2 + cot_u2 * h1, zero)
    cr1 = torch.where(r1 >= ratio_floor, cot_u0 * h2 + cot_u2 * h0, zero)
    cr2 = torch.where(r2 >= ratio_floor, cot_u0 * h1 + cot_u1 * h0, zero)
    cot_m = -(inv * inv) * (cr0 * d0 + cr1 * d1 + cr2 * d2)
    d0_wins = d0 >= m12
    cot_m12 = torch.where(d0_wins, zero, cot_m)
    d1_wins = d1 >= d2
    cot_d0 = cr0 * inv + torch.where(d0_wins, cot_m, zero)
    cot_d1 = cr1 * inv + torch.where(d1_wins, cot_m12, zero)
    cot_d2 = cr2 * inv + torch.where(d1_wins, zero, cot_m12)
    return cot_d0 + cot_d1 + cot_d2, cot_d0, cot_d1, cot_d2


def _weno5_pair_bwd(p, eps_scale, eps_floor, ratio_floor, p5_zero,
                    cot_wm, cot_wp):
    """Hand adjoint of :func:`_weno5_pair` (``_weno5_pair_hand`` :149,
    equation for equation): the six diffs ``p`` and the cotangents of
    (d_minus, d_plus) give (cot_p0..cot_p5, cot of the scaled epsilon
    floor)."""
    p0, p1, p2, p3, p4, p5 = p
    ap, am = p5 - p4, p1 - p0
    bp, bm = p4 - p3, p2 - p1
    cp = p3 - p2
    ab_p, ab_m = ap - bp, am - bm
    bc_p, bc_m = bp - cp, bm - cp
    e0p, e0m = ab_p - 2.0 * bp, ab_m - 2.0 * bm
    e1p, e1m = bp + cp, bm + cp
    e2p, e2m = 3.0 * cp - bm, 3.0 * cp - bp
    is0p = 13.0 * (ab_p * ab_p) + 3.0 * (e0p * e0p)
    is0m = 13.0 * (ab_m * ab_m) + 3.0 * (e0m * e0m)
    is1p = 13.0 * (bc_p * bc_p) + 3.0 * (e1p * e1p)
    is1m = 13.0 * (bc_m * bc_m) + 3.0 * (e1m * e1m)
    is2p = 13.0 * (bc_m * bc_m) + 3.0 * (e2p * e2p)
    is2m = 13.0 * (bc_p * bc_p) + 3.0 * (e2m * e2m)
    p0s, p1s, p2s, p3s, p4s = p0 * p0, p1 * p1, p2 * p2, p3 * p3, p4 * p4
    c12 = torch.maximum(p1s, p2s)
    c34 = torch.maximum(p3s, p4s)
    common4 = torch.maximum(c12, c34)
    if p5_zero:
        epsp = eps_scale * common4 + eps_floor
    else:
        p5s = p5 * p5
        epsp = eps_scale * torch.maximum(common4, p5s) + eps_floor
    epsm = eps_scale * torch.maximum(common4, p0s) + eps_floor
    w0p, w2p, res_p = _weights_fwd(epsp, is0p, is1p, is2p, ratio_floor)
    w0m, w2m, res_m = _weights_fwd(epsm, is0m, is1m, is2m, ratio_floor)
    a_p, a_m, b = ab_p - bc_p, ab_m - bc_m, bc_p + bc_m

    third, sixth = 1.0 / 3.0, 1.0 / 6.0
    cot_common = cot_wm + cot_wp
    tp, tm = cot_wp * third, -cot_wm * third
    sp, sm = cot_wp * sixth, -cot_wm * sixth
    cot_ap_, cot_am_ = tp * w0p, tm * w0m
    cot_b = sp * (w2p - 0.5) + sm * (w2m - 0.5)
    cot_epsp, ci0p, ci1p, ci2p = _weights_bwd(res_p, tp * a_p, sp * b,
                                              ratio_floor)
    cot_epsm, ci0m, ci1m, ci2m = _weights_bwd(res_m, tm * a_m, sm * b,
                                              ratio_floor)
    ce0p, ce0m = (6.0 * ci0p) * e0p, (6.0 * ci0m) * e0m
    ce1p, ce1m = (6.0 * ci1p) * e1p, (6.0 * ci1m) * e1m
    ce2p, ce2m = (6.0 * ci2p) * e2p, (6.0 * ci2m) * e2m

    zero = torch.zeros_like(cot_common)
    cot_mp = eps_scale * cot_epsp
    cot_mm = eps_scale * cot_epsm
    mm_c4 = common4 >= p0s
    cot_c4 = torch.where(mm_c4, cot_mm, zero)
    cot_p0s = torch.where(mm_c4, zero, cot_mm)
    if p5_zero:
        cot_c4 = cot_c4 + cot_mp
        cot_p5s = zero
    else:
        mp_c4 = common4 >= p5s
        cot_c4 = cot_c4 + torch.where(mp_c4, cot_mp, zero)
        cot_p5s = torch.where(mp_c4, zero, cot_mp)
    c12_wins = c12 >= c34
    cot_c12 = torch.where(c12_wins, cot_c4, zero)
    cot_c34 = torch.where(c12_wins, zero, cot_c4)
    p1_wins, p3_wins = p1s >= p2s, p3s >= p4s
    cot_p1s = torch.where(p1_wins, cot_c12, zero)
    cot_p2s = torch.where(p1_wins, zero, cot_c12)
    cot_p3s = torch.where(p3_wins, cot_c34, zero)
    cot_p4s = torch.where(p3_wins, zero, cot_c34)

    cot_ab_p = (2.0 * ab_p) * (13.0 * ci0p) + ce0p + cot_ap_
    cot_ab_m = (2.0 * ab_m) * (13.0 * ci0m) + ce0m + cot_am_
    cot_bc_p = (2.0 * bc_p) * (13.0 * (ci1p + ci2m)) - cot_ap_ + cot_b
    cot_bc_m = (2.0 * bc_m) * (13.0 * (ci1m + ci2p)) - cot_am_ + cot_b
    cot_bp = -2.0 * ce0p + ce1p - ce2m - cot_ab_p + cot_bc_p
    cot_bm = -2.0 * ce0m + ce1m - ce2p - cot_ab_m + cot_bc_m
    cot_cp = ce1p + ce1m + 3.0 * (ce2p + ce2m) - cot_bc_p - cot_bc_m
    c7 = (7.0 / 12.0) * cot_common
    c1 = (1.0 / 12.0) * cot_common
    cps = [-cot_ab_m + (2.0 * p0) * cot_p0s,
           cot_ab_m - cot_bm - c1 + (2.0 * p1) * cot_p1s,
           cot_bm - cot_cp + c7 + (2.0 * p2) * cot_p2s,
           cot_cp - cot_bp + c7 + (2.0 * p3) * cot_p3s,
           cot_bp - cot_ab_p - c1 + (2.0 * p4) * cot_p4s,
           cot_ab_p + (2.0 * p5) * cot_p5s]
    return cps, cot_epsp + cot_epsm


def _godunov_routing(d_m, d_p, pos, cot_gsq):
    """Cotangents of (d_m, d_p) from that of the squared Godunov-selected
    derivative (``_axis_gsq_bwd`` :619-632): the inner max routes to
    ``d_m`` when ``d_m >= -d_p`` (positive side), nothing flows where the
    selected value is 0."""
    g = torch.where(pos, torch.clamp_min(torch.maximum(d_m, -d_p), 0.0),
                    torch.clamp_min(torch.maximum(d_p, -d_m), 0.0))
    cot_g = torch.where(g > 0.0, 2.0 * g * cot_gsq, torch.zeros_like(g))
    zero = torch.zeros_like(g)
    m_over_p = d_m >= -d_p
    p_over_m = d_p >= -d_m
    cot_dm = torch.where(pos, torch.where(m_over_p, cot_g, zero),
                         torch.where(p_over_m, zero, -cot_g))
    cot_dp = torch.where(pos, torch.where(m_over_p, zero, -cot_g),
                         torch.where(p_over_m, cot_g, zero))
    return g * g, cot_dm, cot_dp


def _axis_diffs(phi, axis):
    v = [shift(phi, axis, o) for o in (-3, -2, -1, 0, 1, 2, 3)]
    return [v[i + 1] - v[i] for i in range(6)]


def _clamp_transpose(g, axis, origin, gshape):
    """Transpose of gathering at the GLOBAL index ``clamp(i, 1, n-2)`` along
    ``axis`` (``g``: one block of the grid, cell 0 at global ``origin``):
    each global face cell in the block adds onto its inner neighbour, then
    is zeroed."""
    n, o, gn = g.shape[axis], origin[axis], gshape[axis]
    out = g.clone()
    for face, inner in ((0, 1), (gn - 1, gn - 2)):
        if 0 <= face - o < n and 0 <= inner - o < n:
            out.narrow(axis, inner - o, 1).add_(g.narrow(axis, face - o, 1))
    for face in (0, gn - 1):
        if 0 <= face - o < n:
            out.narrow(axis, face - o, 1).zero_()
    return out


def _vjp_plain(phi, sign_src, g, sc, quirk_y_p5_zero, origin, gshape, live,
               owned):
    """The VJP of one step on an array whose cell 0 lies at global
    ``origin`` of a ``gshape`` grid (every mask in global coordinates), as
    the kernel K5 routes it; ``live``: the cells of active bricks (None:
    all), ``owned``: the cells the scalar sums count (None: all).  Returns
    the array-shaped ``(cot_phi, cot_sign, cot_dx, cot_h)``; ``cot_phi`` is
    right where every stencil source lies in the array."""
    f64 = phi.dtype == torch.float64
    ratio_floor = 1e-70 if f64 else 1e-7
    sm_floor = 1e-30 if f64 else 1e-20
    shape, dev = phi.shape, phi.device
    in_grid = global_interior_mask(shape, origin, gshape, 0, dev)
    interior = global_interior_mask(shape, origin, gshape, 1, dev)
    deep = global_interior_mask(shape, origin, gshape, 4, dev)
    stepped = interior if live is None else interior & live
    counted = stepped if owned is None else stepped & owned
    pos = sign_src > 0.0
    zero = torch.zeros_like(phi)

    def pair(axis):
        diffs = _axis_diffs(phi, axis)
        p5z = quirk_y_p5_zero and axis == 1
        w_m, w_p = _weno5_pair(*diffs, sc["eps_scale"], sc["eps_floor"],
                               ratio_floor, p5z)
        return (diffs, p5z, torch.where(deep, w_m, diffs[2]),
                torch.where(deep, w_p, diffs[3]))

    gsum = None
    for axis in range(3):
        _, _, d_m, d_p = pair(axis)
        gsq, _, _ = _godunov_routing(d_m, d_p, pos, zero)
        gsum = gsq if gsum is None else gsum + gsq

    # ghost BC: face = clamped inner neighbour's updated value + dx
    face = in_grid & ~interior
    gf = torch.where(face, g, zero)
    for axis in (2, 1, 0):
        gf = _clamp_transpose(gf, axis, origin, gshape)
    big_g = torch.where(interior, g, zero) + gf
    cot_dx = torch.where(face if owned is None else face & owned, g,
                         zero).double().sum()

    # guarded tail: res = c + (h sg)(1 - gm), sg = s / sqrt(max(d2, floor))
    nzm = gsum > 0.0
    gm_safe = torch.sqrt(torch.where(nzm, gsum, 1.0 + zero) * sc["inv_dx2"])
    gm = torch.where(nzm, gm_safe, zero)
    d2 = sign_src * sign_src + sc["dx2"] * gm
    m = torch.clamp_min(d2, sm_floor)
    sq = torch.sqrt(m)
    sg = sign_src / sq
    cot_hs = big_g * (1.0 - gm)
    cot_h = torch.where(counted, cot_hs * sg, zero).double().sum()
    cot_sg = cot_hs * sc["h"]
    cot_m = cot_sg * ((-0.5 * sg) / m)
    cot_d2 = torch.where(d2 > sm_floor, cot_m,
                         torch.where(d2 == sm_floor, 0.5 * cot_m, zero))
    cot_sign = torch.where(stepped, cot_sg / sq + (2.0 * sign_src) * cot_d2,
                           zero)
    cot_gm = -((sc["h"] * sg) * big_g) + sc["dx2"] * cot_d2
    cot_u = torch.where(nzm, cot_gm * (0.5 / gm_safe), zero)
    cot_gs = cot_u * sc["inv_dx2"]
    cdx = ((2.0 * sc["dx"]) * (gm * cot_d2).double()
           - (2.0 * sc["dx"] * sc["inv_dx2"] * sc["inv_dx2"])
           * (cot_u * gsum).double())

    cot_phi = big_g
    for axis in range(3):
        diffs, p5z, d_m, d_p = pair(axis)
        _, cot_dm, cot_dp = _godunov_routing(d_m, d_p, pos, cot_gs)
        cps, cot_ef = _weno5_pair_bwd(
            diffs, sc["eps_scale"], sc["eps_floor"], ratio_floor, p5z,
            torch.where(deep, cot_dm, zero), torch.where(deep, cot_dp, zero))
        cdx = cdx + sc["ef_dx"] * cot_ef.double()
        cps[2] = cps[2] + torch.where(deep, zero, cot_dm)
        cps[3] = cps[3] + torch.where(deep, zero, cot_dp)
        qs = [-cps[0]] + [cps[i] - cps[i + 1] for i in range(5)] + [cps[5]]
        for k, q in zip(range(-3, 4), qs):
            cot_phi = cot_phi + shift(torch.where(stepped, q, zero), axis,
                                      -k)
    cdx = torch.where(counted, cdx, torch.zeros_like(cdx))
    return cot_phi, cot_sign, cot_dx + cdx.sum(), cot_h


def reinit_step_vjp_plain(phi, sign_src, g, dx, h, *, eps_scale=1e-6,
                          eps_floor=None, quirk_y_p5_zero=False, active=None):
    """The plain version of :func:`reinit_step_vjp` and, with ``active``,
    of :func:`reinit_step_vjp_banded` (any dtype, any device): the VJP of
    the step, hand-chained as the TPU kernel K5 routes it — ghost-BC
    transpose, guarded tail, per-axis Godunov and WENO-pair adjoints,
    stencil transpose as seven shifted adds per axis.  Not autograd of
    :func:`reinit_step_plain`: autograd splits ties and differentiates
    ``sqrt`` at 0 where the kernel's rules do not.  A frozen brick's
    interior cells pass their cotangent through; face cells keep the
    ghost-BC transpose in every brick."""
    sc = step_scalars(phi.dtype, dx, h, eps_scale, eps_floor)
    live = None if active is None else brick_cells(active, phi.shape)
    return _vjp_plain(phi, sign_src, g, sc, quirk_y_p5_zero, (0, 0, 0),
                      tuple(phi.shape), live, None)


def owned_slices(geom: BlockGeom) -> tuple:
    """The owned box of ``geom`` as array slices."""
    box = geom.box()
    return tuple(slice(box[2 * a] - o, box[2 * a + 1] - o)
                 for a, o in enumerate(geom.origin))


def check_adjoint_geom(name, shape, geom: BlockGeom, reach, near):
    """Raise unless the padded array holds the owned box and ``reach``
    cells around it (inside the global grid), and the brick grid covers the
    owned box and ``near`` cells around it."""
    box, nb = geom.box(), geom.bricks(shape)
    for a, (n, o, c, g) in enumerate(zip(shape, geom.origin,
                                         geom.brick_origin, geom.gshape)):
        lo, hi = box[2 * a], box[2 * a + 1]
        if not (o <= max(lo - reach, 0) and o + n >= min(hi + reach, g)
                and o + c <= max(lo - near, 0)
                and o + c + BRICK * nb[a] >= min(hi + near, g)):
            raise ValueError(f"{name}: the padded block {tuple(shape)} at "
                             f"{geom.origin} must hold the owned box and "
                             f"{reach} cells around it, its brick grid the "
                             f"box and {near} cells around it (axis {a})")


#: Halo cells the block-mode adjoints read: K5 evaluates the stencil
#: cotangents of the cells within 3 of the owned box (radius 3 on radius 3),
#: K6 the Laplacian cotangents of the owned cells' neighbours (1 on 1).
VJP_HALO = {"reinit": 6, "minmax": 2}


def reinit_step_block_vjp_plain(pad, sign_pad, g_pad, dx, h, geom, *,
                                active=None, eps_scale=1e-6, eps_floor=None,
                                quirk_y_p5_zero=False):
    """The plain version of :func:`reinit_step_block_vjp` (any dtype, any
    device): the solo plain VJP on the padded block with every mask in
    global coordinates, cropped to the owned box; the sums count the owned
    cells."""
    check_adjoint_geom("reinit_step_block_vjp", pad.shape, geom,
                       VJP_HALO["reinit"], 3)
    sc = step_scalars(pad.dtype, dx, h, eps_scale, eps_floor)
    live = None if active is None else brick_cells(active, pad.shape,
                                                   geom.brick_origin)
    cot_phi, cot_sign, cdx, ch = _vjp_plain(
        pad, sign_pad, g_pad, sc, quirk_y_p5_zero, geom.origin, geom.gshape,
        live, box_cells(geom, pad.shape, pad.device))
    sl = owned_slices(geom)
    return cot_phi[sl].contiguous(), cot_sign[sl].contiguous(), cdx, ch


# ------------------------------ kernel wrapper -----------------------------

def check_inputs(name, phi, inputs, active=None, nb=None):
    """Raise on what the CUDA kernels do not take: ``phi`` and ``inputs``
    contiguous float32 grids of one shape on one device, ``active`` a
    contiguous int32 mask of ``nb`` bricks (default: ``phi``'s brick
    grid)."""
    if phi.dtype != torch.float32:
        raise TypeError(f"{name}: the CUDA kernel takes float32 only, got "
                        f"{phi.dtype} (float64 runs on the CPU)")
    if phi.dim() != 3 or min(phi.shape) < 3 or phi.numel() >= 2 ** 31:
        raise ValueError(f"{name}: unsupported grid shape {tuple(phi.shape)}")
    for t in (phi, *inputs):
        if (t.dtype != torch.float32 or t.shape != phi.shape
                or t.device != phi.device or not t.is_contiguous()):
            raise ValueError(f"{name}: every field must be a contiguous "
                             f"float32 tensor of shape {tuple(phi.shape)} "
                             f"on {phi.device}")
    nb = brick_grid(phi.shape) if nb is None else tuple(nb)
    if active is not None and (
            active.dtype != torch.int32 or active.device != phi.device
            or tuple(active.shape) != nb or not active.is_contiguous()):
        raise ValueError(f"{name}: active must be a contiguous int32 {nb} "
                         f"tensor on {phi.device}")


def check_cuda(name, phi, out, active, inputs=()):
    """Raise on what the CUDA kernels do not take, or on an ``out`` that
    aliases an input."""
    check_inputs(name, phi, (*inputs, out), active)
    if any(out.data_ptr() == t.data_ptr() for t in (phi, *inputs)):
        raise ValueError(f"{name}: out must not alias an input")


def ptr(t):
    return None if t is None else t.data_ptr()


def rms_buffers(phi, with_rms):
    """Per-brick partial sums and the scalar they reduce into."""
    if not with_rms:
        return None, None
    nb = brick_grid(phi.shape)
    return (torch.empty(nb[0] * nb[1] * nb[2], dtype=torch.float64,
                        device=phi.device),
            torch.empty((), dtype=torch.float64, device=phi.device))


#: The fused sums' ticket counters of K3, per (device, stream): one zeroed
#: int32 per geometry of a launch, left zeroed by every launch
#: (``csrc/common.cuh:march_finish``), so one set serves the launches of a
#: stream one after the other.
_TICKETS = {}


def _tickets(device, stream, groups):
    key = (device, stream)
    t = _TICKETS.get(key)
    if t is None or t.numel() < groups:
        t = torch.zeros(max(groups, 64), dtype=torch.int32, device=device)
        _TICKETS[key] = t
    return t


class SolveBuffers:
    """What the K1 and K3 wrappers resolve once per solve and reuse in each
    of its launches: the device, its current stream, and the fused sum's
    device buffers for ``groups`` geometries of ``bricks`` bricks each (one
    geometry: a 0-d sum; a pack: a (B,) vector).  The sum a launch returns
    is this buffer, overwritten by the next launch that takes it: a solve
    reads it before its next step."""

    def __init__(self, like: torch.Tensor, bricks: int, groups=None):
        self.device = like.device
        self.stream = torch.cuda.current_stream(like.device).cuda_stream
        n = groups or 1
        self.partials = torch.empty(bricks * n, dtype=torch.float64,
                                    device=like.device)
        self.dsq = torch.empty(() if groups is None else (groups,),
                               dtype=torch.float64, device=like.device)
        self.tickets = _tickets(like.device, self.stream, n)


def solve_buffers(phi, *, geom: Optional[BlockGeom] = None, tile_range=None,
                  packed=False) -> Optional[SolveBuffers]:
    """The buffers of a solve of ``phi`` (a (B, nx, ny, nz) batch when
    ``packed``, one shard's padded block under ``geom``); None for a CPU
    tensor, whose steps run the plain versions."""
    if phi.device.type != "cuda":
        return None
    groups = phi.shape[0] if packed else None
    n = solve_buffers_size(phi, geom=geom, tile_range=tile_range,
                           packed=packed)
    return SolveBuffers(phi, n // (groups or 1), groups)


def _sum_args(name, phi, with_rms, bufs, **kw):
    """(partials, dsq, tickets, stream) of one K1/K3 launch, from the
    solve's buffers or made for this launch."""
    if bufs is None:
        if not with_rms:
            return None, None, None, \
                torch.cuda.current_stream(phi.device).cuda_stream
        bufs = solve_buffers(phi, **kw)
    elif bufs.device != phi.device or bufs.partials.numel() != \
            solve_buffers_size(phi, **kw):
        raise ValueError(f"{name}: the solve's buffers are for another "
                         f"device or brick grid")
    if not with_rms:
        return None, None, None, bufs.stream
    return bufs.partials, bufs.dsq, bufs.tickets, bufs.stream


def solve_buffers_size(phi, *, geom=None, tile_range=None, packed=False):
    """Partials a launch of this shape writes (see :func:`solve_buffers`)."""
    if packed:
        nb = brick_grid(phi.shape[1:])
        return phi.shape[0] * nb[0] * nb[1] * nb[2]
    nb = brick_grid(phi.shape) if geom is None else (
        tile_range[1] if tile_range else geom.bricks(phi.shape))
    return nb[0] * nb[1] * nb[2]


def on_device(device):
    """Make ``device`` current for a launch, unless it already is."""
    if torch.cuda.current_device() == device.index:
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def reinit_step(phi, sign_src, dx, h, *, eps_scale=1e-6, eps_floor=None,
                quirk_y_p5_zero=False, active=None, out=None, mint=True,
                with_rms=False, bufs: Optional[SolveBuffers] = None):
    """One reinit step of ``phi`` into ``out`` (allocated when None).

    ``active`` (brick mask) runs the narrow band: inactive bricks copy
    their cells when ``mint``, else keep what ``out`` already holds; face
    cells take the ghost BC in every brick.  Returns ``out``, or
    ``(out, dsq)`` with the float64 sum of squared changes when
    ``with_rms``.  ``bufs`` (:func:`solve_buffers` of ``phi``): a solve's
    reused device, stream and sum buffers."""
    if phi.device.type == "cpu":
        return reinit_step_plain(
            phi, sign_src, dx, h, eps_scale=eps_scale, eps_floor=eps_floor,
            quirk_y_p5_zero=quirk_y_p5_zero, active=active, out=out,
            mint=mint, with_rms=with_rms)
    if out is None:
        out = torch.empty_like(phi)
    check_cuda("reinit_step", phi, out, active, (sign_src,))
    sc = step_scalars(phi.dtype, dx, h, eps_scale, eps_floor)
    partials, dsq, _, stream = _sum_args("reinit_step", phi, with_rms, bufs)
    with on_device(phi.device):
        cuda_build.launch(
            "lsf_reinit_step_f32", phi.data_ptr(), sign_src.data_ptr(),
            out.data_ptr(), *phi.shape, sc["dx"], sc["h"], sc["dx2"],
            sc["inv_dx2"], sc["eps_scale"], sc["eps_floor"],
            int(quirk_y_p5_zero), ptr(active), int(mint), ptr(partials),
            ptr(dsq), stream)
    reinit_step.launches += 1
    return (out, dsq) if with_rms else out


reinit_step.launches = 0


def check_block(name, pad, out, active, geom, inputs=()):
    """Raise on what the block-mode kernels do not take."""
    check_cuda(name, pad, out, None, inputs)
    check_inputs(name, pad, (), active, geom.bricks(pad.shape))


def reinit_step_block(pad, sign_pad, dx, h, geom: BlockGeom, *,
                      eps_scale=1e-6, eps_floor=None, quirk_y_p5_zero=False,
                      active=None, tile_range=None, out=None,
                      with_rms=False):
    """One reinit step of one shard's padded block (K1's block mode).

    ``pad`` and ``sign_pad`` hold the owned cells and the halo; ``geom``
    places the array in the global grid.  Every in-grid cell whose stencil
    stays inside the array is written into ``out`` (a copy of ``pad`` when
    None), the rest of ``out`` is left as it is; bricks with ``active ==
    0`` copy their cells (global-face cells still take the ghost BC);
    ``tile_range`` restricts the launch to a sub-box of the brick grid, so
    that several launches fill one ``out``.  Returns ``out``, or ``(out,
    dsq)`` with the float64 sum of squared changes over ``geom``'s box."""
    if pad.device.type == "cpu":
        return reinit_step_block_plain(
            pad, sign_pad, dx, h, geom, eps_scale=eps_scale,
            eps_floor=eps_floor, quirk_y_p5_zero=quirk_y_p5_zero,
            active=active, tile_range=tile_range, out=out, with_rms=with_rms)
    if out is None:
        out = pad.clone()
    check_block("reinit_step_block", pad, out, active, geom, (sign_pad,))
    sc = step_scalars(pad.dtype, dx, h, eps_scale, eps_floor)
    partials, dsq, _, stream = _sum_args(
        "reinit_step_block", pad, with_rms, None, geom=geom,
        tile_range=tile_range)
    with on_device(pad.device):
        cuda_build.launch(
            "lsf_reinit_step_block_f32", pad.data_ptr(), sign_pad.data_ptr(),
            out.data_ptr(), *pad.shape, geom.ints(pad.shape, tile_range),
            sc["dx"], sc["h"], sc["dx2"], sc["inv_dx2"], sc["eps_scale"],
            sc["eps_floor"], int(quirk_y_p5_zero), ptr(active),
            ptr(partials), ptr(dsq), stream)
    reinit_step_block.launches += 1
    return (out, dsq) if with_rms else out


reinit_step_block.launches = 0


def _reinit_vjp_cuda(name, phi, sign_src, g, dx, h, geom, active, scratch,
                     eps_scale, eps_floor, quirk_y_p5_zero):
    """Launch K5 on a solo grid (``geom`` None) or on one shard's padded
    block; the outputs have the owned box's shape."""
    nb = brick_grid(phi.shape) if geom is None else geom.bricks(phi.shape)
    check_inputs(name, phi, (sign_src, g), active, nb)
    if geom is not None:
        check_adjoint_geom(name, phi.shape, geom, VJP_HALO["reinit"], 3)
    owned = phi.shape if geom is None else tuple(
        s.stop - s.start for s in owned_slices(geom))
    cot_phi = torch.empty(owned, dtype=phi.dtype, device=phi.device)
    cot_sign = torch.empty_like(cot_phi)
    # one float per cell between the passes: the cotangent of the squared
    # gradient sum, the only per-cell input of the per-axis adjoints
    if scratch is None:
        scratch = torch.empty_like(phi)
    elif (scratch.shape != phi.shape or scratch.dtype != phi.dtype
          or scratch.device != phi.device or not scratch.is_contiguous()):
        raise ValueError(f"{name}: scratch must be a contiguous "
                         f"{tuple(phi.shape)} float32 tensor on {phi.device}")
    sc = step_scalars(phi.dtype, dx, h, eps_scale, eps_floor)
    geom_ints = None if geom is None else geom.ints(tuple(phi.shape))
    partials = torch.empty(
        cuda_build.library().lsf_reinit_bwd_partials(*phi.shape, geom_ints),
        dtype=torch.float64, device=phi.device)
    sums = torch.empty(2, dtype=torch.float64, device=phi.device)
    args = [phi.data_ptr(), sign_src.data_ptr(), g.data_ptr(),
            cot_phi.data_ptr(), cot_sign.data_ptr(), scratch.data_ptr(),
            *phi.shape]
    if geom is not None:
        args.append(geom_ints)
    with torch.cuda.device(phi.device):
        cuda_build.launch(
            "lsf_reinit_bwd_f32" if geom is None
            else "lsf_reinit_bwd_block_f32", *args, sc["dx"], sc["h"],
            sc["dx2"], sc["inv_dx2"], sc["eps_scale"], sc["eps_floor"],
            sc["ef_dx"], int(quirk_y_p5_zero), ptr(active),
            partials.data_ptr(), sums.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    return cot_phi, cot_sign, sums[0], sums[1]


def reinit_step_vjp(phi, sign_src, g, dx, h, *, eps_scale=1e-6,
                    eps_floor=None, quirk_y_p5_zero=False):
    """VJP of the dense :func:`reinit_step` at ``(phi, sign_src, dx, h)``
    for the output cotangent ``g`` (kernel K5, ``csrc/reinit_bwd.cu``).

    Returns ``(cot_phi, cot_sign, cot_dx, cot_h)``; the scalar cotangents
    are float64 0-d tensors, each a fixed-order sum of per-cell terms."""
    if phi.device.type == "cpu":
        return reinit_step_vjp_plain(
            phi, sign_src, g, dx, h, eps_scale=eps_scale,
            eps_floor=eps_floor, quirk_y_p5_zero=quirk_y_p5_zero)
    res = _reinit_vjp_cuda("reinit_step_vjp", phi, sign_src, g, dx, h, None,
                           None, None, eps_scale, eps_floor, quirk_y_p5_zero)
    reinit_step_vjp.launches += 1
    return res


reinit_step_vjp.launches = 0


def reinit_step_vjp_banded(phi, sign_src, g, dx, h, active, *,
                           eps_scale=1e-6, eps_floor=None,
                           quirk_y_p5_zero=False):
    """VJP of the banded :func:`reinit_step` (``active``, mint) — K5's
    banded mode, the TPU kernel's ``active`` argument: a frozen brick's
    interior cells pass ``g`` through and write no stencil or sign
    cotangent; face cells keep the ghost-BC transpose, as K1's banded mode
    keeps the BC.  Returns what :func:`reinit_step_vjp` returns."""
    if phi.device.type == "cpu":
        return reinit_step_vjp_plain(
            phi, sign_src, g, dx, h, eps_scale=eps_scale,
            eps_floor=eps_floor, quirk_y_p5_zero=quirk_y_p5_zero,
            active=active)
    res = _reinit_vjp_cuda("reinit_step_vjp_banded", phi, sign_src, g, dx, h,
                           None, active, None, eps_scale, eps_floor,
                           quirk_y_p5_zero)
    reinit_step_vjp_banded.launches += 1
    return res


reinit_step_vjp_banded.launches = 0


def reinit_step_block_vjp(pad, sign_pad, g_pad, dx, h, geom: BlockGeom, *,
                          active=None, scratch=None, eps_scale=1e-6,
                          eps_floor=None, quirk_y_p5_zero=False):
    """VJP of one block-mode step at one shard's padded block (K5's block
    mode, the TPU kernel's ``offsets``; with ``active`` also its banded
    mode): ``pad``, ``sign_pad`` and ``g_pad`` (the upstream cotangent)
    hold the owned box and ``VJP_HALO["reinit"]`` exchanged cells around
    it; ``geom`` places the array and anchors the brick grid of ``active``.

    Returns ``(cot_phi, cot_sign, cot_dx, cot_h)`` for the OWNED cells:
    fields of the owned box's shape, each cell bitwise the solo kernel's on
    the whole grid, and float64 sums over the owned cells.  ``scratch``: a
    reusable ``pad.shape`` buffer between the two passes."""
    if pad.device.type == "cpu":
        return reinit_step_block_vjp_plain(
            pad, sign_pad, g_pad, dx, h, geom, active=active,
            eps_scale=eps_scale, eps_floor=eps_floor,
            quirk_y_p5_zero=quirk_y_p5_zero)
    res = _reinit_vjp_cuda("reinit_step_block_vjp", pad, sign_pad, g_pad, dx,
                           h, geom, active, scratch, eps_scale, eps_floor,
                           quirk_y_p5_zero)
    reinit_step_block_vjp.launches += 1
    return res


reinit_step_block_vjp.launches = 0


# -------------------------------- pack mode --------------------------------

def packed_vector(h, batch, dtype, device) -> torch.Tensor:
    """A per-geometry step as the pack kernels take it: a (B,) tensor on
    ``device`` (a scalar is broadcast), each entry rounded once in
    ``dtype`` on the host, as :func:`step_scalars` rounds a solo step's h,
    so that a packed step and a solo step with the same h agree bitwise.
    A (B,) tensor already in ``dtype`` on ``device`` is taken as it is."""
    if (isinstance(h, torch.Tensor) and h.dtype == dtype
            and h.device == torch.device(device)
            and tuple(h.shape) == (batch,)):
        return h.contiguous()
    if isinstance(h, torch.Tensor):
        h = h.detach().cpu().double().numpy()
    v = np.broadcast_to(np.asarray(h, np.float64).astype(np_dtype(dtype)),
                        (batch,))
    return torch.tensor(v, device=device)


def live_vector(live, batch, device) -> torch.Tensor:
    """The (B,) int32 mask of geometries that step (0: frozen)."""
    v = torch.as_tensor(live, device=device).to(torch.int32).contiguous()
    if tuple(v.shape) != (batch,):
        raise ValueError(f"live must have shape ({batch},), got "
                         f"{tuple(v.shape)}")
    return v


def check_packed(name, phi, out, inputs=()):
    """Raise on what the pack kernels do not take: a (B, nx, ny, nz) stack
    of float32 grids, each one a grid the solo kernel takes, with the B
    geometries' x-bricks on the launch grid's z axis (at most 65,535)."""
    if phi.dim() != 4:
        raise ValueError(f"{name}: a packed batch is (B, nx, ny, nz), got "
                         f"{tuple(phi.shape)}")
    if phi.shape[0] * brick_grid(phi.shape[1:])[0] > 65535:
        raise ValueError(f"{name}: batch {phi.shape[0]} too large for "
                         f"{tuple(phi.shape[1:])} grids in one launch")
    check_cuda(name, phi[0], out[0], None)
    for t in (phi, *inputs, out):
        if (t.dtype != torch.float32 or t.shape != phi.shape
                or t.device != phi.device or not t.is_contiguous()):
            raise ValueError(f"{name}: every field must be a contiguous "
                             f"float32 tensor of shape {tuple(phi.shape)} "
                             f"on {phi.device}")
    if any(out.data_ptr() == t.data_ptr() for t in (phi, *inputs)):
        raise ValueError(f"{name}: out must not alias an input")


def run_packed_plain(phi, out, live, with_rms, step):
    """A pack mode's plain version: ``step(g, out_g, with_rms)`` (a solo
    plain step of geometry g into ``out_g``) for each live geometry; a
    frozen one is copied, its sum 0."""
    b = phi.shape[0]
    if out is None:
        out = torch.empty_like(phi)
    dsq = torch.zeros(b, dtype=torch.float64, device=phi.device)
    for g, on in enumerate(live_vector(live, b, "cpu").tolist()):
        if not on:
            out[g].copy_(phi[g])
        elif with_rms:
            dsq[g] = step(g, out[g], True)[1]
        else:
            step(g, out[g], False)
    return (out, dsq) if with_rms else out


def reinit_step_packed_plain(phi, sign_src, dx, h, live, *, out=None,
                             with_rms=False, eps_scale=1e-6, eps_floor=None,
                             quirk_y_p5_zero=False):
    """The plain version of :func:`reinit_step_packed` (any dtype, any
    device): the solo plain step per live geometry."""
    hv = packed_vector(h, phi.shape[0], phi.dtype, "cpu").tolist()
    return run_packed_plain(phi, out, live, with_rms, lambda g, o, rms: (
        reinit_step_plain(phi[g], sign_src[g], dx, hv[g],
                          eps_scale=eps_scale, eps_floor=eps_floor,
                          quirk_y_p5_zero=quirk_y_p5_zero, out=o,
                          with_rms=rms)))


def reinit_step_packed(phi, sign_src, dx, h, live, *, out=None,
                       with_rms=False, eps_scale=1e-6, eps_floor=None,
                       quirk_y_p5_zero=False,
                       bufs: Optional[SolveBuffers] = None):
    """One dense reinit step of each of B same-shape geometries in ONE
    launch (K1's pack mode; replaces the TPU kernel's ``pack`` argument).

    ``phi``, ``sign_src`` and ``out`` are ``(B, nx, ny, nz)``; ``h`` is a
    per-geometry step (a (B,) float32 tensor on the device, or anything
    :func:`packed_vector` rounds into one); ``live`` a (B,) mask: a frozen
    geometry (0) is copied unchanged, faces included, and its sum is 0.
    Each live geometry equals a solo :func:`reinit_step` with its h
    bitwise.  Returns ``out``, or ``(out, dsq)`` with the (B,) float64
    per-geometry sums of squared changes when ``with_rms``.  ``bufs``:
    :func:`solve_buffers` of ``phi`` with ``packed=True``."""
    if phi.device.type == "cpu":
        return reinit_step_packed_plain(
            phi, sign_src, dx, h, live, out=out, with_rms=with_rms,
            eps_scale=eps_scale, eps_floor=eps_floor,
            quirk_y_p5_zero=quirk_y_p5_zero)
    if out is None:
        out = torch.empty_like(phi)
    check_packed("reinit_step_packed", phi, out, (sign_src,))
    b = phi.shape[0]
    hv = packed_vector(h, b, phi.dtype, phi.device)
    lv = live_vector(live, b, phi.device)
    sc = step_scalars(phi.dtype, dx, 0.0, eps_scale, eps_floor)
    partials, dsq, _, stream = _sum_args(
        "reinit_step_packed", phi, with_rms, bufs, packed=True)
    with on_device(phi.device):
        cuda_build.launch(
            "lsf_reinit_step_packed_f32", phi.data_ptr(),
            sign_src.data_ptr(), out.data_ptr(), *phi.shape, sc["dx"],
            hv.data_ptr(), sc["dx2"], sc["inv_dx2"], sc["eps_scale"],
            sc["eps_floor"], int(quirk_y_p5_zero), lv.data_ptr(),
            ptr(partials), ptr(dsq), stream)
    reinit_step_packed.launches += 1
    return (out, dsq) if with_rms else out


reinit_step_packed.launches = 0


def reinit_scan_packed(phis, dx, h, steps: int, *, eps_scale=1e-6,
                       eps_floor=None, quirk_y_p5_zero=False):
    """``steps`` packed reinit steps of every geometry, the sign source
    frozen at ``phis`` (``weno_pallas.py:reinit_scan_pallas_packed``, the
    fixed-step serving scan); ``h`` scalar or per geometry."""
    b = phis.shape[0]
    hv = packed_vector(h, b, phis.dtype, phis.device)
    live = torch.ones(b, dtype=torch.int32, device=phis.device)
    bufs = (torch.empty_like(phis), torch.empty_like(phis))
    p = phis
    for n in range(steps):
        p = reinit_step_packed(p, phis, dx, hv, live, out=bufs[n % 2],
                               eps_scale=eps_scale, eps_floor=eps_floor,
                               quirk_y_p5_zero=quirk_y_p5_zero)
    return p if steps else phis.clone()


# ---------------------- differentiable narrow-band scan ---------------------

def chunk_lengths(steps: int, refresh_every: int) -> list:
    """Steps per mask refresh: chunks of ``min(refresh_every, steps)``, the
    remainder last (``weno_pallas.py:2412-2413``)."""
    if steps <= 0:
        return []
    r = min(int(refresh_every), int(steps))
    return [r] * (steps // r) + ([steps % r] if steps % r else [])


class _ReinitScanBanded(torch.autograd.Function):
    """``steps`` banded K1 steps, the mask refreshed per chunk from the
    chunk-start iterate (8^3 ``band4`` bricks, drift margin ``nsteps h /
    dx`` cells), the sign source frozen at ``phi0``.  The forward keeps the
    chunk-start iterates; the backward recomputes each chunk's mask and
    trajectory, last chunk first, and runs K5's banded mode per step in
    reverse (``weno_pallas.py:2403-2489``)."""

    @staticmethod
    def forward(ctx, phi0, dx, h, steps, refresh_every, band_radius, kw):
        dxf, hf = float(dx), float(h)
        ctx.chunks = chunk_lengths(steps, refresh_every)
        ctx.starts = []
        p = phi0
        for n in ctx.chunks:
            ctx.starts.append(p)
            active = tile_activity(p, dxf, band_radius, n * hf / dxf,
                                   window="band4")
            for _ in range(n):
                p = reinit_step(p, phi0, dxf, hf, active=active, **kw)
        ctx.save_for_backward(phi0)
        ctx.args = (dxf, hf, band_radius, kw)
        ctx.meta = (reverse.scalar_meta(dx), reverse.scalar_meta(h))
        return p if ctx.chunks else phi0.clone()

    @staticmethod
    def backward(ctx, g):
        phi0, = ctx.saved_tensors
        dxf, hf, band_radius, kw = ctx.args
        zero = torch.zeros((), dtype=torch.float64, device=phi0.device)
        gp, cs, cdx, ch = g.contiguous(), torch.zeros_like(phi0), zero, zero
        for p, n in zip(reversed(ctx.starts), reversed(ctx.chunks)):
            active = tile_activity(p, dxf, band_radius, n * hf / dxf,
                                   window="band4")
            traj = [p]
            for _ in range(n - 1):
                traj.append(reinit_step(traj[-1], phi0, dxf, hf,
                                        active=active, **kw))
            for p_in in reversed(traj):
                gp, csi, cdxi, chi = reinit_step_vjp_banded(
                    p_in, phi0, gp, dxf, hf, active, **kw)
                cs, cdx, ch = cs + csi, cdx + cdxi, ch + chi
        ctx.starts = None
        # the sign source IS phi0: both cotangent paths land on it
        return (gp + cs, reverse.scalar_cotangent(ctx.meta[0], cdx),
                reverse.scalar_cotangent(ctx.meta[1], ch), None, None, None,
                None)


def reinit_scan_banded(phi0, dx, h, steps: int, *, band_radius=8.1,
                       refresh_every: int = 8, eps_scale=1e-6,
                       eps_floor=None, quirk_y_p5_zero=False):
    """Differentiable narrow-band fixed-step reinit — the port of
    ``weno_pallas.py:reinit_scan_pallas_banded`` at 8^3-brick granularity:
    the banded forward kernel (K1, frozen bricks copy their cells, face
    cells keep the ghost BC) and its exact transpose (K5's banded mode),
    reverse-mode differentiable in ``phi0`` and (as 0-d tensors) ``dx`` and
    ``h``.  Gradients are exact for the banded forward."""
    kw = dict(eps_scale=eps_scale, eps_floor=eps_floor,
              quirk_y_p5_zero=quirk_y_p5_zero)
    return _ReinitScanBanded.apply(phi0, dx, h, int(steps),
                                   int(refresh_every), float(band_radius), kw)
