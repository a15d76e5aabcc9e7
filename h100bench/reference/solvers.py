"""The solver stages in plain PyTorch: reinitialization, min/max flow,
node advection.

Reinitialization is the pseudo-time integration of
``phi_t = sgn(phi_0) (1 - |grad phi|)``: HJ-WENO5 with the Godunov flux on
raw differences, the smeared sign, an interior Euler update and the ghost
boundary read after the update (``subs.f90:717-931``).  The min/max flow
is explicit Euler with ``F = min(lap, 0)`` where the 7-point average is
below the threshold, else ``max(lap, 0)``, on cells within the band
(``set3d.f90:394-462``).  Advection walks every surface node down the
order-8 gradient of the smoothed field (``set3d.f90:470-501``).

The banded solves freeze 8^3 bricks far from the surface and check their
stop rule at the end of each chunk of steps; the dense ones check after
every step.  Both stop at an RMS of the step's change below the tolerance,
over the ``(nx-1)(ny-1)(nz-1)`` denominator.  A frozen copy of the
system's plain math, evaluated in its order on scalars rounded once to
float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

BRICK = 8
F32 = np.float32


# ------------------------------ stencil tools ------------------------------

def shift(a, axis: int, off: int):
    return a if off == 0 else torch.roll(a, -off, dims=axis)


def interior_mask(shape, depth: int, device=None):
    masks = []
    for ax, n in enumerate(shape):
        idx = torch.arange(n, device=device)
        m = (idx >= depth) & (idx <= n - 1 - depth)
        bshape = [1, 1, 1]
        bshape[ax] = n
        masks.append(m.reshape(bshape))
    return masks[0] & masks[1] & masks[2]


def clamped_inner(phi):
    out = phi
    for ax, n in enumerate(phi.shape):
        idx = torch.arange(n, device=phi.device).clamp(1, n - 2)
        out = out.index_select(ax, idx)
    return out


def rms_denominator(shape) -> int:
    return (shape[0] - 1) * (shape[1] - 1) * (shape[2] - 1)


# ----------------------------- reinitialization ----------------------------

def reinit_scalars(dx, h, eps_scale=1e-6, eps_floor=1e-18):
    dxv = F32(dx)
    dx2 = dxv * dxv
    scaled = F32(eps_floor) * dx2
    return dict(dx=float(dxv), h=float(F32(h)), dx2=float(dx2),
                inv_dx2=float(F32(1) / dx2), eps_scale=float(F32(eps_scale)),
                eps_floor=float(max(scaled, F32(1e-18))),
                ratio_floor=float(F32(1e-7)), sqrt_floor=float(F32(1e-20)))


def _mx(a, b):
    """max(a, b); a gradient goes to ``a`` on a tie."""
    return torch.where(a >= b, a, b)


def _floor(x, f: float):
    """max(x, f); a gradient goes to ``x`` on a tie."""
    return torch.where(x >= f, x, torch.full_like(x, f))


def _weno5_pair(p0, p1, p2, p3, p4, p5, eps_scale, eps_floor, ratio_floor):
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
    common4 = _mx(_mx(p1 * p1, p2 * p2), _mx(p3 * p3, p4 * p4))
    epsp = eps_scale * _mx(common4, p5 * p5) + eps_floor
    epsm = eps_scale * _mx(common4, p0 * p0) + eps_floor

    def weights(eps, is0, is1, is2):
        d0, d1, d2 = eps + is0, eps + is1, eps + is2
        inv_max = 1.0 / _mx(d0, _mx(d1, d2))
        d0 = _floor(d0 * inv_max, ratio_floor)
        d1 = _floor(d1 * inv_max, ratio_floor)
        d2 = _floor(d2 * inv_max, ratio_floor)
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


def reinit_update(phi, sign_src, sc):
    """One step's Euler-updated field, before the ghost boundary.  Its
    derivative follows the upstream adjoint's conventions: a max sends it
    to its first operand on a tie, |grad phi| has none where it is 0, and
    the sign's floor splits it on a tie."""
    deep = interior_mask(phi.shape, 4, device=phi.device)
    pos = sign_src > 0.0
    total = None
    for axis in range(3):
        vm3, vm2, vm1 = (shift(phi, axis, o) for o in (-3, -2, -1))
        vp1, vp2, vp3 = (shift(phi, axis, o) for o in (1, 2, 3))
        p2, p3 = phi - vm1, vp1 - phi
        w_m, w_p = _weno5_pair(vm2 - vm3, vm1 - vm2, p2, p3, vp2 - vp1,
                               vp3 - vp2, sc["eps_scale"], sc["eps_floor"],
                               sc["ratio_floor"])
        d_m = torch.where(deep, w_m, p2)
        d_p = torch.where(deep, w_p, p3)
        g = torch.where(pos, _floor(_mx(d_m, -d_p), 0.0),
                        _floor(_mx(d_p, -d_m), 0.0))
        total = g * g if total is None else total + g * g
    nz = total > 0.0
    gm = torch.where(nz, torch.sqrt(torch.where(nz, total, 1.0)
                                    * sc["inv_dx2"]), 0.0)
    d2 = sign_src * sign_src + sc["dx2"] * gm
    sg = sign_src / torch.sqrt(torch.maximum(
        d2, torch.full_like(d2, sc["sqrt_floor"])))
    return phi + sc["h"] * sg * (1.0 - gm)


def ghost(upd, dx):
    return torch.where(interior_mask(upd.shape, 1, device=upd.device), upd,
                       clamped_inner(upd) + dx)


def brick_cells(active, shape):
    m = active.bool()
    for ax in range(3):
        m = m.repeat_interleave(BRICK, dim=ax)
    return m[:shape[0], :shape[1], :shape[2]]


def tile_activity(phi, dx, radius_cells, margin_cells=0.0, window="band4"):
    """Bricks whose |phi| minimum over the window lies below
    ``(radius + margin) dx``: the brick's own cells ("owned") or dilated by
    4 cells ("band4")."""
    thresh = float(F32(radius_cells + margin_cells) * F32(dx))
    a = torch.abs(phi)
    inf = float("inf")
    nb = tuple(-(-n // BRICK) for n in phi.shape)
    pad = []
    for n, b in zip(reversed(phi.shape), reversed(nb)):
        pad += [0, b * BRICK - n]
    a = F.pad(a, pad, value=inf)
    half = BRICK // 2
    m1 = a.reshape(2 * nb[0], half, 2 * nb[1], half, 2 * nb[2], half).amin(
        dim=(1, 3, 5))
    if window == "owned":
        m = m1.reshape(nb[0], 2, nb[1], 2, nb[2], 2).amin(dim=(1, 3, 5))
    else:
        m1p = F.pad(m1, (1, 1, 1, 1, 1, 1), value=inf)
        m = -F.max_pool3d(-m1p[None, None], kernel_size=4, stride=2)[0, 0]
    return m < thresh


def _dsq(new, old):
    d = (new - old).double()
    return (d * d).sum()


def reinit_banded(phi0, dx, h, iters: int, tol, *, band_radius=8.1,
                  refresh_every: int = 8):
    """(phi, iterations): chunks of ``1 + 2 (refresh_every // 2)`` steps,
    bricks outside the dilated band frozen for the chunk, the stop rule on
    the chunk's last step."""
    sc = reinit_scalars(dx, h)
    denom = rms_denominator(phi0.shape)
    chunk = 1 + 2 * (refresh_every // 2)
    margin = chunk * h / dx
    p, n = phi0.clone(), 0
    while n < iters:
        live = brick_cells(tile_activity(p, dx, band_radius, margin),
                           p.shape)
        for _ in range(chunk):
            q = ghost(torch.where(live, reinit_update(p, phi0, sc), p),
                      sc["dx"])
            dsq = _dsq(q, p)
            p = q
        n += chunk
        rms = math.sqrt(dsq.item() / denom)
        if rms < tol or math.isnan(rms):
            break
    return p, n


def reinit_dense(phi0, dx, h, iters: int, tol):
    """(phi, iterations): the stop rule after every step."""
    sc = reinit_scalars(dx, h)
    denom = rms_denominator(phi0.shape)
    p, n = phi0, 0
    while n < iters:
        q = ghost(reinit_update(p, phi0, sc), sc["dx"])
        rms = math.sqrt(_dsq(q, p).item() / denom)
        p, n = q, n + 1
        if rms < tol or math.isnan(rms):
            break
    return p, n


def reinit_step(phi, sign_src, dx, h):
    """One dense step (the fixed-step solve's), differentiable."""
    sc = reinit_scalars(dx, h)
    return ghost(reinit_update(phi, sign_src, sc), sc["dx"])


# ------------------------------ min/max flow -------------------------------

def minmax_scalars(dx, h1, band_radius=4.1, threshold=0.0):
    dxv = F32(dx)
    return dict(h1=float(F32(h1)), inv_dx2=float(F32(1) / (dxv * dxv)),
                band_dx=float(F32(band_radius) * dxv),
                threshold=float(F32(threshold)))


def minmax_step(phi, sc):
    """One dense step; its derivative splits min(lap, 0) and max(lap, 0)
    in half on a tie, as the upstream adjoint does."""
    sum6 = (shift(phi, 0, -1) + shift(phi, 0, 1) + shift(phi, 1, -1)
            + shift(phi, 1, 1) + shift(phi, 2, 1) + shift(phi, 2, -1))
    lap = (sum6 - 6.0 * phi) * sc["inv_dx2"]
    pave = (sum6 + phi) * (1.0 / 7.0)
    zero = torch.zeros_like(lap)
    f = torch.where(pave < sc["threshold"], torch.minimum(lap, zero),
                    torch.maximum(lap, zero))
    gate = (interior_mask(phi.shape, 1, device=phi.device)
            & (torch.abs(phi) < sc["band_dx"]))
    return torch.where(gate, phi + sc["h1"] * f, phi)


def minmax_banded(phi0, dx, h1, iters: int, tol, *, band_radius=4.1,
                  refresh_every: int = 16):
    """(phi, iterations): chunks of ``K (1 + 2 pairs)`` steps (K = 4, or 1
    on grids thinner than 16), the stop rule on the chunk's last step, then
    single steps up to ``iters`` if it never stopped."""
    sc = minmax_scalars(dx, h1, band_radius)
    denom = rms_denominator(phi0.shape)
    K = 4 if min(phi0.shape) >= 16 else 1
    chunk = K * (1 + 2 * max(0, (refresh_every // K) // 2))
    p, n, done = phi0.clone(), 0, False
    while not done and n + chunk <= iters:
        live = brick_cells(tile_activity(p, dx, band_radius, window="owned"),
                           p.shape)
        for _ in range(chunk):
            q = torch.where(live, minmax_step(p, sc), p)
            dsq = _dsq(q, p)
            p = q
        n += chunk
        rms = math.sqrt(dsq.item() / denom)
        done = rms < tol or math.isnan(rms)
    while not done and n < iters:
        p, n = minmax_step(p, sc), n + 1
    return p, n


def minmax_dense(phi0, dx, h1, iters: int, tol, *, band_radius=4.1):
    sc = minmax_scalars(dx, h1, band_radius)
    denom = rms_denominator(phi0.shape)
    p, n = phi0, 0
    while n < iters:
        q = minmax_step(p, sc)
        rms = math.sqrt(_dsq(q, p).item() / denom)
        p, n = q, n + 1
        if rms < tol or math.isnan(rms):
            break
    return p, n


# -------------------------------- advection --------------------------------

_ORDER8 = (4.0 / 5.0, -1.0 / 5.0, 4.0 / 105.0, -1.0 / 280.0)


def banded_gradient(phi, dx, stencil_radius=8.1):
    comps = []
    for a in range(3):
        out = torch.zeros_like(phi)
        for r, c in enumerate(_ORDER8, start=1):
            out = out + c * (shift(phi, a, r) - shift(phi, a, -r))
        comps.append(out / dx)
    grad = torch.stack(comps, dim=-1)
    sb = torch.abs(phi) < stencil_radius * dx
    return torch.where(sb[..., None], grad, torch.zeros_like(grad))


def trilinear(field, grid, points):
    """Trilinear sample at world ``points`` (..., 3), clamped to the grid."""
    origin = torch.tensor(grid.origin, dtype=points.dtype,
                          device=points.device)
    f = (points - origin) / grid.dx
    hi = torch.tensor([s - 1 for s in grid.shape], dtype=points.dtype,
                      device=points.device)
    f = torch.minimum(torch.clamp_min(f, 0.0), hi)
    max_idx = torch.tensor([s - 2 for s in grid.shape], device=points.device)
    i0 = torch.minimum(torch.clamp_min(torch.floor(f).long(), 0), max_idx)
    t = f - i0.to(f.dtype)

    def at(di, dj, dk):
        return field[i0[..., 0] + di, i0[..., 1] + dj, i0[..., 2] + dk]

    if field.dim() == 4:
        tx, ty, tz = t[..., 0:1], t[..., 1:2], t[..., 2:3]
    else:
        tx, ty, tz = t[..., 0], t[..., 1], t[..., 2]
    c00 = at(0, 0, 0) * (1 - tx) + at(1, 0, 0) * tx
    c10 = at(0, 1, 0) * (1 - tx) + at(1, 1, 0) * tx
    c01 = at(0, 0, 1) * (1 - tx) + at(1, 0, 1) * tx
    c11 = at(0, 1, 1) * (1 - tx) + at(1, 1, 1) * tx
    c0 = c00 * (1 - ty) + c10 * ty
    c1 = c01 * (1 - ty) + c11 * ty
    return c0 * (1 - tz) + c1 * tz


def _sample(phi, grad, grid, x, mag_eps=1e-7):
    p = trilinear(phi, grid, x)
    g = -trilinear(grad, grid, x)
    q = g * g
    mag2 = (q[..., 0] + q[..., 1] + q[..., 2])[..., None]
    direction = torch.where(
        mag2 < mag_eps, torch.zeros_like(g),
        g / torch.sqrt(torch.clamp_min(mag2, mag_eps * 1e-6)))
    return p, direction


def advect(phi, grid, nodes, dx, iters=1000, eps=1e-13):
    """Every node moved ``iters`` times by ``phi`` along the unit inward
    gradient where its phi is above ``eps``."""
    grad = banded_gradient(phi, dx)
    x = nodes
    for _ in range(iters):
        p, direction = _sample(phi, grad, grid, x)
        move = (p > eps).to(x.dtype)
        x = x + (move * p)[:, None] * direction
    return x
