"""HJ-WENO5 upwind derivatives + Godunov Hamiltonian (port of
``levelsetfortran_tpu/ops/weno.py``; reference ``subs.f90:489-711``).

Deep interior (``i>3 .AND. i<n-4`` in all three axes jointly): fifth-order
Jiang–Peng WENO one-sided derivatives with the scaled epsilon
``1e-6 * max(p_k^2) + eps_floor``; elsewhere first-order one-sided
differences; Godunov selection keeping the squared one-sided derivatives.
Whole-grid tensor expressions; the reinit solvers run the fused form of the
same step in :mod:`.weno_cuda`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .stencil import interior_mask, shift


class WenoDerivs(NamedTuple):
    """One-sided derivative pairs per axis: minus ~ D^-phi, plus ~ D^+phi."""
    minus: tuple
    plus: tuple


def _weno5_axis(phi, axis, dx, eps_scale, eps_floor, p5_zero=False):
    """Fifth-order WENO one-sided derivative pair along ``axis``
    (subs.f90:509-552)."""
    def s(off):
        return shift(phi, axis, off)

    inv_dx = 1.0 / dx
    p0 = (s(-2) - s(-3)) * inv_dx
    p1 = (s(-1) - s(-2)) * inv_dx
    p2 = (phi - s(-1)) * inv_dx
    p3 = (s(1) - phi) * inv_dx
    p4 = (s(2) - s(1)) * inv_dx
    p5 = (s(3) - s(2)) * inv_dx
    p5_eps = torch.zeros_like(phi) if p5_zero else p5

    ap, am = p5 - p4, p1 - p0
    bp, bm = p4 - p3, p2 - p1
    cp = p3 - p2
    cm, dp, dm = cp, bm, bp

    def smooth(x, y, c):
        return 13.0 * (x - y) ** 2 + 3.0 * c ** 2

    is0p = smooth(ap, bp, ap - 3.0 * bp)
    is0m = smooth(am, bm, am - 3.0 * bm)
    is1p = smooth(bp, cp, bp + cp)
    is1m = smooth(bm, cm, bm + cm)
    is2p = smooth(cp, dp, 3.0 * cp - dp)
    is2m = smooth(cm, dm, 3.0 * cm - dm)

    def maxsq(*xs):
        out = xs[0] * xs[0]
        for x in xs[1:]:
            out = torch.maximum(out, x * x)
        return out

    epsp = eps_scale * maxsq(p1, p2, p3, p4, p5_eps) + eps_floor
    epsm = eps_scale * maxsq(p0, p1, p2, p3, p4) + eps_floor
    ratio_floor = 1e-70 if phi.dtype == torch.float64 else 1e-7

    def weights(eps, is0, is1, is2):
        d0, d1, d2 = eps + is0, eps + is1, eps + is2
        inv_max = 1.0 / torch.maximum(d0, torch.maximum(d1, d2))
        d0 = torch.clamp_min(d0 * inv_max, ratio_floor)
        d1 = torch.clamp_min(d1 * inv_max, ratio_floor)
        d2 = torch.clamp_min(d2 * inv_max, ratio_floor)
        t0 = (d1 * d2) ** 2
        t1 = 6.0 * (d0 * d2) ** 2
        t2 = 3.0 * (d0 * d1) ** 2
        r = 1.0 / (t0 + t1 + t2)
        return t0 * r, t2 * r

    w0p, w2p = weights(epsp, is0p, is1p, is2p)
    w0m, w2m = weights(epsm, is0m, is1m, is2m)
    third, sixth = 1.0 / 3.0, 1.0 / 6.0
    pwp = (w0p * (ap - 2.0 * bp + cp) * third
           + (w2p - 0.5) * (bp - 2.0 * cp + dp) * sixth)
    pwm = (w0m * (am - 2.0 * bm + cm) * third
           + (w2m - 0.5) * (bm - 2.0 * cm + dm) * sixth)
    common = (-p1 + 7.0 * p2 + 7.0 * p3 - p4) * (1.0 / 12.0)
    return common - pwm, common + pwp


def _first_order_axis(phi, axis, dx):
    """First-order one-sided pair (boundary fallback, subs.f90:657-662)."""
    inv_dx = 1.0 / dx
    return ((phi - shift(phi, axis, -1)) * inv_dx,
            (shift(phi, axis, 1) - phi) * inv_dx)


def default_eps_floor(dtype) -> float:
    """1e-99 in float64 (``subs.f90:533``); 1e-18 in float32, whose square
    would otherwise underflow the weight denominators."""
    return 1e-99 if dtype == torch.float64 else 1e-18


def weno_derivatives(phi, dx, *, eps_scale=1e-6, eps_floor=None,
                     quirk_y_p5_zero=False, deep_mask=None) -> WenoDerivs:
    """Per-axis one-sided pairs with the joint deep-interior-or-first-order
    selection (subs.f90:506,646-664)."""
    if eps_floor is None:
        eps_floor = default_eps_floor(phi.dtype)
    deep = (interior_mask(phi.shape, 4, device=phi.device)
            if deep_mask is None else deep_mask)
    minus, plus = [], []
    for axis in range(3):
        w_m, w_p = _weno5_axis(phi, axis, dx, eps_scale, eps_floor,
                               p5_zero=(quirk_y_p5_zero and axis == 1))
        f_m, f_p = _first_order_axis(phi, axis, dx)
        minus.append(torch.where(deep, w_m, f_m))
        plus.append(torch.where(deep, w_p, f_p))
    return WenoDerivs(minus=tuple(minus), plus=tuple(plus))


def godunov_select(phi, derivs: WenoDerivs, switch=None):
    """Godunov upwinding by the sign of ``switch`` (default phi; solvers
    pass the frozen sign source).  Returns (grad_mag, grad_sq (..., 3))."""
    pos = (phi if switch is None else switch) > 0.0
    comps = []
    for axis in range(3):
        m, p = derivs.minus[axis], derivs.plus[axis]
        g_pos = torch.maximum(torch.clamp_min(m, 0.0) ** 2,
                              torch.clamp_max(p, 0.0) ** 2)
        g_neg = torch.maximum(torch.clamp_min(p, 0.0) ** 2,
                              torch.clamp_max(m, 0.0) ** 2)
        comps.append(torch.where(pos, g_pos, g_neg))
    total = comps[0] + comps[1] + comps[2]
    return torch.sqrt(total), torch.stack(comps, dim=-1)


def weno_godunov(phi, dx, *, eps_scale=1e-6, eps_floor=None,
                 quirk_y_p5_zero=False, deep_mask=None, switch=None):
    """Fused |grad phi| via WENO5 + Godunov — the north-star operator."""
    d = weno_derivatives(phi, dx, eps_scale=eps_scale, eps_floor=eps_floor,
                         quirk_y_p5_zero=quirk_y_p5_zero, deep_mask=deep_mask)
    return godunov_select(phi, d, switch=switch)
