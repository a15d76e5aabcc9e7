"""Central finite-difference first/second derivatives, orders 1-8 (port of
``levelsetfortran_tpu/ops/derivs.py``; reference ``subs.f90:213-407``).
The order-8 y-stencil typo and the order-1 plus-sign bug are fixed by
default and reproducible through the quirk flags."""

from __future__ import annotations

import torch

from .stencil import shift

_CENTRAL_COEFFS = {
    2: (1.0 / 2.0,),
    4: (8.0 / 12.0, -1.0 / 12.0),
    6: (3.0 / 4.0, -3.0 / 20.0, 1.0 / 60.0),
    8: (4.0 / 5.0, -1.0 / 5.0, 4.0 / 105.0, -1.0 / 280.0),
}


def _central_axis(phi, axis, dx, order):
    out = torch.zeros_like(phi)
    for r, c in enumerate(_CENTRAL_COEFFS[order], start=1):
        out = out + c * (shift(phi, axis, r) - shift(phi, axis, -r))
    return out / dx


def _order8_y_quirk(phi, dx):
    """Reference-as-written order-8 y derivative (subs.f90:345-346)."""
    c = [1.0 / 280.0, -4.0 / 105.0, 1.0 / 5.0, -4.0 / 5.0,
         4.0 / 5.0, -1.0 / 5.0, 4.0 / 105.0, -1.0 / 280.0]

    def s(o):
        return shift(phi, 1, o)

    return (c[0] * s(-4) + c[1] * s(-3) + c[2] * s(-2) + c[3] * s(-1)
            + c[4] * s(1) + c[5] * s(1) + c[6] * s(3) + c[7] * s(4)) / dx


def _order1_axis(phi, axis, dx, plus_sign_quirk=False):
    """'Order 1' branch (subs.f90:224-242)."""
    fwd_larger = shift(phi, axis, 1) > phi
    if plus_sign_quirk:
        fwd = (phi + shift(phi, axis, 1)) / dx
    else:
        fwd = (shift(phi, axis, 1) - phi) / dx
    bwd = (phi - shift(phi, axis, -1)) / dx
    return torch.where(fwd_larger, fwd, bwd)


def first_derivative(phi, dx, order: int = 2, *, quirk_deriv8_y=False,
                     quirk_deriv1_plus=False):
    """(grad (..., 3), |grad|) — the vectorized ``firstDeriv``."""
    if order == 1:
        comps = [_order1_axis(phi, a, dx, quirk_deriv1_plus)
                 for a in range(3)]
    elif order in _CENTRAL_COEFFS:
        comps = [_central_axis(phi, a, dx, order) for a in range(3)]
        if order == 8 and quirk_deriv8_y:
            comps[1] = _order8_y_quirk(phi, dx)
    else:
        raise ValueError(f"derivative order {order} not supported "
                         "(reference STOPs here too: subs.f90:352-353)")
    mag = torch.sqrt(comps[0] ** 2 + comps[1] ** 2 + comps[2] ** 2)
    return torch.stack(comps, dim=-1), mag


def second_derivative(phi, dx, order: int = 2):
    """((phiXX, phiYY, phiZZ), (phiXY, phiXZ, phiYZ)) (subs.f90:382-398)."""
    if order != 2:
        raise ValueError("only order-2 second derivatives are defined "
                         "(subs.f90:400-403)")
    inv_dx2 = 1.0 / (dx * dx)

    def d2(axis):
        return (shift(phi, axis, 1) - 2.0 * phi
                + shift(phi, axis, -1)) * inv_dx2

    def dmix(a, b):
        pp = shift(shift(phi, a, 1), b, 1)
        pm = shift(shift(phi, a, 1), b, -1)
        mp = shift(shift(phi, a, -1), b, 1)
        mm = shift(shift(phi, a, -1), b, -1)
        return (pp - pm - mp + mm) * inv_dx2 / 4.0

    pure = torch.stack([d2(0), d2(1), d2(2)], dim=-1)
    mixed = torch.stack([dmix(0, 1), dmix(0, 2), dmix(1, 2)], dim=-1)
    return pure, mixed


def laplacian(phi, dx):
    """Sum of pure second derivatives (the curvature proxy of subs.f90:461)."""
    pure, _ = second_derivative(phi, dx)
    return pure.sum(dim=-1)
