"""Eikonal reinitialization: pseudo-time integration of
``phi_t = sgn(phi_0)(1 - |grad phi|)`` (port of
``levelsetfortran_tpu/solvers/reinit.py``; reference ``subs.f90:717-931``).

Jacobi steps, interior-only update, ghost-extrapolation BC, RMS over the
reference's ``(nx-1)(ny-1)(nz-1)`` denominator, early exit below ``tol``
and a NaN flag.  Each step is kernel K1 (:mod:`..ops.weno_cuda`) on a CUDA
tensor and its plain version on a CPU tensor; the loops are Python loops
that read the RMS scalar to the host once per check.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..ops import weno_cuda
from ..ops.sign import smeared_sign
from ..ops.stencil import boundary_extrapolate, interior_mask
from ..ops.weno import weno_godunov


class ReinitResult(NamedTuple):
    phi: torch.Tensor
    iterations: int
    final_rms: float
    diverged: bool


def reinit_step(phi, phi_sign_src, dx, h, *, eps_scale=1e-6, eps_floor=None,
                quirk_y_p5_zero=False):
    """One Jacobi step in the JAX package's whole-grid form (the fused form
    the solvers run is :func:`..ops.weno_cuda.reinit_step`)."""
    grad_mag, _ = weno_godunov(phi, dx, eps_scale=eps_scale,
                               eps_floor=eps_floor,
                               quirk_y_p5_zero=quirk_y_p5_zero,
                               switch=phi_sign_src)
    sgn = smeared_sign(phi_sign_src, dx, grad_mag)
    update = phi + h * sgn * (1.0 - grad_mag)
    phi = torch.where(interior_mask(phi.shape, 1, phi.device), update, phi)
    return boundary_extrapolate(phi, dx)


def rms_denominator(shape) -> int:
    """The reference's nx*ny*nz, i.e. points-1 per axis (subs.f90:914)."""
    return (shape[0] - 1) * (shape[1] - 1) * (shape[2] - 1)


def reinit(phi0, dx, h, iters: int, tol, *, sign_src=None, eps_scale=1e-6,
           eps_floor=None, quirk_y_p5_zero=False) -> ReinitResult:
    """Up to ``iters`` dense steps, stopping at RMS < tol or NaN."""
    sign = phi0 if sign_src is None else sign_src
    denom = rms_denominator(phi0.shape)
    bufs = (torch.empty_like(phi0), torch.empty_like(phi0))
    p, n, rms = phi0, 0, math.inf
    while n < iters:
        p, dsq = weno_cuda.reinit_step(
            p, sign, dx, h, eps_scale=eps_scale, eps_floor=eps_floor,
            quirk_y_p5_zero=quirk_y_p5_zero, out=bufs[n % 2], with_rms=True)
        n += 1
        rms = math.sqrt(dsq.item() / denom)
        if rms < tol or math.isnan(rms):
            break
    return ReinitResult(p, n, rms, math.isnan(rms))


def reinit_narrowband(phi0, dx, h, iters: int, tol, *, band_radius=8.1,
                      refresh_every: int = 8, sign_src=None, eps_scale=1e-6,
                      eps_floor=None, quirk_y_p5_zero=False) -> ReinitResult:
    """Narrow-band reinitialization (``reinit.py:185-355`` of the JAX
    package), at 8^3-brick granularity.

    Each chunk refreshes the ``band4`` brick mask with a drift margin of
    ``chunk * h / dx`` cells, runs one "mint" step (inactive bricks copy
    their cells into the other buffer), then ``refresh_every // 2`` pairs
    of ping-pong steps in which inactive bricks write nothing: the buffer
    they write into holds the iterate from two steps ago, whose frozen
    cells are the same.  The chunk's last step carries the fused RMS, so
    iterations advance in chunks of ``1 + 2 * (refresh_every // 2)``.
    Frozen bricks keep their values; in band the field equals the dense
    solver's up to the sub-tolerance far-field residual.
    """
    sign = phi0 if sign_src is None else sign_src
    denom = rms_denominator(phi0.shape)
    pairs = refresh_every // 2
    chunk = 1 + 2 * pairs
    margin = chunk * h / dx
    kw = dict(eps_scale=eps_scale, eps_floor=eps_floor,
              quirk_y_p5_zero=quirk_y_p5_zero)
    p, q = phi0.clone(), torch.empty_like(phi0)   # never write into phi0
    n, rms = 0, math.inf
    while n < iters:
        active = weno_cuda.tile_activity(p, dx, band_radius, margin,
                                         window="band4")
        for s in range(chunk):
            r = weno_cuda.reinit_step(p, sign, dx, h, active=active, out=q,
                                      mint=s == 0,
                                      with_rms=s == chunk - 1, **kw)
            p, q = q, p
        n += chunk
        rms = math.sqrt(r[1].item() / denom)
        if rms < tol or math.isnan(rms):
            break
    return ReinitResult(p, n, rms, math.isnan(rms))
