"""Eikonal reinitialization: pseudo-time integration of
``phi_t = sgn(phi_0)(1 - |grad phi|)`` (port of
``levelsetfortran_tpu/solvers/reinit.py``; reference ``subs.f90:717-931``).

Jacobi steps, interior-only update, ghost-extrapolation BC, RMS over the
reference's ``(nx-1)(ny-1)(nz-1)`` denominator, early exit below ``tol``
and a NaN flag.  Each step is kernel K1 (:mod:`..ops.weno_cuda`) on a CUDA
tensor and its plain version on a CPU tensor, in the loop of
:mod:`.converge`, one host read of the RMS per check.  The route follows
the field's dtype, as the JAX package's ``_use_pallas``: float32 takes
the kernels, bfloat16 and float64 the kernels' plain versions
(:func:`..ops.weno_cuda.route`) on the device the field lies on.
:func:`reinit_fixed` is the differentiable fixed-step solve, with kernel
K5 in its backward.

A ``grad_fn`` (a callable phi -> |grad phi| in place of the WENO5/Godunov
operator) has no kernel, in the JAX package neither (``_use_pallas``): the
solvers then take the whole-grid :func:`reinit_step` in plain tensor ops,
on the card as on the CPU.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import reverse, weno_cuda
from ..ops.reverse import remat_scan
from ..ops.sign import smeared_sign
from ..ops.stencil import boundary_extrapolate, interior_mask
from ..ops.weno import weno_godunov
from ..utils.profiling import count, span
from .converge import converge, rms_denominator  # noqa: F401  (re-exported)


class ReinitResult(NamedTuple):
    phi: torch.Tensor
    iterations: int
    final_rms: float
    diverged: bool


def reinit_step(phi, phi_sign_src, dx, h, *, eps_scale=1e-6, eps_floor=None,
                quirk_y_p5_zero=False, grad_fn=None):
    """One Jacobi step in the JAX package's whole-grid form (the fused form
    the solvers run is :func:`..ops.weno_cuda.reinit_step`); ``grad_fn``
    maps phi to the |grad phi| that replaces the Godunov operator's."""
    if grad_fn is None:
        grad_mag, _ = weno_godunov(phi, dx, eps_scale=eps_scale,
                                   eps_floor=eps_floor,
                                   quirk_y_p5_zero=quirk_y_p5_zero,
                                   switch=phi_sign_src)
    else:
        grad_mag = grad_fn(phi)
    sgn = smeared_sign(phi_sign_src, dx, grad_mag)
    update = phi + h * sgn * (1.0 - grad_mag)
    phi = torch.where(interior_mask(phi.shape, 1, device=phi.device),
                      update, phi)
    return boundary_extrapolate(phi, dx)


def _step(phi):
    """Kernel K1's wrapper, or its plain version where the kernel does not
    take ``phi``'s dtype (``_use_pallas`` of the JAX package)."""
    return weno_cuda.route(phi, weno_cuda.reinit_step,
                           weno_cuda.reinit_step_plain)


def reinit(phi0, dx, h, iters: int, tol, *, sign_src=None, eps_scale=1e-6,
           eps_floor=None, quirk_y_p5_zero=False, grad_fn=None,
           metrics_every: int = 0) -> ReinitResult:
    """Up to ``iters`` dense steps, stopping at RMS < tol or NaN; a
    ``"reinit"`` metrics event every ``metrics_every`` steps.  Kernel K1
    per step (its plain version off float32), or with ``grad_fn`` the
    plain :func:`reinit_step`.  The steps taken go to the counter
    ``reinit.steps`` once the loop has returned."""
    sign = phi0 if sign_src is None else sign_src
    kw = dict(eps_scale=eps_scale, eps_floor=eps_floor,
              quirk_y_p5_zero=quirk_y_p5_zero)
    if grad_fn is None:
        step = _step(phi0)
        bufs = (torch.empty_like(phi0), torch.empty_like(phi0))
        sums = weno_cuda.solve_buffers(phi0)

        def advance(p, n):
            p, dsq = step(p, sign, dx, h, out=bufs[n % 2], with_rms=True,
                          bufs=sums, **kw)
            return p, 1, dsq, None
    else:
        def advance(p, n):
            new = reinit_step(p, sign, dx, h, grad_fn=grad_fn, **kw)
            d = (new - p).double()
            return new, 1, (d * d).sum(), None
    with span("lsf.reinit"):
        res = ReinitResult(*converge(
            advance, phi0, iters, tol, stage="reinit", shape=phi0.shape,
            metrics_every=metrics_every))
    count("reinit.steps", res.iterations)
    return res


def reinit_narrowband(phi0, dx, h, iters: int, tol, *, band_radius=8.1,
                      refresh_every: int = 8, sign_src=None, eps_scale=1e-6,
                      eps_floor=None, quirk_y_p5_zero=False,
                      metrics_every: int = 0) -> ReinitResult:
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
    solver's up to the sub-tolerance far-field residual.  Metrics events
    (``"reinit_narrowband"``) fire at chunk ends: ``metrics_every`` is
    rounded to a whole number of chunks.
    """
    sign = phi0 if sign_src is None else sign_src
    chunk = 1 + 2 * (refresh_every // 2)
    margin = chunk * h / dx
    kw = dict(eps_scale=eps_scale, eps_floor=eps_floor,
              quirk_y_p5_zero=quirk_y_p5_zero,
              bufs=weno_cuda.solve_buffers(phi0))
    step = _step(phi0)
    q = torch.empty_like(phi0)

    def advance(p, n):
        nonlocal q
        active = weno_cuda.tile_activity(p, dx, band_radius, margin,
                                         window="band4")
        for s in range(chunk):
            r = step(p, sign, dx, h, active=active, out=q, mint=s == 0,
                     with_rms=s == chunk - 1, **kw)
            p, q = q, p
        return p, chunk, r[1], active
    with span("lsf.reinit_narrowband"):   # never write into phi0
        return ReinitResult(*converge(
            advance, phi0.clone(), iters, tol, stage="reinit_narrowband",
            shape=phi0.shape, metrics_every=metrics_every, chunk=chunk))


class _ReinitFixed(torch.autograd.Function):
    """``steps`` dense K1 steps from ``phi0`` with the sign source frozen at
    ``phi0``; the backward runs K5 per step in reverse over the stashed
    (flat) or recomputed (sqrt-N) trajectory (``weno_pallas.py:2191-2364``).
    """

    @staticmethod
    def forward(ctx, phi0, dx, h, steps, kw):
        dxf, hf = float(dx), float(h)
        step = _step(phi0)
        p, ctx.traj = reverse.run_forward(
            lambda q: step(q, phi0, dxf, hf, **kw), phi0, steps)
        ctx.save_for_backward(phi0)
        ctx.args = (dxf, hf, steps, kw)
        ctx.meta = (reverse.scalar_meta(dx), reverse.scalar_meta(h))
        return p if steps else phi0.clone()

    @staticmethod
    def backward(ctx, g):
        phi0, = ctx.saved_tensors
        dxf, hf, steps, kw = ctx.args

        step = _step(phi0)
        vjp = weno_cuda.route(phi0, weno_cuda.reinit_step_vjp,
                              weno_cuda.reinit_step_vjp_plain)

        def fstep(p):
            return step(p, phi0, dxf, hf, **kw)

        def bstep(carry, p_in):
            gp, cs, cdx, ch = carry
            cp, csi, cdxi, chi = vjp(p_in, phi0, gp, dxf, hf, **kw)
            return cp, cs + csi, cdx + cdxi, ch + chi

        zero = torch.zeros((), dtype=torch.float64, device=phi0.device)
        carry = (g.contiguous(), torch.zeros_like(phi0), zero, zero)
        with span("lsf.reinit_fixed.backward"):
            gp, cs, cdx, ch = reverse.run_reverse(
                "reinit_fixed", fstep, bstep, phi0, carry, steps, ctx.traj)
        ctx.traj = None
        # the sign source IS phi0: both cotangent paths land on it
        return (gp + cs, reverse.scalar_cotangent(ctx.meta[0], cdx),
                reverse.scalar_cotangent(ctx.meta[1], ch), None, None)


def reinit_fixed(phi0, dx, h, steps: int, *, eps_scale=1e-6, eps_floor=None,
                 quirk_y_p5_zero=False, grad_fn=None):
    """``steps`` dense reinit steps, reverse-mode differentiable in
    ``phi0`` and (as 0-d tensors) ``dx`` and ``h`` — the port of
    ``solvers/reinit.py:reinit_fixed``.  Without ``grad_fn``: its
    fused-kernel route, kernel K1 per step forward and kernel K5 per step
    backward (their plain versions on a CPU tensor, and for bfloat16 and
    float64 on any device).  With ``grad_fn``: its
    jnp route, the plain :func:`reinit_step` under autograd with the sign
    source ``phi0`` in the graph, each step checkpointed
    (:func:`~..ops.reverse.remat_scan`)."""
    kw = dict(eps_scale=eps_scale, eps_floor=eps_floor,
              quirk_y_p5_zero=quirk_y_p5_zero)
    with span("lsf.reinit_fixed"):
        if grad_fn is None:
            return _ReinitFixed.apply(phi0, dx, h, int(steps), kw)
        return remat_scan(lambda p: reinit_step(
            p, phi0, dx, h, grad_fn=grad_fn, **kw), phi0, steps)
