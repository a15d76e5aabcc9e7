"""Min/max curvature-flow smoothing loop (port of
``levelsetfortran_tpu/solvers/minmax_flow.py``; reference
``set3d.f90:394-462``): explicit Euler on the narrow band with the min/max
RHS and whole-grid RMS steady-state detection.  Steps are kernels K3/K4
(:mod:`..ops.minmax_cuda`) on a CUDA tensor and their plain versions on a
CPU tensor.  :func:`minmax_flow_fixed` is the differentiable fixed-step
solve, with kernel K6 in its backward.  bfloat16 and float64 fields run
the kernels' plain versions, on the device they lie on
(:func:`..ops.weno_cuda.route`, the dtype term of
``minmax_pallas_applicable``).

The options ``avg_halfwidth`` other than 1 and ``use_true_curvature`` have
no kernel, in the JAX package neither (``minmax_pallas_applicable``): they
take the whole-grid :func:`minmax_step` in plain tensor ops, on the card as
on the CPU.  The route follows from the options and the dtype, never
from a failure.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..ops import minmax_cuda, reverse
from ..ops.band import narrow_band
from ..ops.minmax import minmax_rhs
from ..ops.stencil import interior_mask
from ..ops.reverse import remat_scan
from ..ops.weno_cuda import route, solve_buffers, tile_activity
from ..utils.profiling import span
from .converge import converge, step_rms, stops


class MinMaxResult(NamedTuple):
    phi: torch.Tensor
    iterations: int
    final_rms: float
    diverged: bool


def kernel_form(avg_halfwidth=1, use_true_curvature=False) -> bool:
    """Whether the min/max solvers take the kernels' step, K3/K4/K6 or
    their plain versions (the options' term of
    ``minmax_pallas_applicable``): the default options only.  Which of the
    two follows from the field's dtype (:func:`..ops.weno_cuda.route`)."""
    return avg_halfwidth == 1 and not use_true_curvature


def minmax_step(phi, dx, h1, *, band_radius=4.1, threshold=0.0,
                avg_halfwidth=1, use_true_curvature=False):
    """One Jacobi min/max Euler step gated by the band and the interior, in
    the JAX package's whole-grid form (any option)."""
    nb, _ = narrow_band(phi, dx, band_radius, band_radius)
    f = minmax_rhs(phi, dx, threshold=threshold, avg_halfwidth=avg_halfwidth,
                   use_true_curvature=use_true_curvature)
    gate = nb & interior_mask(phi.shape, 1, device=phi.device)
    return torch.where(gate, phi + h1 * f, phi)


def minmax_flow(phi0, dx, h1, iters: int, tol, *, band_radius=4.1,
                threshold=0.0, avg_halfwidth=1, use_true_curvature=False,
                metrics_every: int = 0) -> MinMaxResult:
    """Up to ``iters`` dense steps with RMS early exit; a ``"minmax"``
    metrics event every ``metrics_every`` steps.  The default options run
    kernel K3; the others have no kernel (as in the JAX package) and run
    :func:`minmax_step`."""
    if kernel_form(avg_halfwidth, use_true_curvature):
        step = route(phi0, minmax_cuda.minmax_step,
                     minmax_cuda.minmax_step_plain)
        bufs = (torch.empty_like(phi0), torch.empty_like(phi0))
        sums = solve_buffers(phi0)

        def advance(p, n):
            new, dsq = step(p, dx, h1, band_radius, threshold,
                            out=bufs[n % 2], with_rms=True, bufs=sums)
            return new, 1, dsq, None
    else:
        def advance(p, n):
            new = minmax_step(p, dx, h1, band_radius=band_radius,
                              threshold=threshold,
                              avg_halfwidth=avg_halfwidth,
                              use_true_curvature=use_true_curvature)
            d = (new - p).double()
            return new, 1, (d * d).sum(), None
    with span("lsf.minmax"):
        return MinMaxResult(*converge(
            advance, phi0, iters, tol, stage="minmax", shape=phi0.shape,
            metrics_every=metrics_every))


def minmax_flow_narrowband(phi0, dx, h1, iters: int, tol, *,
                           band_radius=4.1, threshold=0.0,
                           refresh_every: int = 16,
                           metrics_every: int = 0) -> MinMaxResult:
    """Narrow-band min/max flow on the fused-K kernel (``minmax_flow.py:
    155-316`` of the JAX package); equal to the dense solve bitwise.

    K = 4 fused steps per call (1 on grids thinner than 16), ``1 + 2 *
    pairs`` calls per chunk (a mint call, then zero-copy ping-pong pairs),
    the ``owned`` brick mask refreshed per chunk (exact: a cell updates
    only when its own value is in band).  Full chunks run while they fit;
    an exact single-step tail (kernel K3) finishes the count.  Metrics
    events (``"minmax_narrowband"``) fire at chunk ends, ``metrics_every``
    rounded to a whole number of chunks; the tail emits none.
    """
    if iters <= 0:
        return MinMaxResult(phi0, 0, math.inf, False)
    K = 4 if min(phi0.shape) >= 16 else 1
    calls = 1 + 2 * max(0, (refresh_every // K) // 2)
    chunk = K * calls
    args = (dx, h1, band_radius, threshold)
    fusedk = route(phi0, minmax_cuda.minmax_fusedk,
                   minmax_cuda.minmax_fusedk_plain)
    q = torch.empty_like(phi0)

    def advance(p, n):
        nonlocal q
        active = tile_activity(p, dx, band_radius, window="owned")
        for c in range(calls):
            r = fusedk(p, *args, ksteps=K, active=active, out=q,
                       mint=c == 0, with_rms=c == calls - 1)
            p, q = q, p
        return p, chunk, r[1], active
    with span("lsf.minmax_narrowband"):   # never write into phi0
        p, n, rms, diverged = converge(
            advance, phi0.clone(), iters // chunk * chunk, tol,
            stage="minmax_narrowband", shape=phi0.shape,
            metrics_every=metrics_every, chunk=chunk)
        if n < iters and not stops(rms, tol):
            active = tile_activity(p, dx, band_radius, window="owned")
            sums = solve_buffers(p)
            step = route(p, minmax_cuda.minmax_step,
                         minmax_cuda.minmax_step_plain)
            for _ in range(iters - n):
                _, dsq = step(p, *args, active=active, out=q, with_rms=True,
                              bufs=sums)
                p, q = q, p
            n, rms = iters, step_rms(dsq, phi0.shape)
            diverged = math.isnan(rms)
        return MinMaxResult(p, n, rms, diverged)


class _MinmaxFixed(torch.autograd.Function):
    """``steps`` dense K3 steps; the backward runs K6 per step in reverse
    over the stashed (flat) or recomputed (sqrt-N) trajectory
    (``minmax_pallas.py:1049-1120``)."""

    @staticmethod
    def forward(ctx, phi0, dx, h1, band_radius, threshold, steps):
        args = (float(dx), float(h1), float(band_radius), float(threshold))
        step = route(phi0, minmax_cuda.minmax_step,
                     minmax_cuda.minmax_step_plain)
        p, ctx.traj = reverse.run_forward(lambda q: step(q, *args), phi0,
                                          steps)
        ctx.save_for_backward(phi0)
        ctx.args = (args, steps)
        ctx.meta = tuple(reverse.scalar_meta(x)
                         for x in (dx, h1, band_radius, threshold))
        return p if steps else phi0.clone()

    @staticmethod
    def backward(ctx, g):
        phi0, = ctx.saved_tensors
        args, steps = ctx.args

        step = route(phi0, minmax_cuda.minmax_step,
                     minmax_cuda.minmax_step_plain)
        vjp = route(phi0, minmax_cuda.minmax_step_vjp,
                    minmax_cuda.minmax_step_vjp_plain)

        def fstep(p):
            return step(p, *args)

        bufs = minmax_cuda.VjpBuffers(phi0, *args)

        def bstep(gp, p_in):
            return vjp(p_in, gp, *args, bufs=bufs)[0]

        zero = torch.zeros((), dtype=torch.float64, device=phi0.device)
        with span("lsf.minmax_fixed.backward"):
            gp = reverse.run_reverse("minmax_flow_fixed", fstep, bstep,
                                     phi0, g.contiguous(), steps, ctx.traj)
        cdx, ch = bufs.sums[0], bufs.sums[1]
        ctx.traj = None
        # band_radius and threshold enter through comparisons only
        return (gp, reverse.scalar_cotangent(ctx.meta[0], cdx),
                reverse.scalar_cotangent(ctx.meta[1], ch),
                reverse.scalar_cotangent(ctx.meta[2], zero),
                reverse.scalar_cotangent(ctx.meta[3], zero), None)


def minmax_flow_fixed(phi0, dx, h1, steps: int, *, band_radius=4.1,
                      threshold=0.0, avg_halfwidth=1,
                      use_true_curvature=False):
    """``steps`` dense min/max steps, reverse-mode differentiable in
    ``phi0`` and (as 0-d tensors) ``dx``, ``h1``, ``band_radius`` and
    ``threshold`` — the port of ``solvers/minmax_flow.py:minmax_flow_fixed``.
    Default options: its fused-kernel route, kernel K3 per step forward and
    kernel K6 per step backward (their plain versions on a CPU tensor, and
    for bfloat16 and float64 on any device).  Other options: its jnp
    route, the plain :func:`minmax_step` under autograd, each step
    checkpointed (:func:`~..ops.reverse.remat_scan`), so the backward keeps
    one field per step; ``band_radius`` and ``threshold`` enter through
    comparisons only and get no gradient there."""
    with span("lsf.minmax_fixed"):
        if kernel_form(avg_halfwidth, use_true_curvature):
            return _MinmaxFixed.apply(phi0, dx, h1, band_radius, threshold,
                                      int(steps))
        return remat_scan(lambda p: minmax_step(
            p, dx, h1, band_radius=band_radius, threshold=threshold,
            avg_halfwidth=avg_halfwidth,
            use_true_curvature=use_true_curvature), phi0, steps)
