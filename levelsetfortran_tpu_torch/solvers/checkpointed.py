"""Resumable solver loops: chunked pseudo-time integration with periodic
checkpoints and divergence detection (port of
``levelsetfortran_tpu/solvers/checkpointed.py``).

The reference's only failure handling is STOP-on-NaN (``subs.f90:926``,
``set3d.f90:458``).  Here a solve runs in chunks of iterations; after each
chunk the field and the iteration count are saved (a preempted run resumes
mid-stage), and an RMS that rises over consecutive chunks stops the solve
as diverged.  Each chunk is one call of the plain solver (kernel launches
with one host read of the RMS per check), so the chunk length sets how
often a checkpoint is written, not the cost of a step.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

from ..utils.checkpoint import FieldCheckpointer
from ..utils.logging import log_event
from .minmax_flow import minmax_flow
from .reinit import reinit


@dataclasses.dataclass
class ResumableResult:
    phi: object                     # a tensor, or a list of blocks
    iterations: int
    final_rms: float
    converged: bool
    diverged: bool
    resumed_from: Optional[int]     # step resumed from, None if fresh


def _run_chunked(run_chunk: Callable, phi0, total_iters: int, tol: float,
                 ckpt: Optional[FieldCheckpointer], chunk: int,
                 stage: str, divergence_patience: int = 2,
                 divergence_growth: float = 1.0) -> ResumableResult:
    """The chunked loop of every resumable solver.
    ``run_chunk(phi, iters) -> (phi, n, rms)``.

    A restored solve continues while ``iterations < total_iters``: one
    whose stage had already converged runs one more chunk, whose first
    step stops it again (one more iteration), as in the JAX package."""
    phi = phi0
    done_iters = 0
    resumed_from = None
    if ckpt is not None:
        state = ckpt.restore(like=phi0)
        if state is not None:
            phi = state["phi"]
            done_iters = int(state["extra"].get("iterations", state["step"]))
            resumed_from = state["step"]
            log_event(stage, event="resume", step=state["step"],
                      iterations=done_iters)

    prev_rms = math.inf
    rising = 0
    rms = math.nan
    converged = diverged = False
    while done_iters < total_iters:
        n_iters = min(chunk, total_iters - done_iters)
        phi, n, rms = run_chunk(phi, n_iters)
        n, rms = int(n), float(rms)
        done_iters += n
        if ckpt is not None:
            ckpt.save(done_iters, phi, extra={"iterations": done_iters,
                                              "rms": rms, "stage": stage})
        log_event(stage, event="chunk", iterations=done_iters, rms=rms)
        if math.isnan(rms):
            diverged = True
            break
        if rms < tol:
            converged = True
            break
        # divergence detection: RMS rising across consecutive chunks
        if rms > prev_rms * divergence_growth:
            rising += 1
            if rising >= divergence_patience:
                diverged = True
                log_event(stage, event="divergence_detected", rms=rms,
                          prev_rms=prev_rms)
                break
        else:
            rising = 0
        prev_rms = rms
    if ckpt is not None:
        ckpt.wait()
    return ResumableResult(phi=phi, iterations=done_iters, final_rms=rms,
                           converged=converged, diverged=diverged,
                           resumed_from=resumed_from)


def reinit_resumable(phi0, dx, h, iters: int, tol: float, *,
                     ckpt: Optional[FieldCheckpointer] = None,
                     chunk: int = 200, **reinit_kw) -> ResumableResult:
    """Dense eikonal reinitialization with periodic checkpoint/resume.

    Every chunk freezes the sign source at the original ``phi0``
    (``sign_src=phi0``, the reference's phiS frozen at solver entry,
    subs.f90:731), so a resumed solve is step for step, bit for bit, an
    uninterrupted one.  ``phi0`` must be the same original field on resume
    (the pipeline recomputes it from the input mesh).
    """
    def run_chunk(phi, n_iters):
        r = reinit(phi, dx, h, n_iters, tol, sign_src=phi0, **reinit_kw)
        return r.phi, r.iterations, r.final_rms

    return _run_chunked(run_chunk, phi0, iters, tol, ckpt, chunk, "reinit")


def minmax_resumable(phi0, dx, h1, iters: int, tol: float, *,
                     ckpt: Optional[FieldCheckpointer] = None,
                     chunk: int = 500, **minmax_kw) -> ResumableResult:
    """Dense min/max smoothing flow with periodic checkpoint/resume."""
    def run_chunk(phi, n_iters):
        m = minmax_flow(phi, dx, h1, n_iters, tol, **minmax_kw)
        return m.phi, m.iterations, m.final_rms

    return _run_chunked(run_chunk, phi0, iters, tol, ckpt, chunk, "minmax")


def reinit_resumable_sharded(solver, phi0, h, iters: int, tol: float, *,
                             ckpt: Optional[FieldCheckpointer] = None,
                             chunk: int = 200) -> ResumableResult:
    """Checkpoint/resume composed with the domain decomposition.

    ``solver`` is a :class:`~..parallel.sharded.ShardedLevelSet`, ``phi0``
    its list of blocks (``solver.device_put``).  The checkpointer saves and
    restores block by block onto each block's device, so the field is
    never gathered.  The sign source stays frozen at the original
    ``phi0``.  A chunk steps in exchanges of k, so it may run up to k - 1
    steps past its count; the iteration total adds what was run.  On a
    mesh across processes every rank runs this loop on its own blocks: the
    solver's RMS is global, so every rank takes the same stop decisions,
    and the checkpointer is collective (each rank writes its own blocks).
    """
    def run_chunk(phi, n_iters):
        return solver.reinit(phi, h, n_iters, tol, sign_src=phi0)

    return _run_chunked(run_chunk, phi0, iters, tol, ckpt, chunk, "reinit")


def minmax_resumable_sharded(solver, phi0, h1, iters: int, tol: float, *,
                             ckpt: Optional[FieldCheckpointer] = None,
                             chunk: int = 500, band_radius: float = 4.1,
                             threshold: float = 0.0) -> ResumableResult:
    """Sharded min/max flow with periodic checkpoint/resume (see
    :func:`reinit_resumable_sharded`)."""
    def run_chunk(phi, n_iters):
        return solver.minmax_flow(phi, h1, n_iters, tol,
                                  band_radius=band_radius,
                                  threshold=threshold)

    return _run_chunked(run_chunk, phi0, iters, tol, ckpt, chunk, "minmax")
