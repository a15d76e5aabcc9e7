"""Kernels K3 (one min/max step) and K4 (K fused min/max steps) with their
plain PyTorch versions.

K3 (``csrc/minmax_step.cu``) replaces
``levelsetfortran_tpu/ops/minmax_pallas.py:minmax_step_padded`` and K4
replaces ``minmax_fusedk_padded``.  One step: the 6-neighbour sum feeds the
Laplacian proxy and the 7-point average, F = min(lap, 0) where the average
is below the threshold else max(lap, 0), and phi += h1 F where
|phi| < band_radius dx on the interior.  What bounds them on the H100 is
bytes (~15 operations per cell against 8 bytes of traffic); K4 moves a
brick's window once for K steps, through shared memory.  Face rule: face
cells never update and an interior cell's +-1 reads never leave the grid,
so the port neither wraps (jnp path) nor clamps (TPU kernel).

The wrappers run the plain version only for a CPU tensor; for a CUDA tensor
they launch the kernel or raise.  K4 is bitwise equal to K launches of K3
(one shared cell update, built with ``--fmad=false``).
"""

from __future__ import annotations

import torch

from .. import cuda_build
from .stencil import interior_mask, shift
from .weno_cuda import (brick_cells, check_cuda, finish_plain, np_dtype,
                        ptr, rms_buffers)


def minmax_scalars(dtype, dx, h1, band_radius, threshold) -> dict:
    """Scalar constants rounded once in ``dtype``, as the TPU kernel forms
    them from its f32 scalar inputs."""
    t = np_dtype(dtype)
    dxv = t(dx)
    return dict(h1=float(t(h1)), inv_dx2=float(t(1) / (dxv * dxv)),
                band_dx=float(t(band_radius) * dxv),
                threshold=float(t(threshold)))


def _dense_step(phi, sc):
    """One dense min/max step in whole-grid tensor ops."""
    sum6 = (shift(phi, 0, -1) + shift(phi, 0, 1) + shift(phi, 1, -1)
            + shift(phi, 1, 1) + shift(phi, 2, 1) + shift(phi, 2, -1))
    lap = (sum6 - 6.0 * phi) * sc["inv_dx2"]
    pave = (sum6 + phi) * (1.0 / 7.0)
    f = torch.where(pave < sc["threshold"], torch.clamp_max(lap, 0.0),
                    torch.clamp_min(lap, 0.0))
    gate = (interior_mask(phi.shape, 1, phi.device)
            & (torch.abs(phi) < sc["band_dx"]))
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


def _launch(name, phi, out, sc, extra, active, mint, with_rms):
    partials, dsq = rms_buffers(phi, with_rms)
    with torch.cuda.device(phi.device):
        cuda_build.launch(
            name, phi.data_ptr(), out.data_ptr(), *phi.shape, sc["h1"],
            sc["inv_dx2"], sc["band_dx"], sc["threshold"], *extra,
            ptr(active), int(mint), ptr(partials), ptr(dsq),
            torch.cuda.current_stream().cuda_stream)
    return (out, dsq) if with_rms else out


def minmax_step(phi, dx, h1, band_radius=4.1, threshold=0.0, *,
                active=None, out=None, mint=True, with_rms=False):
    """One min/max step of ``phi`` into ``out`` (K3).  ``active``/``mint``
    as in :func:`..weno_cuda.reinit_step`; ``with_rms`` adds the float64
    sum of squared changes."""
    if phi.device.type == "cpu":
        return minmax_step_plain(phi, dx, h1, band_radius, threshold,
                                 active=active, out=out, mint=mint,
                                 with_rms=with_rms)
    if out is None:
        out = torch.empty_like(phi)
    check_cuda("minmax_step", phi, out, active)
    sc = minmax_scalars(phi.dtype, dx, h1, band_radius, threshold)
    res = _launch("lsf_minmax_step_f32", phi, out, sc, (), active, mint,
                  with_rms)
    minmax_step.launches += 1
    return res


minmax_step.launches = 0


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
    res = _launch("lsf_minmax_fusedk_f32", phi, out, sc, (int(ksteps),),
                  active, mint, with_rms)
    minmax_fusedk.launches += 1
    return res


minmax_fusedk.launches = 0
