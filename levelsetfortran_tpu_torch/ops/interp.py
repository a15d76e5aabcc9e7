"""Grid -> point trilinear interpolation (port of
``levelsetfortran_tpu/ops/interp.py``; reference ``subs.f90:1057-1170``)."""

from __future__ import annotations

import torch

from ..grid.grid import Grid3D


def trilinear(field: torch.Tensor, grid: Grid3D,
              points: torch.Tensor) -> torch.Tensor:
    """Trilinear sample of ``field`` (grid.shape or grid.shape + (C,)) at
    world-space ``points`` (..., 3); out-of-domain queries clamp."""
    f = grid.world_to_index(points)
    hi = torch.tensor([s - 1 for s in grid.shape], dtype=points.dtype,
                      device=points.device)
    f = torch.minimum(torch.clamp_min(f, 0.0), hi)
    max_idx = torch.tensor([s - 2 for s in grid.shape], device=points.device)
    i0 = torch.minimum(torch.clamp_min(torch.floor(f).long(), 0), max_idx)
    t = f - i0.to(f.dtype)

    def gather(di, dj, dk):
        return field[i0[..., 0] + di, i0[..., 1] + dj, i0[..., 2] + dk]

    if field.dim() == 4:
        tx, ty, tz = t[..., 0:1], t[..., 1:2], t[..., 2:3]
    else:
        tx, ty, tz = t[..., 0], t[..., 1], t[..., 2]
    c00 = gather(0, 0, 0) * (1 - tx) + gather(1, 0, 0) * tx
    c10 = gather(0, 1, 0) * (1 - tx) + gather(1, 1, 0) * tx
    c01 = gather(0, 0, 1) * (1 - tx) + gather(1, 0, 1) * tx
    c11 = gather(0, 1, 1) * (1 - tx) + gather(1, 1, 1) * tx
    c0 = c00 * (1 - ty) + c10 * ty
    c1 = c01 * (1 - ty) + c11 * ty
    return c0 * (1 - tz) + c1 * tz


def dot3(u, v):
    """``u . v`` over a last axis of 3, added left to right in the dtype's
    accumulation type (float32 for bfloat16): ``torch.sum``'s order on the
    CPU, spelled out so that the card adds in the same order (a CUDA
    ``torch.sum`` over three terms adds the first and the last first) and
    the kernels K7 and K8 can follow it."""
    p = u * v
    acc = torch.float32 if p.dtype in (torch.bfloat16, torch.float16) \
        else p.dtype
    return (p[..., 0].to(acc) + p[..., 1].to(acc)
            + p[..., 2].to(acc)).to(p.dtype)


def sample_surface(phi, grad_phi, grid: Grid3D, points, *,
                   mag_eps: float = 1e-7):
    """(phi_at_points, unit_inward_direction) — vectorized ``setPhiSurf``;
    direction is zero where ``|grad|^2 < mag_eps`` (subs.f90:1154-1166)."""
    phi_s = trilinear(phi, grid, points)
    g = -trilinear(grad_phi, grid, points)
    mag2 = dot3(g, g)[..., None]
    direction = torch.where(
        mag2 < mag_eps, torch.zeros_like(g),
        g / torch.sqrt(torch.clamp_min(mag2, mag_eps * 1e-6)))
    return phi_s, direction
