"""Differentiable sphere-traced SDF renderer (port of
``levelsetfortran_tpu/render/sphere_trace.py``).

The march is a fixed-length loop of masked steps ``t <- t + phi(o + t d)``
through the trilinear sampler, run without a graph; the hit distance's
backward pass is the implicit-function VJP of ``phi(o + t d) = 0``
(:class:`_TraceDepth`), so reverse-mode memory does not grow with the step
count:

    dt/dtheta = - (d phi/d theta) / (d phi/d t)      at the hit point.

Normals and Lambertian shading are ordinary autograd on top.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..grid.grid import Grid3D
from ..ops.interp import trilinear
from ..utils.profiling import span


class RenderResult(NamedTuple):
    depth: torch.Tensor       # (H, W) hit distance (t at termination)
    hit: torch.Tensor         # (H, W) bool
    normal: torch.Tensor      # (H, W, 3) unit normals at hit points
    image: torch.Tensor       # (H, W) Lambertian shading


def _march(phi, grid, origins, dirs, t0, n_steps, hit_tol, t_max):
    """Fixed-length masked sphere trace: t <- t + phi(o + t d)."""
    t = t0
    for _ in range(n_steps):
        p = trilinear(phi, grid, origins + t[..., None] * dirs)
        active = (torch.abs(p) > hit_tol) & (t < t_max)
        t = torch.where(active, t + p, t)
    return t


class _TraceDepth(torch.autograd.Function):
    """Hit distance along each ray; backward by the implicit function
    theorem, zero on rays that did not converge or graze (``_trace_bwd``)."""

    @staticmethod
    def forward(ctx, phi, origins, dirs, grid, n_steps, hit_tol, t_max):
        t0 = torch.zeros(origins.shape[:-1], dtype=phi.dtype,
                         device=phi.device)
        t = _march(phi, grid, origins, dirs, t0, n_steps, hit_tol, t_max)
        ctx.save_for_backward(phi, origins, dirs, t)
        ctx.grid, ctx.hit_tol = grid, hit_tol
        return t

    @staticmethod
    def backward(ctx, g):
        with span("lsf.render.backward"):
            phi, origins, dirs, t = (x.detach() for x in ctx.saved_tensors)
            grid = ctx.grid
            with torch.enable_grad():
                tt = t.detach().requires_grad_(True)
                p = trilinear(phi, grid, origins + tt[..., None] * dirs)
                dphi_dt, = torch.autograd.grad(p.sum(), tt)
            # the implicit VJP holds only where the march converged to phi = 0;
            # a truncated ray's depth is an artifact of the step count
            converged = torch.abs(p.detach()) < 10.0 * ctx.hit_tol
            safe = converged & (torch.abs(dphi_dt) > 1e-6)
            one = torch.ones_like(dphi_dt)
            inv = torch.where(safe, -1.0 / torch.where(safe, dphi_dt, one),
                              torch.zeros_like(dphi_dt))
            lam = g * inv
            want = ctx.needs_input_grad[:3]
            with torch.enable_grad():
                leaves = [x.requires_grad_(w)
                          for x, w in zip((phi, origins, dirs), want)]
                s = torch.sum(lam * trilinear(
                    leaves[0], grid, leaves[1] + t[..., None] * leaves[2]))
                wanted = [x for x, w in zip(leaves, want) if w]
                grads = iter(torch.autograd.grad(s, wanted) if wanted else ())
            return (*(next(grads) if w else None for w in want), None, None,
                    None, None)


def trace_depth(phi, grid: Grid3D, origins, dirs, n_steps: int = 64,
                hit_tol: float = 1e-3, t_max: float = 1e3):
    """Hit distance t*(phi) along each ray, differentiable with respect to
    ``phi`` and the ray geometry via the implicit function theorem."""
    return _TraceDepth.apply(phi, origins, dirs, grid, n_steps, hit_tol,
                             t_max)


def surface_normal(phi, grid: Grid3D, points, eps=None):
    """Central-difference normal of the sampled field at world points."""
    eps = grid.dx if eps is None else eps
    comps = []
    for a in range(3):
        off = torch.zeros(3, dtype=points.dtype, device=points.device)
        off[a] = eps
        comps.append((trilinear(phi, grid, points + off)
                      - trilinear(phi, grid, points - off)) / (2 * eps))
    n = torch.stack(comps, dim=-1)
    # double-where: a missed ray samples a clamped (constant) field, so
    # n == 0 exactly and the norm's derivative there would be NaN
    mag2 = torch.sum(n * n, dim=-1, keepdim=True)
    safe = mag2 > 1e-24
    return torch.where(
        safe, n / torch.sqrt(torch.where(safe, mag2, torch.ones_like(mag2))),
        torch.zeros_like(n))


def camera_rays(height: int, width: int, *, eye, target, up=(0.0, 0.0, 1.0),
                fov_deg: float = 40.0, dtype=torch.float32, device=None):
    """Pinhole camera ray bundle: (origins, directions), each (H, W, 3)."""
    def vec(v):
        return torch.as_tensor(v, dtype=dtype, device=device)

    eye, target, up = vec(eye), vec(target), vec(up)
    fwd = target - eye
    fwd = fwd / torch.linalg.vector_norm(fwd)
    right = torch.linalg.cross(fwd, up)
    right = right / torch.linalg.vector_norm(right)
    cup = torch.linalg.cross(right, fwd)
    half = math.tan(math.radians(fov_deg) / 2.0)
    ys = torch.linspace(-half, half, height, dtype=dtype, device=device)
    xs = torch.linspace(-half * width / height, half * width / height, width,
                        dtype=dtype, device=device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    dirs = fwd + gx[..., None] * right - gy[..., None] * cup
    dirs = dirs / torch.linalg.vector_norm(dirs, dim=-1, keepdim=True)
    origins = eye.expand(dirs.shape)
    return origins, dirs


def render(phi, grid: Grid3D, origins, dirs, *, n_steps: int = 64,
           hit_tol: float = 1e-3, t_max: float = 1e3,
           light=(0.5, -0.7, 1.0)) -> RenderResult:
    """Sphere-trace + Lambertian shade; every output differentiable in
    ``phi``."""
    with span("lsf.render"):
        t = trace_depth(phi, grid, origins, dirs, n_steps, hit_tol, t_max)
        x = origins + t[..., None] * dirs
        hit = torch.abs(trilinear(phi, grid, x)) < 10.0 * hit_tol
        n = surface_normal(phi, grid, x)
        lvec = torch.as_tensor(light, dtype=phi.dtype, device=phi.device)
        lvec = lvec / torch.linalg.vector_norm(lvec)
        lambert = torch.clamp(torch.sum(n * lvec, dim=-1), 0.0, 1.0)
        image = torch.where(hit, 0.1 + 0.9 * lambert,
                            torch.zeros_like(lambert))
    return RenderResult(depth=t, hit=hit, normal=n, image=image)
