"""The sphere-traced renderer in plain PyTorch.

A fixed number of masked steps ``t <- t + phi(o + t d)`` through the
trilinear sampler; the hit distance is differentiated by the implicit
function theorem at the hit, ``dt = -dphi / (dphi/dt)``, zero on rays that
did not converge or graze.  Central-difference normals and Lambertian
shading follow by autograd.
"""

from __future__ import annotations

import math

import torch

from .solvers import trilinear


def camera_rays(height, width, *, eye, target, up=(0.0, 0.0, 1.0),
                fov_deg=40.0, dtype=torch.float32, device=None):
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
    return eye.expand(dirs.shape), dirs


class _Depth(torch.autograd.Function):

    @staticmethod
    def forward(ctx, phi, origins, dirs, grid, n_steps, hit_tol, t_max):
        t = torch.zeros(origins.shape[:-1], dtype=phi.dtype,
                        device=phi.device)
        for _ in range(n_steps):
            p = trilinear(phi, grid, origins + t[..., None] * dirs)
            active = (torch.abs(p) > hit_tol) & (t < t_max)
            t = torch.where(active, t + p, t)
        ctx.save_for_backward(phi, origins, dirs, t)
        ctx.grid, ctx.hit_tol = grid, hit_tol
        return t

    @staticmethod
    def backward(ctx, g):
        phi, origins, dirs, t = (x.detach() for x in ctx.saved_tensors)
        grid = ctx.grid
        with torch.enable_grad():
            tt = t.requires_grad_(True)
            p = trilinear(phi, grid, origins + tt[..., None] * dirs)
            dphi_dt, = torch.autograd.grad(p.sum(), tt)
        ok = ((torch.abs(p.detach()) < 10.0 * ctx.hit_tol)
              & (torch.abs(dphi_dt) > 1e-6))
        one = torch.ones_like(dphi_dt)
        inv = torch.where(ok, -1.0 / torch.where(ok, dphi_dt, one),
                          torch.zeros_like(dphi_dt))
        with torch.enable_grad():
            leaf = phi.requires_grad_(True)
            s = torch.sum(g * inv * trilinear(
                leaf, grid, origins + t.detach()[..., None] * dirs))
            gphi, = torch.autograd.grad(s, leaf)
        return gphi, None, None, None, None, None, None


def _normal(phi, grid, points, eps):
    comps = []
    for a in range(3):
        off = torch.zeros(3, dtype=points.dtype, device=points.device)
        off[a] = eps
        comps.append((trilinear(phi, grid, points + off)
                      - trilinear(phi, grid, points - off)) / (2 * eps))
    n = torch.stack(comps, dim=-1)
    mag2 = torch.sum(n * n, dim=-1, keepdim=True)
    safe = mag2 > 1e-24
    return torch.where(
        safe, n / torch.sqrt(torch.where(safe, mag2, torch.ones_like(mag2))),
        torch.zeros_like(n))


def image(phi, grid, origins, dirs, *, n_steps, hit_tol, t_max=1e3,
          light=(0.5, -0.7, 1.0)):
    """The shaded image, differentiable in ``phi``."""
    t = _Depth.apply(phi, origins, dirs, grid, n_steps, hit_tol, t_max)
    x = origins + t[..., None] * dirs
    hit = torch.abs(trilinear(phi, grid, x)) < 10.0 * hit_tol
    n = _normal(phi, grid, x, grid.dx)
    lvec = torch.as_tensor(light, dtype=phi.dtype, device=phi.device)
    lvec = lvec / torch.linalg.vector_norm(lvec)
    lam = torch.clamp(torch.sum(n * lvec, dim=-1), 0.0, 1.0)
    return torch.where(hit, 0.1 + 0.9 * lam, torch.zeros_like(lam))
