"""Kernel K8 — the surface-node advection — with its plain PyTorch version.

K8 (``csrc/advect.cu``) has no Pallas counterpart.  It replaces the loop
that the JAX package compiles into one device program,
``levelsetfortran_tpu/solvers/advect.py:advect_nodes`` (:46, ``jax.jit``
around a ``lax.fori_loop``).  phi and its banded gradient are frozen while
the nodes move, so each node's path depends on its own position only: one
thread per node runs every iteration and the final sample, in one launch.

What bounds it on the H100 is latency, not bytes or operations: each
iteration gathers 32 floats at the node's cell (L1/L2 hits) and spends
~125 float operations on them, and a node's iterations form one dependent
chain.  The plain loop issues ~40 small ops per iteration from the host.

The kernel evaluates the plain loop's expressions in their order, built
with ``--fmad=false``; ``world_to_index``'s division by dx is a
multiplication by ``float32(1 / dx)``, the reciprocal taken in double and
rounded once, as PyTorch divides a CUDA tensor by a Python number (it
parts from ``float32(1) / float32(dx)`` at dx 0.015, run E's spacing).  So
positions and ``phi_surf`` are bitwise the plain loop's on the card.

:func:`advect` runs the plain loop only for CPU tensors; for CUDA tensors
it launches K8 or raises.  ``solvers.advect.advect_nodes`` takes the
wrapper for float32 and the plain loop for bfloat16 and float64
(``weno_cuda.kernel_supported``).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import cuda_build
from ..grid.grid import Grid3D
from .interp import sample_surface
from .weno_cuda import on_device


def advect_plain(phi, grad, grid: Grid3D, positions, iters: int,
                 eps: float, mag_eps: float = 1e-7):
    """The plain version of :func:`advect` (any dtype, any device): the
    loop of ``set3d.f90:482-501``, batched over the nodes."""
    x = positions
    for _ in range(iters):
        p, direction = sample_surface(phi, grad, grid, x, mag_eps=mag_eps)
        move = (p > eps).to(x.dtype)
        x = x + (move * p)[:, None] * direction
    p_final, _ = sample_surface(phi, grad, grid, x, mag_eps=mag_eps)
    return x, p_final


def advect(phi, grad, grid: Grid3D, positions, iters: int, eps: float,
           mag_eps: float = 1e-7):
    """Move the nodes ``positions`` (N, 3) ``iters`` times down ``phi``
    along ``grad`` (its banded gradient, (X, Y, Z, 3)) where their phi is
    above ``eps``: (positions (N, 3), phi at them (N,)).  One K8 launch for
    CUDA tensors (float32 only; anything else raises), the plain loop for
    CPU ones."""
    if phi.device.type == "cpu":
        return advect_plain(phi, grad, grid, positions, iters, eps, mag_eps)
    shape = tuple(phi.shape)
    dev = phi.device
    for name, t, want in (("phi", phi, shape), ("grad", grad, shape + (3,)),
                          ("positions", positions, (positions.shape[0], 3))):
        if (t.dtype != torch.float32 or tuple(t.shape) != want
                or t.device != dev):
            raise ValueError(f"advect: {name} must be a float32 {want} "
                             f"tensor on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if len(shape) != 3 or min(shape) < 2 or grad.numel() >= 2 ** 31:
        raise ValueError(f"advect: unsupported grid shape {shape}")
    if shape != tuple(grid.shape):
        raise ValueError(f"advect: phi {shape} is not on grid {grid.shape}")
    phi, grad, x = phi.contiguous(), grad.contiguous(), positions.contiguous()
    n = x.shape[0]
    out = torch.empty_like(x)
    phi_surf = torch.empty(n, dtype=torch.float32, device=dev)
    f32 = np.float32
    origin = [float(f32(o)) for o in grid.origin]
    with on_device(dev):
        cuda_build.launch(
            "lsf_advect_nodes_f32", phi.data_ptr(), grad.data_ptr(),
            x.data_ptr(), out.data_ptr(), phi_surf.data_ptr(), n, *shape,
            *origin, float(f32(1.0 / grid.dx)), int(iters),
            float(f32(eps)), float(f32(mag_eps)), float(f32(mag_eps * 1e-6)),
            torch.cuda.current_stream(dev).cuda_stream)
    advect.launches += 1
    return out, phi_surf


advect.launches = 0
