"""Shift/stencil helpers shared by the grid operators (port of
``levelsetfortran_tpu/ops/stencil.py``)."""

from __future__ import annotations

import torch


def shift(a: torch.Tensor, axis: int, off: int) -> torch.Tensor:
    """``shift(a, axis, off)[i] == a[i + off]`` along ``axis``, circularly;
    the wrapped cells only feed branches masked out near the faces."""
    if off == 0:
        return a
    return torch.roll(a, -off, dims=axis)


def interior_mask(shape, depth: int, dtype=torch.bool,
                  device=None) -> torch.Tensor:
    """Mask of cells at least ``depth`` points from every face, as
    ``dtype`` (``depth=1``: the update region ``subs.f90:744-746``;
    ``depth=4``: the deep WENO region ``subs.f90:506``)."""
    masks = []
    for ax, n in enumerate(shape):
        idx = torch.arange(n, device=device)
        m = (idx >= depth) & (idx <= n - 1 - depth)
        bshape = [1, 1, 1]
        bshape[ax] = n
        masks.append(m.reshape(bshape))
    return (masks[0] & masks[1] & masks[2]).to(dtype)


def clamped_inner(phi: torch.Tensor) -> torch.Tensor:
    """``phi`` gathered at the clamped inner index ``clamp(i, 1, n-2)`` per
    axis: every face cell reads its nearest interior cell (diagonal for
    edges and corners), every interior cell itself."""
    out = phi
    for ax, n in enumerate(phi.shape):
        idx = torch.arange(n, device=phi.device).clamp(1, n - 2)
        out = out.index_select(ax, idx)
    return out


def boundary_extrapolate(phi: torch.Tensor, dx) -> torch.Tensor:
    """Ghost-layer BC: every boundary point becomes its nearest interior
    point plus ``dx`` (``subs.f90:858-897``)."""
    bmask = ~interior_mask(phi.shape, 1, device=phi.device)
    return torch.where(bmask, clamped_inner(phi) + dx, phi)


def global_interior_mask(shape, origin, gshape, depth: int,
                         device=None) -> torch.Tensor:
    """:func:`interior_mask` of one block of a larger grid, in GLOBAL
    coordinates: the block's cell 0 has global index ``origin`` in a grid of
    ``gshape`` points.  ``depth=0`` marks the block's in-grid cells (a halo
    may reach past a global face)."""
    masks = []
    for ax, (n, o, g) in enumerate(zip(shape, origin, gshape)):
        idx = o + torch.arange(n, device=device)
        m = (idx >= depth) & (idx <= g - 1 - depth)
        bshape = [1, 1, 1]
        bshape[ax] = n
        masks.append(m.reshape(bshape))
    return masks[0] & masks[1] & masks[2]


def global_clamped_inner(a: torch.Tensor, origin, gshape) -> torch.Tensor:
    """:func:`clamped_inner` of one block in GLOBAL coordinates: ``a``
    gathered, per axis, at the global index clamped to ``[1, n-2]`` (then
    clipped into the block, for halo cells past a global face).  A global
    face cell's source lies in its own block."""
    out = a
    for ax, (n, o, g) in enumerate(zip(a.shape[:3], origin, gshape)):
        idx = (o + torch.arange(n, device=a.device)).clamp(1, g - 2) - o
        out = out.index_select(ax, idx.clamp(0, n - 1))
    return out
