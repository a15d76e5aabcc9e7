"""Halo exchange between the blocks of a sharded field (port of
``levelsetfortran_tpu/parallel/halo.py``).

The stencils need up to radius-4 neighbour data (WENO5: 3; order-8
derivatives: 4).  Where the JAX package runs ``lax.ppermute`` under
``shard_map``, these functions take the whole list of blocks and copy face
slabs from block to block (``Tensor.copy_`` / ``.to``, device to device
when the shards lie on several cards).  They are the only place where
shards talk, so a multi-process exchange can later replace the copies here
and nowhere else.

Axes are exchanged one after the other on the already padded arrays, which
also fills the edge and corner halos.  A shard on a global face has no
neighbour there: its halo is zero-filled, which is harmless because the
solvers' global-coordinate masks never read those cells.
:func:`halo_exchange_transpose` is the exchange's exact linear transpose
(halo cotangents go back onto the neighbours' cells).
"""

from __future__ import annotations

import torch

from .mesh import ShardMesh


def _widths(width):
    return (width,) * 3 if isinstance(width, int) else tuple(width)


def _neighbour(mesh: ShardMesh, coord, axis: int, step: int, periodic: bool):
    """List position of the shard ``step`` along ``axis``, or None."""
    c = list(coord)
    c[axis] += step
    if periodic:
        c[axis] %= mesh.shape[axis]
    elif not 0 <= c[axis] < mesh.shape[axis]:
        return None
    return mesh.index(c)


def halo_exchange(blocks, width, mesh: ShardMesh, periodic: bool = False):
    """Pad every block with ``width`` neighbour cells on both sides of its
    first three axes; returns the new list.

    ``width``: an int or a per-axis tuple (0 skips an axis).  Global-face
    halos are zeros, or with ``periodic=True`` wrap from the other end of
    the GLOBAL grid (a ring), which makes a sharded stencil equal the
    single-device ops' circular ``torch.roll`` at the global faces too (the
    sharded advection gradient, whose single-device form masks nothing)."""
    for axis, w in enumerate(_widths(width)):
        if not w:
            continue
        new = []
        for coord, x in zip(mesh.coords(), blocks):
            parts = []
            for step, lo in ((-1, x.shape[axis] - w), (1, 0)):
                nb = _neighbour(mesh, coord, axis, step, periodic)
                if nb is None:
                    shape = list(x.shape)
                    shape[axis] = w
                    parts.append(torch.zeros(shape, dtype=x.dtype,
                                             device=x.device))
                else:
                    parts.append(blocks[nb].narrow(axis, lo, w).to(x.device))
            new.append(torch.cat([parts[0], x, parts[1]], dim=axis))
        blocks = new
    return blocks


def halo_exchange_axis_transpose(cots, width: int, axis: int,
                                 mesh: ShardMesh):
    """Linear transpose of one axis of :func:`halo_exchange` (non-periodic;
    ``halo.py:135`` of the JAX package): every padded cotangent block loses
    its halo along ``axis``, its centre passes through, and its low halo's
    cotangent is added onto the last ``width`` cells of the shard before it,
    its high halo's onto the first ``width`` cells of the shard after it.
    A global face's zero-filled halo has no sender, and its cotangent is
    dropped."""
    out = []
    for coord, y in zip(mesh.coords(), cots):
        o = y.narrow(axis, width, y.shape[axis] - 2 * width).clone()
        n = o.shape[axis]
        nb = _neighbour(mesh, coord, axis, 1, False)
        if nb is not None:       # the next shard's low halo: my last cells
            o.narrow(axis, n - width, width).add_(
                cots[nb].narrow(axis, 0, width).to(o.device))
        nb = _neighbour(mesh, coord, axis, -1, False)
        if nb is not None:       # the previous shard's high halo: my first
            size = cots[nb].shape[axis]
            o.narrow(axis, 0, width).add_(
                cots[nb].narrow(axis, size - width, width).to(o.device))
        out.append(o)
    return out


def halo_exchange_transpose(cots, width, mesh: ShardMesh):
    """Transpose of :func:`halo_exchange`: fold padded-block cotangents back
    onto the blocks.  The forward pads the axes one after the other, so the
    transpose peels them in reverse order."""
    widths = _widths(width)
    for axis in reversed(range(len(widths))):
        if widths[axis]:
            cots = halo_exchange_axis_transpose(cots, widths[axis], axis,
                                                mesh)
    return cots


def refresh_halos(pads, width, mesh: ShardMesh) -> None:
    """Refresh, in place, the halo frame of persistently padded blocks
    (``width`` halo cells + owned cells + ``width`` halo cells per sharded
    axis), so that a solver's state stays in the kernels' padded layout for
    a whole solve.

    Equal to :func:`halo_exchange` of the cropped blocks: the axes go one
    after the other and a later axis's slabs span the earlier axes' halos,
    just refreshed, so edges and corners receive the diagonal neighbours'
    cells.  The slabs sent are always OWNED cells (``[w, 2w)`` and
    ``[size-2w, size-w)``), so the refresh is sound even when the halo of
    the sending block holds stale or unwritten data.  Global-face halos
    become zeros."""
    for axis, w in enumerate(_widths(width)):
        if not w:
            continue
        for coord, pad in zip(mesh.coords(), pads):
            size = pad.shape[axis]
            for step, src_lo, dst_lo in ((-1, size - 2 * w, 0),
                                         (1, w, size - w)):
                nb = _neighbour(mesh, coord, axis, step, False)
                dst = pad.narrow(axis, dst_lo, w)
                if nb is None:
                    dst.zero_()
                else:
                    dst.copy_(pads[nb].narrow(axis, src_lo, w))


def crop(x: torch.Tensor, width) -> torch.Tensor:
    """Drop the halo frame of one padded block."""
    for axis, w in enumerate(_widths(width)):
        if w:
            x = x.narrow(axis, w, x.shape[axis] - 2 * w)
    return x


def local_offsets(mesh: ShardMesh, block_shape) -> list:
    """Global index of every shard's block origin, in list order."""
    return [tuple(c * b for c, b in zip(coord, block_shape))
            for coord in mesh.coords()]
