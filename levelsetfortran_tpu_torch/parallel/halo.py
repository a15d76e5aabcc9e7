"""Halo exchange between the blocks of a sharded field (port of
``levelsetfortran_tpu/parallel/halo.py``).

The stencils need up to radius-4 neighbour data (WENO5: 3; order-8
derivatives: 4).  Where the JAX package runs ``lax.ppermute`` under
``shard_map``, these functions take the whole list of blocks and copy face
slabs from block to block (``Tensor.copy_`` / ``.to``, device to device
when the shards lie on several cards).  They are the only place where
shards talk.  Under a process group (a mesh that spans processes, see
:mod:`.mesh`) a slab between two shards of one process is still a copy, and
a slab to or from a shard of another process goes through
``torch.distributed``: per axis, every rank posts all its sends and
receives in one ``batch_isend_irecv`` and waits for them (gloo stages a
card's slabs through host memory).

Axes are exchanged one after the other on the already padded arrays, which
also fills the edge and corner halos.  A shard on a global face has no
neighbour there: its halo is zero-filled, which is harmless because the
solvers' global-coordinate masks never read those cells.
:func:`halo_exchange_transpose` is the exchange's exact linear transpose
(halo cotangents go back onto the neighbours' cells).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..utils.profiling import count, span
from .distributed import comm_device
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

    ``width``: an int or a per-axis tuple (0 skips an axis).  Every block is
    zero-padded and :func:`refresh_halos` fills the halos, in one process
    and across processes alike (None, the block of another rank, stays
    None).  Global-face halos are zeros, or with ``periodic=True`` wrap
    from the other end of the GLOBAL grid (a ring), which makes a sharded
    stencil equal the single-device ops' circular ``torch.roll`` at the
    global faces too (the sharded advection gradient, whose single-device
    form masks nothing)."""
    widths = _widths(width)
    pads = [None if b is None else F.pad(b, _pad_spec(b, widths))
            for b in blocks]
    refresh_halos(pads, widths, mesh, periodic=periodic)
    return pads


def _pad_spec(x: torch.Tensor, widths):
    """``F.pad``'s spec for ``widths`` halo cells on both sides of the first
    three axes of ``x`` (none on any trailing axis)."""
    return [0, 0] * (x.dim() - 3) + [v for w in reversed(widths)
                                     for v in (w, w)]


def halo_exchange_axis_transpose(cots, width: int, axis: int,
                                 mesh: ShardMesh):
    """Linear transpose of one axis of :func:`halo_exchange` (non-periodic;
    ``halo.py:135`` of the JAX package): every padded cotangent block loses
    its halo along ``axis``, its centre passes through, and its low halo's
    cotangent is added onto the last ``width`` cells of the shard before it,
    its high halo's onto the first ``width`` cells of the shard after it
    (in that order).  A global face's zero-filled halo has no sender, and
    its cotangent is dropped.  Under a process group the halo cotangents of
    another rank's shard arrive through :func:`_remote_slabs` and are added
    in the same order; None (another rank's block) stays None."""
    remote = {}
    if mesh.spans_processes:
        remote = _remote_slabs(cots, width, axis, mesh, False,
                               lambda size, step: 0 if step == 1
                               else size - width)
    out = []
    for i, (coord, y) in enumerate(zip(mesh.coords(), cots)):
        if y is None:
            out.append(None)
            continue
        o = y.narrow(axis, width, y.shape[axis] - 2 * width).clone()
        n = o.shape[axis]
        # the next shard's low halo onto my last cells, then the previous
        # shard's high halo onto my first cells
        for step, dst_lo, src_lo in ((1, n - width, 0),
                                     (-1, 0, y.shape[axis] - width)):
            nb = _neighbour(mesh, coord, axis, step, False)
            if nb is None:
                continue
            slab = remote.get((i, step))
            if slab is None:
                slab = cots[nb].narrow(axis, src_lo, width)
            o.narrow(axis, dst_lo, width).add_(slab.to(o.device))
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


def refresh_halos(pads, width, mesh: ShardMesh, periodic: bool = False
                  ) -> None:
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
    become zeros, or with ``periodic`` the other end of the grid's cells
    (along an axis of one shard, the block's own opposite face: a copy).
    Under a process group the slabs that cross to another rank go through
    :func:`_remote_slabs`; None (another rank's block) is skipped.

    Traced as the span ``lsf.halo_exchange``, with the counter
    ``halo.bytes``: the bytes of the slabs this process's blocks receive
    from other shards (a periodic wrap onto the block's own face, zero
    fills and the slabs sent to other ranks not counted)."""
    with span("lsf.halo_exchange"):
        for axis, w in enumerate(_widths(width)):
            if w:
                _refresh_axis(pads, w, axis, mesh, periodic)


def _refresh_axis(pads, w: int, axis: int, mesh: ShardMesh,
                  periodic: bool) -> None:
    """One axis of :func:`refresh_halos`."""
    remote = {}
    if mesh.spans_processes:
        remote = _remote_slabs(pads, w, axis, mesh, periodic,
                               lambda size, step: size - 2 * w
                               if step == -1 else w)
    received = 0
    for i, (coord, pad) in enumerate(zip(mesh.coords(), pads)):
        if pad is None:
            continue
        size = pad.shape[axis]
        for step, src_lo, dst_lo in ((-1, size - 2 * w, 0),
                                     (1, w, size - w)):
            nb = _neighbour(mesh, coord, axis, step, periodic)
            dst = pad.narrow(axis, dst_lo, w)
            if nb is None:
                dst.zero_()
                continue
            if (i, step) in remote:
                dst.copy_(remote[(i, step)])
            else:
                dst.copy_(pads[nb].narrow(axis, src_lo, w))
            if nb != i:
                received += dst.numel() * dst.element_size()
    count("halo.bytes", received)


def _remote_slabs(blocks, w: int, axis: int, mesh: ShardMesh,
                  periodic: bool, src_lo) -> dict:
    """The slabs of one axis that cross between processes:
    ``{(dst_i, step): slab}`` for every shard ``dst_i`` of this rank whose
    neighbour ``step`` (-1 or 1) along ``axis`` lives on another rank, the
    slab being ``w`` cells of that neighbour's block from
    ``src_lo(size, step)``.

    Every rank walks the same global list of transfers (each shard's low
    and high neighbour, in shard order) and posts a send for each transfer
    whose source shard it owns and a receive for each whose destination it
    owns, so the two ends of every pair of ranks post their operations in
    the same order (NCCL matches them by order, gloo by the tag, the
    transfer's index: on a ring of two shards both neighbours are one
    rank, and the tags tell the two slabs apart).  Sends are contiguous
    copies of the narrowed slabs, staged through the host under gloo;
    receives land in contiguous buffers of the destination block's slab
    shape (every block has the same shape).  Returns once all arrived."""
    ops, landing = [], {}
    for tag, (coord, step) in enumerate(
            (c, s) for c in mesh.coords() for s in (-1, 1)):
        dst_i = mesh.index(coord)
        src_i = _neighbour(mesh, coord, axis, step, periodic)
        if src_i is None or mesh.owners[src_i] == mesh.owners[dst_i]:
            continue
        if blocks[src_i] is not None:          # I own the source: send
            src = blocks[src_i]
            slab = src.narrow(axis, src_lo(src.shape[axis], step), w)
            buf = slab.to(comm_device(slab), copy=True,
                          memory_format=torch.contiguous_format)
            ops.append(dist.P2POp(dist.isend, buf, mesh.owners[dst_i],
                                  tag=tag))
        if blocks[dst_i] is not None:          # I own the destination
            shape = blocks[dst_i].narrow(axis, 0, w).shape
            buf = torch.empty(shape, dtype=blocks[dst_i].dtype,
                              device=comm_device(blocks[dst_i]))
            ops.append(dist.P2POp(dist.irecv, buf, mesh.owners[src_i],
                                  tag=tag))
            landing[(dst_i, step)] = buf
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return landing


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
