"""The shard mesh of a 3-D domain decomposition (port of
``levelsetfortran_tpu/parallel/mesh.py``).

A :class:`ShardMesh` is a logical ``(mx, my, mz)`` grid of shards, each with
an explicit ``torch.device``; a sharded field is a plain list of block
tensors in shard order (x slowest, z fastest), block ``(ix, iy, iz)`` on its
shard's device.  Departure from the JAX package, whose mesh needs one device
per shard: here there may be fewer devices than shards, and shards are
placed round-robin over them, so that a ``(2, 2, 1)`` decomposition runs on
one card (all four blocks on it) and on four cards (one block each) with
the same code.

Under a process group (:func:`.distributed.init_distributed`) the mesh
spans the processes: shard ``i`` belongs to rank ``i * world // n_shards``
(contiguous in shard order, as the JAX package lays its process-ordered
devices out), and lies on one of that rank's own devices (its card, or the
CPU).  A sharded field is then the shard-ordered list with this rank's
blocks and None in the place of every other rank's, so that every loop over
the list keeps its indices.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from . import distributed


def factor3(n: int, *, prefer_z1: bool = False) -> Tuple[int, int, int]:
    """Factor ``n`` shards into a (mx, my, mz) mesh shape: near-cubic
    balanced factors (least halo surface on a cubic domain), or with
    ``prefer_z1`` the most square ``(a, b, 1)`` shape, z whole per shard."""
    if prefer_z1:
        a = math.isqrt(n)
        while n % a:
            a -= 1
        return (max(a, n // a), min(a, n // a), 1)
    best = (n, 1, 1)
    best_cost = float("inf")
    for a in range(1, n + 1):
        if n % a:
            continue
        m = n // a
        for b in range(1, m + 1):
            if m % b:
                continue
            c = m // b
            cost = a * b + b * c + a * c     # sum of the partition's faces
            if cost < best_cost:
                best_cost = cost
                best = tuple(sorted((a, b, c), reverse=True))
    return best


def pad_to_multiple(shape: Sequence[int], mesh_shape: Sequence[int]
                    ) -> Tuple[int, int, int]:
    """Smallest shape >= ``shape`` divisible by the mesh along each axis."""
    return tuple(-(-s // m) * m for s, m in zip(shape, mesh_shape))


def default_devices(device="cuda") -> list:
    """Every visible device of ``device``'s type: all cards for ``"cuda"``
    (under a process group only the rank's own card), the one named for
    ``"cuda:1"``, ``[cpu]`` for the CPU."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return [device]
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass devices=['cpu'] to run the "
                           "kernels' plain versions")
    if distributed.active():
        return [torch.device("cuda", torch.cuda.current_device())]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


@dataclasses.dataclass(frozen=True)
class ShardMesh:
    """``shape`` shards, shard ``(ix, iy, iz)`` at list position
    ``(ix * my + iy) * mz + iz`` on ``devices[position]``.  ``owners``
    (None in one process) gives each shard's rank under a process group;
    ``devices`` is None at the shards of other ranks."""
    shape: Tuple[int, int, int]
    devices: Tuple[Optional[torch.device], ...]
    owners: Optional[Tuple[int, ...]] = None
    rank: int = 0

    @property
    def n_shards(self) -> int:
        return len(self.devices)

    @property
    def spans_processes(self) -> bool:
        return self.owners is not None

    def is_local(self, i: int) -> bool:
        """Shard ``i`` lives in this process."""
        return self.owners is None or self.owners[i] == self.rank

    def coords(self):
        """Shard coordinates in list order."""
        return list(itertools.product(*(range(m) for m in self.shape)))

    def index(self, coord) -> int:
        return (coord[0] * self.shape[1] + coord[1]) * self.shape[2] + coord[2]

    def block_shape(self, gshape) -> Tuple[int, int, int]:
        if any(g % m for g, m in zip(gshape, self.shape)):
            raise ValueError(f"global shape {tuple(gshape)} not divisible "
                             f"by mesh {self.shape}; use pad_to_multiple")
        return tuple(g // m for g, m in zip(gshape, self.shape))


def make_mesh(mesh_shape: Optional[Sequence[int]] = None,
              devices=None) -> ShardMesh:
    """A mesh of ``mesh_shape`` shards (default: one shard per device,
    :func:`factor3`) placed round-robin over ``devices`` (default: every
    visible CUDA device).  Under a process group the shards are dealt out
    to the ranks in contiguous runs, ``devices`` are this rank's own
    (default: its card) and the default shape is one shard per rank."""
    devices = [torch.device(d) for d in
               (default_devices() if devices is None else devices)]
    group = distributed.active()
    world = dist.get_world_size() if group else 1
    if mesh_shape is None:
        mesh_shape = factor3(world if group else len(devices))
    mesh_shape = tuple(int(m) for m in mesh_shape)
    if len(mesh_shape) != 3 or min(mesh_shape) < 1:
        raise ValueError(f"mesh shape must be three positive ints, got "
                         f"{mesh_shape}")
    n = math.prod(mesh_shape)
    if not group:
        return ShardMesh(mesh_shape,
                         tuple(devices[i % len(devices)] for i in range(n)))
    if n < world:
        raise ValueError(f"mesh {mesh_shape} has {n} shards for {world} "
                         f"processes: every process needs one")
    me = dist.get_rank()
    owners = tuple(i * world // n for i in range(n))
    local = [i for i in range(n) if owners[i] == me]
    placed = {i: devices[k % len(devices)] for k, i in enumerate(local)}
    return ShardMesh(mesh_shape, tuple(placed.get(i) for i in range(n)),
                     owners, me)


def split_blocks(mesh: ShardMesh, x: torch.Tensor) -> list:
    """Cut a global field (its first three axes) into the mesh's blocks,
    each a contiguous tensor on its shard's device (the JAX package's
    ``device_put`` with the grid sharding).  Under a process group only
    this rank's blocks are cut (``jax.make_array_from_callback``), None in
    the place of the others."""
    b = mesh.block_shape(x.shape[:3])
    return [x[c[0] * b[0]:(c[0] + 1) * b[0], c[1] * b[1]:(c[1] + 1) * b[1],
              c[2] * b[2]:(c[2] + 1) * b[2]].to(dev).contiguous()
            if dev is not None else None
            for c, dev in zip(mesh.coords(), mesh.devices)]


def _assemble(mesh: ShardMesh, blocks, device) -> torch.Tensor:
    mx, my, mz = mesh.shape
    it = iter(b.to(device) for b in blocks)
    return torch.cat([torch.cat([torch.cat([next(it) for _ in range(mz)], 2)
                                 for _ in range(my)], 1)
                      for _ in range(mx)], 0)


def gather_blocks(mesh: ShardMesh, blocks, device=None
                  ) -> Optional[torch.Tensor]:
    """The global field of a list of blocks, on ``device`` (default: the
    first shard's, under a process group this rank's first).

    Under a process group the blocks of the other ranks come to rank 0
    through ``torch.distributed``, shard by shard in shard order; the other
    ranks get None."""
    if not mesh.spans_processes:
        device = blocks[0].device if device is None else device
        return _assemble(mesh, blocks, device)
    mine = next(b for b in blocks if b is not None)
    device = mine.device if device is None else device
    cdev = distributed.comm_device(mine)
    full = []
    for i, (b, owner) in enumerate(zip(blocks, mesh.owners)):
        if mesh.rank == 0:
            if b is None:
                b = torch.empty(mine.shape, dtype=mine.dtype, device=cdev)
                dist.recv(b, src=owner, tag=i)
            full.append(b)
        elif b is not None and owner != 0:
            dist.send(b.to(cdev).contiguous(), dst=0, tag=i)
    if not full:
        return None
    return _assemble(mesh, full, device)


def all_blocks(mesh: ShardMesh, blocks) -> list:
    """Every shard's block on this rank: in one process the list itself;
    under a process group each block broadcast from its owner, in shard
    order (every block has the first local block's shape and dtype; under
    gloo a card's blocks pass through the host, and the others' arrive
    there)."""
    if not mesh.spans_processes:
        return list(blocks)
    mine = next(b for b in blocks if b is not None)
    cdev = distributed.comm_device(mine)
    out = []
    for b, owner in zip(blocks, mesh.owners):
        buf = (b.to(cdev).contiguous() if b is not None else
               torch.empty(mine.shape, dtype=mine.dtype, device=cdev))
        dist.broadcast(buf, src=owner)
        out.append(b if b is not None else buf)
    return out


class _GatherEverywhere(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, device, *blocks):
        ctx.mesh = mesh
        return _assemble(mesh, all_blocks(mesh, blocks), device)

    @staticmethod
    def backward(ctx, g):
        return (None, None, *split_blocks(ctx.mesh, g))


def gather_everywhere(mesh: ShardMesh, blocks, device=None) -> torch.Tensor:
    """The global field of a list of blocks on every rank, on ``device``
    (default: this rank's first block's), differentiable.  In one process
    the blocks assembled; under a process group every block broadcast from
    its owner (:func:`all_blocks`), and the backward keeps each rank's own
    blocks' slices of the cotangent.  The field and what is computed from
    it are replicated, so every rank holds the whole cotangent and nothing
    is added across ranks (the replicated output of the JAX package's
    ``shard_map``)."""
    mine = next(b for b in blocks if b is not None)
    device = mine.device if device is None else device
    if not mesh.spans_processes:
        return _assemble(mesh, blocks, device)
    return _GatherEverywhere.apply(mesh, device, *blocks)


class _Replicate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, x):
        ctx.mesh, ctx.home = mesh, x.device
        return tuple(None if d is None else x.to(d, copy=True)
                     for d in mesh.devices)

    @staticmethod
    def backward(ctx, *gs):
        parts = all_blocks(ctx.mesh, gs)
        total = parts[0].to(ctx.home)
        for p in parts[1:]:
            total = total + p.to(ctx.home)
        return None, total


def replicate(mesh: ShardMesh, x: torch.Tensor) -> list:
    """One copy of ``x`` per shard of this rank, on the shard's device (None
    for the others'), differentiable: the backward adds every shard's
    cotangent in shard order, across processes too (:func:`all_blocks`),
    so ``x`` gets the same sum in one process and on every rank (the psum
    of a replicated input in the transpose of the JAX package's
    ``shard_map``)."""
    return list(_Replicate.apply(mesh, x))
