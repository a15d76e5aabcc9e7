"""The shard mesh of a 3-D domain decomposition (port of
``levelsetfortran_tpu/parallel/mesh.py``).

A :class:`ShardMesh` is a logical ``(mx, my, mz)`` grid of shards in one
process, each with an explicit ``torch.device``; a sharded field is a plain
list of block tensors in shard order (x slowest, z fastest), block
``(ix, iy, iz)`` on its shard's device.  Departure from the JAX package,
whose mesh needs one device per shard: here there may be fewer devices than
shards, and shards are placed round-robin over them, so that a ``(2, 2, 1)``
decomposition runs on one card (all four blocks on it) and on four cards
(one block each) with the same code.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Optional, Sequence, Tuple

import torch


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
    """Every visible device of ``device``'s type: all cards for ``"cuda"``,
    the one named for ``"cuda:1"``, ``[cpu]`` for the CPU."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return [device]
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass devices=['cpu'] to run the "
                           "kernels' plain versions")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


@dataclasses.dataclass(frozen=True)
class ShardMesh:
    """``shape`` shards, shard ``(ix, iy, iz)`` at list position
    ``(ix * my + iy) * mz + iz`` on ``devices[position]``."""
    shape: Tuple[int, int, int]
    devices: Tuple[torch.device, ...]

    @property
    def n_shards(self) -> int:
        return len(self.devices)

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
    visible CUDA device)."""
    devices = [torch.device(d) for d in
               (default_devices() if devices is None else devices)]
    if mesh_shape is None:
        mesh_shape = factor3(len(devices))
    mesh_shape = tuple(int(m) for m in mesh_shape)
    if len(mesh_shape) != 3 or min(mesh_shape) < 1:
        raise ValueError(f"mesh shape must be three positive ints, got "
                         f"{mesh_shape}")
    n = math.prod(mesh_shape)
    return ShardMesh(mesh_shape,
                     tuple(devices[i % len(devices)] for i in range(n)))


def split_blocks(mesh: ShardMesh, x: torch.Tensor) -> list:
    """Cut a global field (its first three axes) into the mesh's blocks,
    each a contiguous tensor on its shard's device (the JAX package's
    ``device_put`` with the grid sharding)."""
    b = mesh.block_shape(x.shape[:3])
    return [x[c[0] * b[0]:(c[0] + 1) * b[0], c[1] * b[1]:(c[1] + 1) * b[1],
              c[2] * b[2]:(c[2] + 1) * b[2]].to(dev).contiguous()
            for c, dev in zip(mesh.coords(), mesh.devices)]


def gather_blocks(mesh: ShardMesh, blocks, device=None) -> torch.Tensor:
    """The global field of a list of blocks, on ``device`` (default: the
    first shard's)."""
    device = blocks[0].device if device is None else device
    mx, my, mz = mesh.shape
    it = iter(b.to(device) for b in blocks)
    return torch.cat([torch.cat([torch.cat([next(it) for _ in range(mz)], 2)
                                 for _ in range(my)], 1)
                      for _ in range(mx)], 0)
