"""Cartesian grid geometry (port of ``levelsetfortran_tpu/grid/grid.py``).

``set3d.f90:89-173`` sizes a uniform grid around the surface bounding box
with ``n = ceil(extent/dx) + 1`` points per axis plus ``pad`` cells on each
side.  Coordinates are generated on demand on an explicit device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Grid3D:
    """A uniform axis-aligned 3D grid; ``shape`` counts grid points."""

    shape: Tuple[int, int, int]
    origin: Tuple[float, float, float]
    dx: float

    @property
    def upper(self) -> Tuple[float, float, float]:
        """The last grid point's coordinates."""
        return tuple(o + (n - 1) * self.dx
                     for o, n in zip(self.origin, self.shape))

    @property
    def n_points(self) -> int:
        return int(np.prod(self.shape))

    @property
    def diag(self) -> float:
        """Length of the grid's own diagonal (the reference normalizes dt
        by the SURFACE's, :func:`surface_diag`)."""
        ext = [(n - 1) * self.dx for n in self.shape]
        return math.sqrt(sum(e * e for e in ext))

    def axis_coords(self, axis: int, dtype=torch.float32,
                    device=None) -> torch.Tensor:
        n = self.shape[axis]
        return self.origin[axis] + self.dx * torch.arange(
            n, dtype=dtype, device=device)

    def coords(self, dtype=torch.float32, device=None) -> torch.Tensor:
        """Dense (nx, ny, nz, 3) coordinates — only for small grids/tests."""
        xs = [self.axis_coords(a, dtype, device) for a in range(3)]
        gx, gy, gz = torch.meshgrid(*xs, indexing="ij")
        return torch.stack([gx, gy, gz], dim=-1)

    def world_to_index(self, points: torch.Tensor) -> torch.Tensor:
        origin = torch.tensor(self.origin, dtype=points.dtype,
                              device=points.device)
        return (points - origin) / self.dx


def from_bbox(lo, hi, dx: float, pad_cells: int,
              multiple_of: Tuple[int, int, int] = (1, 1, 1)) -> Grid3D:
    """``set3d.f90:143-157``: ``ceil(extent/dx) + 1`` points plus
    ``pad_cells`` on each side (reference allocates ``0:nx`` => nx+1)."""
    shape = []
    origin = []
    for a in range(3):
        n = int(math.ceil((hi[a] - lo[a]) / dx)) + 1
        shape.append(n + 2 * pad_cells)
        origin.append(lo[a] - pad_cells * dx)
    shape = tuple(-(-(s + 1) // m) * m for s, m in zip(shape, multiple_of))
    return Grid3D(shape=shape, origin=tuple(origin), dx=dx)


def from_surface(vertices: np.ndarray, dx: float, pad_cells: int,
                 multiple_of: Tuple[int, int, int] = (1, 1, 1)) -> Grid3D:
    """Grid around a surface mesh's bbox (reference ``set3d.f90:103-157``)."""
    lo = tuple(float(v) for v in np.min(vertices, axis=0))
    hi = tuple(float(v) for v in np.max(vertices, axis=0))
    return from_bbox(lo, hi, dx, pad_cells, multiple_of)


def surface_diag(vertices: np.ndarray) -> float:
    """Surface bbox diagonal (set3d.f90:135-137,301): ``dxx = dx / diag``."""
    ext = np.max(vertices, axis=0) - np.min(vertices, axis=0)
    return float(np.sqrt(np.sum(ext * ext)))
