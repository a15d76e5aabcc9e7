"""Grids, meshes and the init's candidate culling, in numpy.

A frozen copy of the arithmetic of the system under test: the grid sizing
of ``set3d.f90:103-157`` (``ceil(extent / dx) + 1`` points plus the pad on
each side), the batch's common shape, the 256^3 cube rule of the shape
fitter's grid, the STL reader's vertex numbering (first occurrence), and
the block culling of the exact-distance init (every triangle whose distance
lower bound can beat a 16^3 block's upper bound).  The reference and the
roofline counts use these; neither reads them from the program.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass(frozen=True)
class Grid:
    """A uniform grid: ``shape`` points from ``origin`` at spacing ``dx``."""
    shape: tuple
    origin: tuple
    dx: float


def from_bbox(lo, hi, dx: float, pad_cells: int) -> Grid:
    shape, origin = [], []
    for a in range(3):
        n = int(math.ceil((hi[a] - lo[a]) / dx)) + 1
        shape.append(n + 2 * pad_cells)
        origin.append(lo[a] - pad_cells * dx)
    return Grid(tuple(s + 1 for s in shape), tuple(origin), dx)


def from_surface(vertices, dx: float, pad_cells: int) -> Grid:
    lo = tuple(float(v) for v in np.min(vertices, axis=0))
    hi = tuple(float(v) for v in np.max(vertices, axis=0))
    return from_bbox(lo, hi, dx, pad_cells)


def surface_diag(vertices) -> float:
    ext = np.max(vertices, axis=0) - np.min(vertices, axis=0)
    return float(np.sqrt(np.sum(ext * ext)))


def common_grids(vertex_sets, dx: float, pad_cells: int) -> list:
    """Each mesh's grid at the batch's common (per-axis largest) shape,
    each keeping its own origin."""
    grids = [from_surface(v, dx, pad_cells) for v in vertex_sets]
    shape = tuple(max(g.shape[a] for g in grids) for a in range(3))
    return [Grid(shape, g.origin, dx) for g in grids]


def cube_grid(vertices, n: int) -> Grid:
    """The shape fitter's grid: ``n`` points per axis over 1.2 times the
    body's largest extent, centred on its bounding box."""
    lo, hi = vertices.min(0), vertices.max(0)
    span = float((hi - lo).max()) * 1.2
    origin = tuple(float(c) for c in (lo + hi) / 2 - span / 2)
    return Grid((n, n, n), origin, span / (n - 1))


def soup_mesh(soup) -> tuple:
    """(vertices float64 (n, 3), elements int32 (m, 3)) of a float32
    triangle soup ((m, 3, 3) or (3m, 3)): equal rows are one vertex,
    numbered by first occurrence, as the STL reader numbers them."""
    rows = np.ascontiguousarray(np.asarray(soup, np.float32).reshape(-1, 3))
    key = rows.view(np.dtype((np.void, 12))).ravel()
    _, first, inverse = np.unique(key, return_index=True, return_inverse=True)
    order = np.argsort(first, kind="stable")
    rank = np.empty(order.size, np.int64)
    rank[order] = np.arange(order.size)
    verts = rows[first[order]].astype(np.float64)
    return verts, rank[inverse.reshape(-1)].reshape(-1, 3).astype(np.int32)


# ------------------------------ the culling ------------------------------

def _point_tri_d2(p, t):
    """Exact squared point-triangle distance, one pair per row (Ericson's
    regions), float64."""
    a, b, c = t[:, 0], t[:, 1], t[:, 2]
    ab, ac, ap = b - a, c - a, p - a
    d1, d2 = (ab * ap).sum(1), (ac * ap).sum(1)
    bp = p - b
    d3, d4 = (ab * bp).sum(1), (ac * bp).sum(1)
    cp_ = p - c
    d5, d6 = (ab * cp_).sum(1), (ac * cp_).sum(1)
    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2

    def g(x, y):
        return x / np.where(np.abs(y) > 1e-300, y, 1.0)

    t_ab = g(d1, d1 - d3)
    t_ac = g(d2, d2 - d6)
    t_bc = g(d4 - d3, (d4 - d3) + (d5 - d6))
    denom_in = va + vb + vc
    inv_in = 1.0 / np.where(np.abs(denom_in) > 1e-300, denom_in, 1.0)
    out = a + (vb * inv_in)[:, None] * ab + (vc * inv_in)[:, None] * ac
    for cond, val in [
            ((va <= 0) & ((d4 - d3) >= 0) & ((d5 - d6) >= 0),
             b + t_bc[:, None] * (c - b)),
            ((vb <= 0) & (d2 >= 0) & (d6 <= 0), a + t_ac[:, None] * ac),
            ((vc <= 0) & (d1 >= 0) & (d3 <= 0), a + t_ab[:, None] * ab),
            ((d6 >= 0) & (d5 <= d6), c),
            ((d3 >= 0) & (d4 <= d3), b),
            ((d1 <= 0) & (d2 <= 0), a)]:
        out = np.where(cond[:, None], val, out)
    u = p - out
    return (u * u).sum(1)


@dataclasses.dataclass(frozen=True)
class Rows:
    """The scan's rows: row r is the culling block ``bidx[r]`` (flat raster
    id) with the candidates ``flat[offsets[r]:offsets[r] + counts[r]]``,
    longest rows first."""
    bidx: np.ndarray
    counts: np.ndarray
    offsets: np.ndarray
    flat: np.ndarray
    block: int
    nblocks: tuple

    def table(self, sl: slice, width: int, sentinel: int) -> np.ndarray:
        counts = self.counts[sl]
        j = np.arange(width)
        if self.flat.size == 0:
            return np.full((counts.size, width), sentinel)
        idx = self.offsets[sl, None] + np.clip(j, 0, counts[:, None] - 1)
        return np.where(j < counts[:, None],
                        self.flat[np.clip(idx, 0, self.flat.size - 1)],
                        sentinel)

    @property
    def pairs(self) -> int:
        """(point, candidate) pairs the scan evaluates: every point of a
        block against each of its candidates."""
        return int(self.counts.sum()) * self.block ** 3


def culling_rows(grid: Grid, vertices, elements, *, block: int = 16,
                 margin: float = 0.0) -> Rows:
    """Per ``block``^3 point block, the triangles whose lower bound
    ``|centre - centroid| - R_b - r_t`` is at most the block's upper bound
    (exact distance from the centre to its best triangle plus ``R_b`` and
    ``margin``), pruned first over 4^3-block parents; float32 distances
    about a common centre with a slack that only adds candidates.  Each
    block's candidates keep their ascending triangle order."""
    verts = np.asarray(vertices, np.float64)
    elems = np.asarray(elements)
    tri = verts[elems]
    cent = tri.mean(axis=1)
    r_t = np.sqrt(((tri - cent[:, None, :]) ** 2).sum(-1)).max(axis=1)
    bs = int(block)
    nb = tuple(-(-s // bs) for s in grid.shape)
    ctr = [np.asarray(grid.origin[a]) + grid.dx *
           (np.arange(nb[a]) * bs + (bs - 1) / 2.0) for a in range(3)]
    cx, cy, cz = np.meshgrid(*ctr, indexing="ij")
    centers = np.stack([cx, cy, cz], axis=-1).reshape(-1, 3)
    R_b = grid.dx * np.sqrt(3.0) * (bs - 1) / 2.0
    B = centers.shape[0]
    shift = centers.mean(axis=0)
    cen32 = np.ascontiguousarray(centers - shift, np.float32)
    tc32 = np.ascontiguousarray((cent - shift).T, np.float32)
    c_sq = (cen32 ** 2).sum(-1)
    t_sq = (tc32 ** 2).sum(0)
    r32 = r_t.astype(np.float32)
    slack = np.float32(1e-3 * (R_b + margin) + 1e-9)

    def keep_rows(cen_rows, csq_rows, cen_abs, cols, Rb):
        d = np.dot(cen_rows, tc32[:, cols] if cols is not None else tc32)
        d *= -2.0
        d += csq_rows[:, None]
        ts = t_sq[cols] if cols is not None else t_sq
        rs = r32[cols] if cols is not None else r32
        d += ts[None, :]
        np.sqrt(np.maximum(d, 0.0, out=d), out=d)
        j = np.argmin(d + rs[None, :], axis=1)
        jg = cols[j] if cols is not None else j
        d_ex = np.sqrt(_point_tri_d2(cen_abs, tri[jg]))
        ub = (d_ex + Rb + margin).astype(np.float32)
        d -= rs[None, :]
        thresh = ub * np.float32(1.0 + 1e-3) + np.float32(Rb) + slack
        return d <= thresh[:, None]

    cf = 4
    nbc = tuple(-(-x // cf) for x in nb)
    R_c = grid.dx * np.sqrt(3.0) * (cf * bs - 1) / 2.0
    pid = np.arange(B)
    parent_of = ((((pid // (nb[1] * nb[2])) // cf) * nbc[1]
                  + ((pid // nb[2]) % nb[1]) // cf) * nbc[2]
                 + (pid % nb[2]) // cf)
    Bc = nbc[0] * nbc[1] * nbc[2]
    psum = np.zeros((Bc, 3), np.float64)
    pcnt = np.zeros(Bc, np.int64)
    np.add.at(psum, parent_of, cen32.astype(np.float64))
    np.add.at(pcnt, parent_of, 1)
    pcen = (psum / np.maximum(pcnt, 1)[:, None]).astype(np.float32)
    keep_c = keep_rows(pcen, (pcen ** 2).sum(-1),
                       pcen.astype(np.float64) + shift, None, R_c + R_b)
    order = np.argsort(parent_of, kind="stable")
    bounds = np.searchsorted(parent_of[order], np.arange(Bc + 1))
    cand = [np.empty(0, np.int32)] * B
    for pc in range(Bc):
        rows = order[bounds[pc]:bounds[pc + 1]]
        if rows.size == 0:
            continue
        cols = np.nonzero(keep_c[pc])[0]
        keep = keep_rows(cen32[rows], c_sq[rows], centers[rows], cols, R_b)
        for k, r in enumerate(rows):
            cand[r] = cols[keep[k]].astype(np.int32)
    counts = np.asarray([c.size for c in cand], np.int64)
    flat = (np.concatenate(cand) if B else np.empty(0, np.int32))
    offsets = np.zeros(B, np.int64)
    np.cumsum(counts[:-1], out=offsets[1:])
    by_len = np.argsort(-counts, kind="stable")
    return Rows(by_len.astype(np.int64), counts[by_len], offsets[by_len],
                flat, bs, nb)
