"""Kernel K7 — the exact-distance init's selection scan — with its plain
PyTorch version.

K7 (``csrc/init_select.cu``) has no Pallas counterpart.  It replaces the
scan that the JAX package compiles into its jitted init:
``levelsetfortran_tpu/ops/init_sign.py:nearest_sign_scan`` (:207) inside
``_culled_init`` (:660) and ``_dense_signed_distance_init`` (:785), without
the final re-evaluation.  A row is one culling block of grid points with
its candidate triangles.  For each point the scan finds the candidate
nearest by the quadratic-form Ericson distance about the row's shift, and
the angle-weighted pseudonormal accumulator over the candidates tied
within ``rel_tie``, tile by tile of ``tile`` candidates
(:func:`_select_scan`).

What bounds it on the H100 is arithmetic: ~70 float operations per (point,
candidate) pair against a few bytes per candidate.  The kernel forms each
tile's per-triangle constants once per thread block in shared memory and
makes two passes over the tile (the tile's minimum first, then the tie sum
against the threshold of the new minimum), each thread carrying two
points in registers.

The plain version is written so that the kernel can follow it to the last
bit: the dot products and the cross product are spelled out in a fixed
order (``interp.dot3``, :func:`_cross3`; a CUDA ``torch.sum`` over three
terms adds the first and the last first, and ``torch.linalg.cross`` may
contract into FMAs), each row's shift is given (the init passes its
block's centre), and the kernel is built with ``--fmad=false``.  So the kernel's argmin indices
equal the plain version's; only the accumulator, a sum over each tile in
another order, differs in its last bits (its sign is what the init uses).

:func:`select_rows` runs the plain version only for a CPU tensor; for a
CUDA tensor it launches K7 or raises.  The init takes the wrapper for
float32 and the plain version for bfloat16 and float64
(``weno_cuda.kernel_supported``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from .. import cuda_build
from .interp import dot3 as _dot3
from .weno_cuda import on_device, scalar_type

#: Bound on a plain scan step's (rows, points, tile) pair count, as in the
#: JAX package (``init_sign.py:699``): ~4M pairs, some 40 float temporaries.
PAIRS_PER_STEP = 2 ** 22
#: K7's per-triangle constants in shared memory: 32 floats a candidate.
_TRI_BYTES = 128
#: The shared memory one thread block of K7 may take (H100: 227 KB).
_SMEM_LIMIT = 232448


def _cross3(u, v):
    """``u x v`` over a last axis of 3, each component one product minus
    another (no FMA)."""
    u0, u1, u2 = u.unbind(-1)
    v0, v1, v2 = v.unbind(-1)
    return torch.stack([u1 * v2 - u2 * v1, u2 * v0 - u0 * v2,
                        u0 * v1 - u1 * v0], dim=-1)


def _pdot(pc, v):
    """(G, P, T) dots of points (G, P, 3) with vectors (G, T, 3), summed
    elementwise in the working precision (no matmul, so no TF32)."""
    return (pc[:, :, None, 0] * v[:, None, :, 0]
            + pc[:, :, None, 1] * v[:, None, :, 1]
            + pc[:, :, None, 2] * v[:, None, :, 2])


def _select_scan(points, tri, ang, tile, rel_tie=1e-3, shift=None):
    """The nearest-triangle selection scan (the JAX package's
    ``nearest_sign_scan`` without its final re-evaluation): (argmin
    triangle index (G, P), pseudonormal accumulator (G, P)).

    ``points`` (G, P, 3), ``tri`` (G, E, 3, 3) and its vertex angles
    ``ang`` (G, E, 3) (:func:`~.init_sign._triangle_features`): G
    independent blocks (the JAX package vmaps the same per-block scan).
    ``shift`` (G, 3): the points' centre for the quadratic form, by
    default their mean.  Per tile, the Ericson dots come from the
    quadratic form of four products (ab·p, ac·p, n·p, a·p) about the
    shift; a new minimum more than ``rel_tie`` below the running one
    discards the tie accumulator.  Tiles are cut at ``tile`` candidates,
    the last one short: a padded far-away sentinel contributes nothing, so
    the result is the padded scan's.
    """
    G, P, _ = points.shape
    E = tri.shape[1]
    dt = points.dtype
    shift = (points.mean(dim=1, keepdim=True) if shift is None
             else shift[:, None, :])                   # (G, 1, 3)
    pc = points - shift
    p_sq = _dot3(pc, pc)                               # (G, P)
    eps = 1e-30
    qeps = (64.0 * float(np.finfo(np.float32).eps)
            * p_sq.amax(dim=1, keepdim=True))         # (G, 1)
    rounded = scalar_type(dt)
    tie, tie_floor = float(rounded(1.0 + rel_tie)), float(rounded(1e-12))
    best_d = torch.full((G, P), math.inf, dtype=dt, device=points.device)
    acc = torch.zeros((G, P), dtype=dt, device=points.device)
    best_i = torch.zeros((G, P), dtype=torch.long, device=points.device)
    for base in range(0, E, tile):
        tb = tri[:, base:base + tile]
        ang_t = ang[:, base:base + tile]
        a = tb[:, :, 0, :] - shift                     # (G, T, 3)
        b = tb[:, :, 1, :] - shift
        c = tb[:, :, 2, :] - shift
        ab, ac, bc = b - a, c - a, c - b
        nr = _cross3(ab, ac)
        snn = _dot3(nr, nr)
        rsnn = 1.0 / torch.clamp_min(snn, eps)
        rsab = 1.0 / torch.clamp_min(_dot3(ab, ab), eps)
        rsac = 1.0 / torch.clamp_min(_dot3(ac, ac), eps)
        rsbc = 1.0 / torch.clamp_min(_dot3(bc, bc), eps)
        cn = _dot3(nr, a)[:, None, :]
        ab_a, ab_b, ab_c = (_dot3(ab, v)[:, None, :] for v in (a, b, c))
        ac_a, ac_b, ac_c = (_dot3(ac, v)[:, None, :] for v in (a, b, c))
        bc_b = _dot3(bc, b)[:, None, :]
        saa, sbb, scc = (_dot3(v, v)[:, None, :] for v in (a, b, c))
        g1, g2, g3, g4 = (_pdot(pc, v) for v in (ab, ac, nr, a))

        d1, d2 = g1 - ab_a, g2 - ac_a
        d3, d4 = g1 - ab_b, g2 - ac_b
        d5, d6 = g1 - ab_c, g2 - ac_c
        va = d3 * d6 - d5 * d4
        vb = d5 * d2 - d1 * d6
        vc = d1 * d4 - d3 * d2
        in_a = (d1 <= 0) & (d2 <= 0)
        in_b = (d3 >= 0) & (d4 <= d3)
        in_c = (d6 >= 0) & (d5 <= d6)
        on_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
        on_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
        on_bc = (va <= 0) & ((d4 - d3) >= 0) & ((d5 - d6) >= 0)

        ap2 = p_sq[:, :, None] - 2.0 * g4 + saa
        bp2 = ap2 - 2.0 * g1 + (sbb - saa)
        cp2 = ap2 - 2.0 * g2 + (scc - saa)
        bcbp = (g2 - g1) - bc_b
        plane = g3 - cn                                # n·(p − a)
        d = plane * plane * rsnn[:, None, :]
        d = torch.where(on_bc, bp2 - bcbp * bcbp * rsbc[:, None, :], d)
        d = torch.where(on_ac, ap2 - d2 * d2 * rsac[:, None, :], d)
        d = torch.where(on_ab, ap2 - d1 * d1 * rsab[:, None, :], d)
        d = torch.where(in_c, cp2, d)
        d = torch.where(in_b, bp2, d)
        d = torch.where(in_a, ap2, d)
        d = torch.clamp_min(d, 0.0)
        tile_d, tile_best = torch.min(d, dim=2)
        better = tile_d < best_d
        new_d = torch.where(better, tile_d, best_d)
        best_i = torch.where(better, base + tile_best, best_i)

        thresh = new_d * tie + tie_floor + qeps
        pi = torch.full_like(d, math.pi)
        w = torch.where(in_a, ang_t[:, None, :, 0],
                        torch.where(in_b, ang_t[:, None, :, 1],
                                    torch.where(in_c, ang_t[:, None, :, 2],
                                                pi)))
        upn = plane * torch.rsqrt(torch.clamp_min(snn, eps))[:, None, :]
        contrib = torch.where(d <= thresh[:, :, None], w * upn,
                              torch.zeros_like(d))
        acc = torch.where(best_d <= thresh, acc,
                          torch.zeros_like(acc)) + contrib.sum(dim=2)
        best_d = new_d
    return best_i, acc


# ------------------------------ the rows -------------------------------

@dataclasses.dataclass(frozen=True)
class Rows:
    """The rows of one init's selection scan, on the host: row r is the
    culling block ``bidx[r]`` (flat raster id) with the ``counts[r]``
    candidates ``flat[offsets[r]:offsets[r] + counts[r]]`` (triangle ids;
    the sentinel id may appear among them), or, where ``flat`` is None
    (the dense init), every triangle ``0 .. counts[r] - 1``.  Rows are in
    descending order of their counts, so that the card takes the longest
    first and a plain scan step pads little."""
    bidx: np.ndarray
    counts: np.ndarray
    offsets: np.ndarray
    flat: Optional[np.ndarray]

    @property
    def pairs_per_point(self) -> int:
        """Candidates scanned per point of a row, summed over the rows."""
        return int(self.counts.sum())

    def table(self, sl: slice, width: int, sentinel: int) -> np.ndarray:
        """Rows ``sl`` as a (rows, width) table, padded with ``sentinel``
        past each row's count."""
        counts = self.counts[sl]
        j = np.arange(width)
        if self.flat is None:
            return np.where(j < counts[:, None], j, sentinel)
        if self.flat.size == 0:
            return np.full((counts.size, width), sentinel)
        idx = self.offsets[sl, None] + np.clip(j, 0, counts[:, None] - 1)
        return np.where(j < counts[:, None],
                        self.flat[np.clip(idx, 0, self.flat.size - 1)],
                        sentinel)


def pack_rows(cands, bidxs, sentinel: int) -> Rows:
    """The rows of bucketed candidate tables (:class:`~.init_sign.
    InitCulling`'s ``cands`` (Bg, Kg) and ``bidxs``): each row keeps its
    entries up to its last non-sentinel one, so that its tiles start where
    the table's do."""
    bidx, counts, parts = [], [], []
    for cand, ids in zip(cands, bidxs):
        cand = np.asarray(cand)
        live = cand != sentinel
        n = np.where(live.any(axis=1),
                     cand.shape[1] - np.argmax(live[:, ::-1], axis=1), 0)
        parts.append(cand[np.arange(cand.shape[1])[None, :] < n[:, None]])
        bidx.append(np.asarray(ids, np.int64))
        counts.append(n.astype(np.int64))
    bidx = np.concatenate(bidx) if bidx else np.empty(0, np.int64)
    counts = np.concatenate(counts) if counts else np.empty(0, np.int64)
    flat = (np.concatenate(parts).astype(np.int32) if parts
            else np.empty(0, np.int32))
    offsets = np.zeros(counts.size, np.int64)
    np.cumsum(counts[:-1], out=offsets[1:])
    order = np.argsort(-counts, kind="stable")
    return Rows(bidx[order], counts[order], offsets[order], flat)


def dense_rows(n_blocks: int, n_tri: int) -> Rows:
    """Every block against every triangle (the dense init)."""
    return Rows(np.arange(n_blocks, dtype=np.int64),
                np.full(n_blocks, n_tri, np.int64),
                np.zeros(n_blocks, np.int64), None)


def triangle_ids(rows: Rows, best_i, device):
    """The triangle of each point from its position ``best_i`` (R, P) in
    its row."""
    best_i = best_i.long()
    if rows.flat is None:
        return best_i
    flat = torch.as_tensor(rows.flat, dtype=torch.long, device=device)
    off = torch.as_tensor(rows.offsets, device=device)
    return flat[off[:, None] + best_i]


# ----------------------------- K7 and its plain version -----------------

def select_rows_plain(pts, shift, tri_s, ang, rows: Rows, *, tile: int,
                      rel_tie: float = 1e-3):
    """The plain version of :func:`select_rows` (any dtype, any device):
    :func:`_select_scan` over groups of rows of at most
    :data:`PAIRS_PER_STEP` (row, point, tile) pairs, each row padded with
    the sentinel (``tri_s``'s last triangle) to the group's longest."""
    R, P, _ = pts.shape
    sentinel = tri_s.shape[0] - 1
    group = max(1, min(max(R, 1), PAIRS_PER_STEP // (P * tile)))
    best = torch.zeros((R, P), dtype=torch.long, device=pts.device)
    acc = torch.zeros((R, P), dtype=pts.dtype, device=pts.device)
    for r0 in range(0, R, group):
        sl = slice(r0, r0 + group)
        width = max(1, int(rows.counts[sl].max()))
        idx = torch.as_tensor(rows.table(sl, width, sentinel),
                              dtype=torch.long, device=pts.device)
        best[sl], acc[sl] = _select_scan(pts[sl], tri_s[idx], ang[idx],
                                         tile, rel_tie, shift=shift[sl])
    return best, acc


def _check(pts, shift, tri_s, ang, tile):
    dev = pts.device
    R, P = pts.shape[:2]
    for name, t, shape in (("pts", pts, (R, P, 3)), ("shift", shift, (R, 3)),
                           ("tri_s", tri_s, (tri_s.shape[0], 3, 3)),
                           ("ang", ang, (tri_s.shape[0], 3))):
        if (t.dtype != torch.float32 or tuple(t.shape) != shape
                or t.device != dev or not t.is_contiguous()):
            raise ValueError(f"select_rows: {name} must be a contiguous "
                             f"float32 {shape} tensor on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if not 1 <= tile <= _SMEM_LIMIT // _TRI_BYTES:
        raise ValueError(f"select_rows: tile {tile} outside 1.."
                         f"{_SMEM_LIMIT // _TRI_BYTES}")
    if R * P >= 2 ** 31 or R >= 65536:
        raise ValueError(f"select_rows: {R} rows of {P} points is too many "
                         f"for one launch")


def select_rows(pts, shift, tri_s, ang, rows: Rows, *, tile: int,
                rel_tie: float = 1e-3):
    """The selection scan of every row: (best_i (R, P), the position of
    each point's nearest candidate in its row; acc (R, P), the
    pseudonormal accumulator).  ``pts`` (R, P, 3) are the rows' points,
    ``shift`` (R, 3) their centres, ``tri_s`` (E + 1, 3, 3) the triangles
    with the far sentinel last and ``ang`` their vertex angles.  One K7
    launch for a CUDA tensor (float32 only; anything else raises), the
    plain version for a CPU one."""
    if pts.device.type == "cpu":
        return select_rows_plain(pts, shift, tri_s, ang, rows, tile=tile,
                                 rel_tie=rel_tie)
    if pts.dtype != torch.float32:
        raise TypeError(f"select_rows: the CUDA kernel takes float32 only, "
                        f"got {pts.dtype} (other dtypes take the plain "
                        f"version: weno_cuda.kernel_supported)")
    _check(pts, shift, tri_s, ang, tile)
    R, P = pts.shape[:2]
    dev = pts.device
    best = torch.empty((R, P), dtype=torch.int32, device=dev)
    acc = torch.empty((R, P), dtype=torch.float32, device=dev)
    if R == 0:
        return best.long(), acc
    dense = rows.flat is None
    counts = torch.as_tensor(rows.counts, dtype=torch.int32, device=dev)
    offsets = None if dense else torch.as_tensor(rows.offsets, device=dev)
    flat = None if dense else torch.as_tensor(rows.flat, device=dev)
    t = scalar_type(torch.float32)
    with on_device(dev):
        cuda_build.launch(
            "lsf_init_select_f32", pts.data_ptr(), shift.data_ptr(),
            tri_s.data_ptr(), ang.data_ptr(),
            None if dense else flat.data_ptr(),
            None if dense else offsets.data_ptr(), counts.data_ptr(), R, P,
            int(tile), float(t(1.0 + rel_tie)), float(t(1e-12)),
            best.data_ptr(), acc.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    select_rows.launches += 1
    return best.long(), acc


select_rows.launches = 0
