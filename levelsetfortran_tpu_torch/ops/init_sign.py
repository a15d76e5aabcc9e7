"""Signed-distance initialization from a triangle surface mesh (port of the
exact-distance init of ``levelsetfortran_tpu/ops/init_sign.py``).

phi0 = exact point-triangle distance (Ericson's region-based closest point)
signed by the angle-weighted pseudonormal of every triangle tied for the
minimum (Baerentzen & Aanaes).  Grid points go in 16^3 blocks; each block
scans its candidate triangles in tiles with a running (min, accumulator)
carry.  With culling (default) each block scans only the triangles whose
distance lower bound can beat the block's upper bound
(:func:`build_init_culling`, host numpy, as in the JAX package).

No kernel: these are PyTorch tensor ops.  The quadratic-form dot products
are computed elementwise in full float32, so a process-wide TF32 setting
(``torch.backends.cuda.matmul.allow_tf32``) cannot reach them — TF32 breaks
the region classification the way the TPU's default bf16 passes did.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..grid.grid import Grid3D

#: Bound on a scan step's (blocks, points, tile) pair count, as in the JAX
#: package (``init_sign.py:699``): ~4M pairs, some 40 float temporaries.
_PAIRS_PER_STEP = 2 ** 22


def _dot(u, v):
    return torch.sum(u * v, dim=-1)


def point_triangle_closest(p, a, b, c):
    """Closest point on triangle (a, b, c) to each point ``p`` (shapes
    broadcast) — branch-free Ericson, Real-Time Collision Detection §5.1.5."""
    ab, ac, ap = b - a, c - a, p - a
    d1, d2 = _dot(ab, ap), _dot(ac, ap)
    bp = p - b
    d3, d4 = _dot(ab, bp), _dot(ac, bp)
    cp = p - c
    d5, d6 = _dot(ab, cp), _dot(ac, cp)
    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2
    eps = 1e-30
    one = torch.ones_like(d1)

    def guard(x):
        return torch.where(torch.abs(x) > eps, x, one)

    t_ab = d1 / guard(d1 - d3)
    t_ac = d2 / guard(d2 - d6)
    denom_bc = (d4 - d3) + (d5 - d6)
    t_bc = (d4 - d3) / guard(denom_bc)
    inv_in = 1.0 / guard(va + vb + vc)
    v_in, w_in = vb * inv_in, vc * inv_in
    cp_ab = a + t_ab[..., None] * ab
    cp_ac = a + t_ac[..., None] * ac
    cp_bc = b + t_bc[..., None] * (c - b)
    cp_in = a + v_in[..., None] * ab + w_in[..., None] * ac
    in_a = (d1 <= 0) & (d2 <= 0)
    in_b = (d3 >= 0) & (d4 <= d3)
    in_c = (d6 >= 0) & (d5 <= d6)
    on_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    on_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    on_bc = (va <= 0) & ((d4 - d3) >= 0) & ((d5 - d6) >= 0)
    out = cp_in
    for cond, val in ((on_bc, cp_bc), (on_ac, cp_ac), (on_ab, cp_ab),
                      (in_c, c), (in_b, b), (in_a, a)):
        out = torch.where(cond[..., None], val, out)
    return out


def _np_point_tri_d2(p, t):
    """Exact squared point-triangle distance, host numpy, one pair per row
    (the cull build's exact-center upper bound)."""
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


def _triangle_features(tri):
    """Per-triangle unit normal and vertex angles: (n (..., 3), ang (..., 3))."""
    a, b, c = tri[..., 0, :], tri[..., 1, :], tri[..., 2, :]
    n = torch.linalg.cross(b - a, c - a)
    n = n / torch.sqrt(torch.clamp_min(_dot(n, n), 1e-30))[..., None]

    def angle_at(u, v):
        cr = torch.linalg.cross(u, v)
        return torch.atan2(torch.sqrt(torch.clamp_min(_dot(cr, cr), 1e-30)),
                           _dot(u, v))

    ang = torch.stack([angle_at(b - a, c - a), angle_at(a - b, c - b),
                       angle_at(a - c, b - c)], dim=-1)
    return n, ang


def _pdot(pc, v):
    """(G, P, T) dots of points (G, P, 3) with vectors (G, T, 3), summed
    elementwise in the working precision (no matmul, so no TF32)."""
    return (pc[:, :, None, 0] * v[:, None, :, 0]
            + pc[:, :, None, 1] * v[:, None, :, 1]
            + pc[:, :, None, 2] * v[:, None, :, 2])


def nearest_sign_scan(points, tri, feat=None, tile: int = 128,
                      rel_tie: float = 1e-3):
    """Fused (distance², pseudonormal accumulator) in one tiled scan.

    ``points`` (G, P, 3) and ``tri`` (G, E, 3, 3): G independent blocks
    (the JAX package vmaps the same per-block scan).  Per tile, the Ericson
    dots come from the quadratic form of four products (ab·p, ac·p, n·p,
    a·p) about each block's point mean; a new minimum more than ``rel_tie``
    below the running one discards the tie accumulator.  The argmin
    triangle is re-evaluated in the direct form for the exact distance.
    Tiles are cut at ``tile`` candidates, the last one short: a padded
    far-away sentinel contributes nothing, so the result is the padded
    scan's.
    """
    G, P, _ = points.shape
    E = tri.shape[1]
    if feat is None:
        feat = _triangle_features(tri)
    nrm, ang = feat
    dt = points.dtype
    shift = points.mean(dim=1, keepdim=True)          # (G, 1, 3)
    pc = points - shift
    p_sq = _dot(pc, pc)                                # (G, P)
    eps = 1e-30
    qeps = (64.0 * float(np.finfo(np.float32).eps)
            * p_sq.amax(dim=1, keepdim=True))         # (G, 1)
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
        nr = torch.linalg.cross(ab, ac)
        snn = _dot(nr, nr)
        rsnn = 1.0 / torch.clamp_min(snn, eps)
        rsab = 1.0 / torch.clamp_min(_dot(ab, ab), eps)
        rsac = 1.0 / torch.clamp_min(_dot(ac, ac), eps)
        rsbc = 1.0 / torch.clamp_min(_dot(bc, bc), eps)
        cn = _dot(nr, a)[:, None, :]
        ab_a, ab_b, ab_c = (_dot(ab, v)[:, None, :] for v in (a, b, c))
        ac_a, ac_b, ac_c = (_dot(ac, v)[:, None, :] for v in (a, b, c))
        bc_b = _dot(bc, b)[:, None, :]
        saa, sbb, scc = (_dot(v, v)[:, None, :] for v in (a, b, c))
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

        thresh = new_d * (1.0 + rel_tie) + 1e-12 + qeps
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

    idx = best_i[:, :, None, None].expand(G, P, 3, 3)
    tb = torch.gather(tri, 1, idx)                     # (G, P, 3, 3)
    cpb = point_triangle_closest(points, tb[:, :, 0], tb[:, :, 1],
                                 tb[:, :, 2])
    ub = points - cpb
    return _dot(ub, ub), acc


# ------------------------- block-culled init -------------------------

@dataclasses.dataclass(frozen=True)
class InitCulling:
    """Per-grid-block candidate triangle lists, bucketed by count:
    ``cands[g]`` is a (Bg, Kg) int32 table into the triangles (rows padded
    with the sentinel index E) and ``bidxs[g]`` the flat raster block ids
    of its rows."""
    cands: tuple
    bidxs: tuple
    block: int
    nblocks: tuple


def build_init_culling(grid: Grid3D, vertices, elements, *, block: int = 16,
                       tile: int = 128) -> InitCulling:
    """Host-side spatial culling: per grid-block candidate triangle lists
    (``init_sign.py:495-657`` of the JAX package).

    Keeps, per ``block``³ point block, the triangles with
    ``lb(b,t) = |center_b - centroid_t| - R_b - r_t`` at most the block's
    upper bound (exact distance from the block center to its best triangle
    plus R_b): every triangle nearest — or distance-tied — for any point
    of the block survives, so the candidate set is exact.  Two-level prune
    (4^3-block parents first); float32 GEMM-form distances about a common
    center with an absolute slack that only ever adds candidates.  Blocks
    are bucketed by candidate count (K = tile * 2^j), so the padded work
    tracks the mean count, not the heavy-tailed maximum.
    """
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

    B, E = centers.shape[0], tri.shape[0]
    hit_r_parts, hit_t_parts, hit_p_parts = [], [], []
    counts = np.zeros(B, np.int64)
    shift = centers.mean(axis=0)
    cen32 = np.ascontiguousarray(centers - shift, np.float32)
    tc32 = np.ascontiguousarray((cent - shift).T, np.float32)
    c_sq = (cen32 ** 2).sum(-1)
    t_sq = (tc32 ** 2).sum(0)
    r32 = r_t.astype(np.float32)
    slack = np.float32(1e-3 * R_b + 1e-9)

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
        d_ex = np.sqrt(_np_point_tri_d2(cen_abs, tri[jg]))
        ub = (d_ex + Rb).astype(np.float32)
        d -= rs[None, :]
        thresh = ub * np.float32(1.0 + 1e-3) + np.float32(Rb) + slack
        return d <= thresh[:, None]

    cf = 4
    nbc = tuple(-(-x // cf) for x in nb)
    R_c = grid.dx * np.sqrt(3.0) * (cf * bs - 1) / 2.0
    pid = np.arange(B)
    pbx = (pid // (nb[1] * nb[2])) // cf
    pby = ((pid // nb[2]) % nb[1]) // cf
    pbz = (pid % nb[2]) // cf
    parent_of = (pbx * nbc[1] + pby) * nbc[2] + pbz
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
    for pc in range(Bc):
        rows = order[bounds[pc]:bounds[pc + 1]]
        if rows.size == 0:
            continue
        cols = np.nonzero(keep_c[pc])[0]
        keep = keep_rows(cen32[rows], c_sq[rows], centers[rows], cols, R_b)
        rr, tt = np.nonzero(keep)
        cnt = keep.sum(axis=1)
        local_start = np.zeros(rows.size + 1, np.int64)
        np.cumsum(cnt, out=local_start[1:])
        hit_r_parts.append(rows[rr].astype(np.int64))
        hit_t_parts.append(cols[tt].astype(np.int32))
        hit_p_parts.append(np.arange(rr.size, dtype=np.int64)
                           - local_start[rr])
        counts[rows] = cnt
    hit_r = (np.concatenate(hit_r_parts) if hit_r_parts
             else np.empty(0, np.int64))
    hit_t = (np.concatenate(hit_t_parts) if hit_t_parts
             else np.empty(0, np.int32))
    pos = (np.concatenate(hit_p_parts) if hit_p_parts
           else np.empty(0, np.int64))
    kmax = int(counts.max()) if B else 0
    levels = [tile]
    while levels[-1] < kmax:
        levels.append(levels[-1] * 2)
    level_of = np.searchsorted(np.asarray(levels), counts)
    hit_level = level_of[hit_r]
    cands, bidxs = [], []
    for li, K in enumerate(levels):
        sel = np.nonzero(level_of == li)[0]
        if sel.size == 0:
            continue
        local = np.empty(B, np.int64)
        local[sel] = np.arange(sel.size)
        m = hit_level == li
        cand = np.full((sel.size, K), E, np.int32)
        cand[local[hit_r[m]], pos[m]] = hit_t[m]
        cands.append(cand)
        bidxs.append(sel.astype(np.int32))
    return InitCulling(tuple(cands), tuple(bidxs), bs, nb)


def _block_offsets(block: int, device):
    r = torch.arange(block, device=device)
    li, lj, lk = torch.meshgrid(r, r, r, indexing="ij")
    return torch.stack([li, lj, lk], dim=-1).reshape(-1, 3)    # (P, 3)


def _blocks_to_grid(results, nblocks, block, shape):
    nbx, nby, nbz = nblocks
    res = results.reshape(nbx, nby, nbz, block, block, block)
    res = res.permute(0, 3, 1, 4, 2, 5).reshape(
        nbx * block, nby * block, nbz * block)
    return res[:shape[0], :shape[1], :shape[2]].contiguous()


def _scan_blocks(grid, tri_s, feat, rows, borig, loc, *, dtype, tile):
    """Signed distances of the point blocks at ``borig`` (G, 3) against
    their candidate rows (G, K) of ``tri_s``: (G, P)."""
    origin = torch.tensor(grid.origin, dtype=dtype, device=tri_s.device)
    pts = origin + grid.dx * (borig[:, None, :] + loc[None]).to(dtype)
    d2, ps = nearest_sign_scan(pts, tri_s[rows],
                               tuple(f[rows] for f in feat), tile=tile)
    sgn = torch.where(ps < 0, -1.0, 1.0).to(dtype)
    return sgn * torch.sqrt(torch.clamp_min(d2, 1e-30))


def _culled_init(grid: Grid3D, tri, culling: InitCulling, *, dtype, tile):
    """Blocked exact init over the bucketed per-block candidate lists."""
    device = tri.device
    E = tri.shape[0]
    far = torch.full((1, 3, 3), 1e30, dtype=tri.dtype, device=device)
    tri_s = torch.cat([tri, far], dim=0)            # sentinel at index E
    feat = _triangle_features(tri_s)
    block = culling.block
    nbx, nby, nbz = culling.nblocks
    P = block ** 3
    loc = _block_offsets(block, device)
    results = torch.zeros((nbx * nby * nbz, P), dtype=dtype, device=device)
    for cand, bidx in zip(culling.cands, culling.bidxs):
        Bg = cand.shape[0]
        counts = (cand != E).sum(axis=1)
        group = max(1, min(Bg, _PAIRS_PER_STEP // (P * tile)))
        borig = np.stack([bidx // (nby * nbz), (bidx // nbz) % nby,
                          bidx % nbz], axis=-1) * block
        for g0 in range(0, Bg, group):
            sl = slice(g0, g0 + group)
            kt = max(1, int(counts[sl].max()))     # trailing sentinels only
            rows = torch.as_tensor(cand[sl, :kt], dtype=torch.long,
                                   device=device)
            results[torch.as_tensor(bidx[sl], dtype=torch.long,
                                    device=device)] = _scan_blocks(
                grid, tri_s, feat, rows,
                torch.as_tensor(borig[sl], device=device), loc,
                dtype=dtype, tile=tile)
    return _blocks_to_grid(results, culling.nblocks, block, grid.shape)


def _dense_signed_distance_init(grid: Grid3D, tri, *, dtype, tile: int,
                                block: int = 16):
    """All-pairs exact init: every point block scans every triangle."""
    device = tri.device
    nb = tuple(-(-s // block) for s in grid.shape)
    B, P, E = nb[0] * nb[1] * nb[2], block ** 3, tri.shape[0]
    group = max(1, min(B, _PAIRS_PER_STEP // (P * tile)))
    loc = _block_offsets(block, device)
    feat = _triangle_features(tri)
    bid = torch.arange(B, device=device)
    borig = torch.stack([bid // (nb[1] * nb[2]), (bid // nb[2]) % nb[1],
                         bid % nb[2]], dim=-1) * block
    all_rows = torch.arange(E, device=device)
    parts = []
    for g0 in range(0, B, group):
        o = borig[g0:g0 + group]
        rows = all_rows[None].expand(o.shape[0], E)
        parts.append(_scan_blocks(grid, tri, feat, rows, o, loc,
                                  dtype=dtype, tile=tile))
    return _blocks_to_grid(torch.cat(parts), nb, block, grid.shape)


def signed_distance_init(grid: Grid3D, vertices, elements, *,
                         dtype=torch.float32, device="cpu", tile: int = 512,
                         culling="auto", cull_block: int = 16):
    """Exact-distance signed initialization on the full grid.

    ``culling``: ``"auto"`` builds per-block candidate lists on the host
    (:func:`build_init_culling`); an :class:`InitCulling` is used as is;
    ``None`` scans all pairs.  ``vertices`` (n, 3) and ``elements`` (m, 3)
    are numpy arrays."""
    if isinstance(culling, str) and culling == "auto":
        culling = build_init_culling(grid, vertices, elements,
                                     block=cull_block, tile=tile)
    v = torch.as_tensor(np.asarray(vertices), dtype=dtype, device=device)
    tri = v[torch.as_tensor(np.asarray(elements), dtype=torch.long,
                            device=device)]
    if culling is None:
        return _dense_signed_distance_init(grid, tri, dtype=dtype, tile=tile)
    return _culled_init(grid, tri, culling, dtype=dtype, tile=tile)
