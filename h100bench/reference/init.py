"""The exact signed-distance init, in plain PyTorch.

phi0 at each grid point is the exact distance to the nearest triangle
(Ericson's region-based closest point), signed by the angle-weighted
pseudonormal of every triangle tied with the nearest within a relative
1e-3 (Baerentzen & Aanaes).  Points go in the culling's 16^3 blocks
(:func:`.geometry.culling_rows`); each block scans its candidates in tiles
of 512 with a running (minimum, tie accumulator).  The scan's distances
come from a quadratic form about the block's centre, its dot products
spelled out in a fixed order; the value at each point is then the direct
squared distance to its triangle, through which alone a vertex gradient
flows.  Frozen copy of the system's plain math; float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch

#: (row, point, candidate) triples per step of the scan.
PAIRS_PER_STEP = 2 ** 24
#: Candidates per tile of the scan.
TILE = 512
#: Points per chunk of the exact re-evaluation.
EXACT_POINTS = 2 ** 22


def dot3(u, v):
    p = u * v
    return p[..., 0] + p[..., 1] + p[..., 2]


def cross3(u, v):
    u0, u1, u2 = u.unbind(-1)
    v0, v1, v2 = v.unbind(-1)
    return torch.stack([u1 * v2 - u2 * v1, u2 * v0 - u0 * v2,
                        u0 * v1 - u1 * v0], dim=-1)


def _sum3(u, v):
    return torch.sum(u * v, dim=-1)


def closest_point(p, a, b, c):
    """Closest point on triangle (a, b, c) to each point ``p``."""
    ab, ac, ap = b - a, c - a, p - a
    d1, d2 = _sum3(ab, ap), _sum3(ac, ap)
    bp = p - b
    d3, d4 = _sum3(ab, bp), _sum3(ac, bp)
    cp = p - c
    d5, d6 = _sum3(ab, cp), _sum3(ac, cp)
    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2
    one = torch.ones_like(d1)

    def guard(x):
        return torch.where(torch.abs(x) > 1e-30, x, one)

    t_ab = d1 / guard(d1 - d3)
    t_ac = d2 / guard(d2 - d6)
    t_bc = (d4 - d3) / guard((d4 - d3) + (d5 - d6))
    inv_in = 1.0 / guard(va + vb + vc)
    v_in, w_in = vb * inv_in, vc * inv_in
    out = a + v_in[..., None] * ab + w_in[..., None] * ac
    for cond, val in (
            ((va <= 0) & ((d4 - d3) >= 0) & ((d5 - d6) >= 0),
             b + t_bc[..., None] * (c - b)),
            ((vb <= 0) & (d2 >= 0) & (d6 <= 0), a + t_ac[..., None] * ac),
            ((vc <= 0) & (d1 >= 0) & (d3 <= 0), a + t_ab[..., None] * ab),
            ((d6 >= 0) & (d5 <= d6), c),
            ((d3 >= 0) & (d4 <= d3), b),
            ((d1 <= 0) & (d2 <= 0), a)):
        out = torch.where(cond[..., None], val, out)
    return out


def vertex_angles(tri):
    """Each triangle's angles at its three vertices, (..., 3)."""
    a, b, c = tri[..., 0, :], tri[..., 1, :], tri[..., 2, :]

    def angle_at(u, v):
        cr = torch.linalg.cross(u, v)
        return torch.atan2(torch.sqrt(torch.clamp_min(_sum3(cr, cr), 1e-30)),
                           _sum3(u, v))

    return torch.stack([angle_at(b - a, c - a), angle_at(a - b, c - b),
                        angle_at(a - c, b - c)], dim=-1)


def scan(points, shift, tri, ang, rel_tie=1e-3):
    """(nearest candidate (G, P), tie accumulator (G, P)) of points
    (G, P, 3) against candidates (G, E, 3, 3) with vertex angles
    (G, E, 3), about the block centres ``shift`` (G, 3)."""
    G, P, _ = points.shape
    E = tri.shape[1]
    dt = points.dtype
    shift = shift[:, None, :]
    pc = points - shift
    p_sq = dot3(pc, pc)
    eps = 1e-30
    qeps = 64.0 * float(np.finfo(np.float32).eps) * p_sq.amax(
        dim=1, keepdim=True)
    tie = float(np.float32(1.0 + rel_tie))
    tie_floor = float(np.float32(1e-12))
    best_d = torch.full((G, P), math.inf, dtype=dt, device=points.device)
    acc = torch.zeros((G, P), dtype=dt, device=points.device)
    best_i = torch.zeros((G, P), dtype=torch.long, device=points.device)

    def pdot(v):
        return (pc[:, :, None, 0] * v[:, None, :, 0]
                + pc[:, :, None, 1] * v[:, None, :, 1]
                + pc[:, :, None, 2] * v[:, None, :, 2])

    for base in range(0, E, TILE):
        tb = tri[:, base:base + TILE]
        ang_t = ang[:, base:base + TILE]
        a = tb[:, :, 0, :] - shift
        b = tb[:, :, 1, :] - shift
        c = tb[:, :, 2, :] - shift
        ab, ac, bc = b - a, c - a, c - b
        nr = cross3(ab, ac)
        snn = dot3(nr, nr)
        rsnn = 1.0 / torch.clamp_min(snn, eps)
        rsab = 1.0 / torch.clamp_min(dot3(ab, ab), eps)
        rsac = 1.0 / torch.clamp_min(dot3(ac, ac), eps)
        rsbc = 1.0 / torch.clamp_min(dot3(bc, bc), eps)
        cn = dot3(nr, a)[:, None, :]
        ab_a, ab_b, ab_c = (dot3(ab, v)[:, None, :] for v in (a, b, c))
        ac_a, ac_b, ac_c = (dot3(ac, v)[:, None, :] for v in (a, b, c))
        bc_b = dot3(bc, b)[:, None, :]
        saa, sbb, scc = (dot3(v, v)[:, None, :] for v in (a, b, c))
        g1, g2, g3, g4 = pdot(ab), pdot(ac), pdot(nr), pdot(a)
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
        plane = g3 - cn
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


def signed_distance(grid, vertices, elements, rows, *, device):
    """phi0 on ``grid`` (float32) from ``vertices`` ((n, 3): numpy, or a
    float32 tensor, whose gradient then flows through the exact distance)
    and the scan's ``rows`` (:class:`.geometry.Rows`)."""
    dt = torch.float32
    if isinstance(vertices, torch.Tensor):
        v = vertices
    else:
        v = torch.as_tensor(np.asarray(vertices), dtype=dt, device=device)
    tri = v[torch.as_tensor(np.asarray(elements), dtype=torch.long,
                            device=device)]
    far = torch.full((1, 3, 3), 1e30, dtype=dt, device=device)
    tri_s = torch.cat([tri, far], dim=0)
    sentinel = tri_s.shape[0] - 1
    ang = vertex_angles(tri_s.detach())
    block, (nbx, nby, nbz) = rows.block, rows.nblocks
    P = block ** 3
    bidx = rows.bidx
    borig = torch.as_tensor(np.stack(
        [bidx // (nby * nbz), (bidx // nbz) % nby, bidx % nbz], axis=-1)
        * block, device=device)
    r = torch.arange(block, device=device)
    li, lj, lk = torch.meshgrid(r, r, r, indexing="ij")
    offs = torch.stack([li, lj, lk], dim=-1).reshape(-1, 3)
    origin = torch.tensor(grid.origin, dtype=dt, device=device)
    dxv = float(np.float32(grid.dx))
    pts = origin + dxv * (borig[:, None, :] + offs[None]).to(dt)
    shift = (origin.double() + dxv * (borig.double()
                                      + (block - 1) / 2.0)).to(dt)
    R = pts.shape[0]
    best = torch.zeros((R, P), dtype=torch.long, device=device)
    acc = torch.zeros((R, P), dtype=dt, device=device)
    tri_d = tri_s.detach()
    with torch.no_grad():
        group = max(1, min(max(R, 1), PAIRS_PER_STEP // (P * TILE)))
        for r0 in range(0, R, group):
            sl = slice(r0, r0 + group)
            width = max(1, int(rows.counts[sl].max()))
            idx = torch.as_tensor(rows.table(sl, width, sentinel),
                                  dtype=torch.long, device=device)
            best[sl], acc[sl] = scan(pts[sl], shift[sl], tri_d[idx],
                                     ang[idx])
    flat = torch.as_tensor(rows.flat, dtype=torch.long, device=device)
    off = torch.as_tensor(rows.offsets, device=device)
    tid = flat[off[:, None] + best] if flat.numel() else best
    sgn = torch.where(acc < 0, -1.0, 1.0).to(dt)
    step = max(1, EXACT_POINTS // P)
    parts = []
    for r0 in range(0, R, step):
        sl = slice(r0, r0 + step)
        tb = tri_s[tid[sl]]
        cp = closest_point(pts[sl], tb[:, :, 0], tb[:, :, 1], tb[:, :, 2])
        u = pts[sl] - cp
        parts.append(sgn[sl] * torch.sqrt(torch.clamp_min(_sum3(u, u),
                                                          1e-30)))
    results = torch.zeros((nbx * nby * nbz, P), dtype=dt, device=device)
    if parts:
        results = results.index_copy(0, torch.as_tensor(bidx, device=device),
                                     torch.cat(parts))
    res = results.reshape(nbx, nby, nbz, block, block, block)
    res = res.permute(0, 3, 1, 4, 2, 5).reshape(
        nbx * block, nby * block, nbz * block)
    s = grid.shape
    return res[:s[0], :s[1], :s[2]].contiguous()
