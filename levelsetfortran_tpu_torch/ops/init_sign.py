"""Signed-distance initialization from a triangle surface mesh (port of
``levelsetfortran_tpu/ops/init_sign.py``: the exact-distance init, and the
reference-mode init :func:`initialize_sign_field` at the end).

phi0 = exact point-triangle distance (Ericson's region-based closest point)
signed by the angle-weighted pseudonormal of every triangle tied for the
minimum (Baerentzen & Aanaes).  Grid points go in 16^3 blocks; each block
scans its candidate triangles in tiles with a running (min, accumulator)
carry.  With culling (default) each block scans only the triangles whose
distance lower bound can beat the block's upper bound
(:func:`build_init_culling`, host numpy, as in the JAX package; on a CUDA
device kernel K10 builds the same lists on the card, ``ops/cull_cuda.py``).

The scan of every block is one launch of kernel K7 for float32
(``ops/init_cuda.py``, the JAX package's jitted scan), its plain version
for bfloat16 and float64; the exact re-evaluation at each point's
triangle is PyTorch ops over chunks of :data:`_EXACT_POINTS` points.  The
quadratic-form dot products are computed elementwise in full float32, so a
process-wide TF32 setting (``torch.backends.cuda.matmul.allow_tf32``)
cannot reach them — TF32 breaks the region classification the way the
TPU's default bf16 passes did.

Vertex gradients (``vertices`` a tensor that requires grad): the selection
scan runs under ``torch.no_grad()`` on detached triangles, and the gradient
flows only through the exact re-evaluation at each point's argmin triangle
— the JAX package's ``stop_gradient`` on the scan (``init_sign.py:335``,
``:354-355``).  Recording the scan would keep every (G, P, T) tile alive.
The sign is not differentiable.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time

import numpy as np
import torch

from ..grid.grid import Grid3D
from ..utils.profiling import count, recording, span
from . import cull_cuda, init_cuda
from .init_cuda import dense_rows, pack_rows, row_index, triangle_ids
from .weno_cuda import kernel_supported, scalar_type

#: Points per chunk of the exact re-evaluation: few and large torch ops
#: (run D records its autograd graph through them), some 40 temporaries of
#: (points, 3) each.  Each chunk is ~100 launches queued on the card behind
#: the scan; past the ~1000 the card's launch queue holds, the host's
#: next launch blocks until the scan ends (a quarter of a 512^3 grid:
#: ~5 chunks of 2^23, ~10 of 2^22), and the sharded init's next block, on
#: another card, with it.
_EXACT_POINTS = 2 ** 23

#: When a dict, the exact init adds its stages' seconds on the host clock
#: to it, the device synchronised at each boundary: "culling" (the build
#: of the candidate lists: K10 on a CUDA device, else the host's),
#: "select" (K7 or its plain version) and "exact" (the re-evaluation at
#: each point's triangle and the field's assembly).  None (the default):
#: no clock and no synchronisation.  The stages' spans
#: (``lsf.init.<stage>``, :func:`_stage`) time the same blocks without
#: synchronising; this survives for the benchmark's ``init.culling_s``
#: alone.
stage_times = None


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


def _exact_d2(points, tb):
    """Squared distance of each point (G, P, 3) to its triangle tb
    (G, P, 3, 3), in the direct (difference) form."""
    cpb = point_triangle_closest(points, tb[:, :, 0], tb[:, :, 1],
                                 tb[:, :, 2])
    ub = points - cpb
    return _dot(ub, ub)


def nearest_triangle(points, tri, tile: int = 128):
    """(distance^2, index) of the closest triangle for each point
    (``init_sign.py:148`` of the JAX package): ``points`` (P, 3), ``tri``
    (E, 3, 3), scanned in tiles of ``tile`` triangles with a running (min,
    argmin), so memory is O(P * tile); the first index wins a tie."""
    P = points.shape[0]
    best_d = torch.full((P,), math.inf, dtype=points.dtype,
                        device=points.device)
    best_i = torch.zeros((P,), dtype=torch.long, device=points.device)
    p = points[:, None, :]
    for base in range(0, tri.shape[0], tile):
        tb = tri[base:base + tile]
        cp = point_triangle_closest(p, tb[None, :, 0], tb[None, :, 1],
                                    tb[None, :, 2])            # (P, T, 3)
        tile_d, tile_best = torch.min(_dot(cp - p, cp - p), dim=1)
        better = tile_d < best_d
        best_d = torch.where(better, tile_d, best_d)
        best_i = torch.where(better, base + tile_best, best_i)
    return best_d, best_i


def nearest_sign_scan(points, tri, feat=None, tile: int = 128,
                      rel_tie: float = 1e-3):
    """Fused (distance^2, pseudonormal accumulator) in one tiled triangle
    scan (``init_sign.py:207`` of the JAX package): the selection scan of
    the init (:func:`_select_scan`, untracked by autograd), then the exact
    squared distance to each point's argmin triangle, through which alone
    gradients flow.  ``feat``: :func:`_triangle_features` of ``tri``."""
    if feat is None:
        feat = _triangle_features(tri.detach())
    with torch.no_grad():
        best_i, acc = init_cuda._select_scan(
            points.detach()[None], tri.detach()[None], feat[1][None], tile,
            rel_tie)
    d2 = _exact_d2(points[None], tri[best_i[0]][None])[0]
    return d2, acc[0]


def pseudonormal_sign(points, tri, best_d2, tile: int = 128,
                      rel_tie: float = 1e-3):
    """Inside/outside by the angle-weighted pseudonormal (Baerentzen &
    Aanaes 2005; ``init_sign.py:383`` of the JAX package): for each point,
    the sum over every triangle within ``rel_tie`` of ``best_d2`` of
    ``w (p - cp) . n``, ``w`` the incident angle at the closest feature (a
    vertex's angle, else pi).  Its sign is the point's side."""
    thresh = best_d2 * (1.0 + rel_tie) + 1e-12
    p = points[:, None, :]
    acc = torch.zeros_like(points[:, 0])

    def angle_at(u, v):
        cr = torch.linalg.cross(u, v)
        return torch.atan2(torch.sqrt(torch.clamp_min(_dot(cr, cr), 1e-30)),
                           _dot(u, v))

    for base in range(0, tri.shape[0], tile):
        tb = tri[base:base + tile]
        a, b, c = tb[None, :, 0], tb[None, :, 1], tb[None, :, 2]
        cp = point_triangle_closest(p, a, b, c)                 # (P, T, 3)
        u = p - cp
        tie = _dot(u, u) <= thresh[:, None]
        n = torch.linalg.cross(b - a, c - a)
        n = n / torch.sqrt(torch.clamp_min(_dot(n, n), 1e-30))[..., None]
        w = torch.full(tie.shape, math.pi, dtype=points.dtype,
                       device=points.device)
        for v, e1, e2 in ((a, b, c), (b, a, c), (c, a, b)):
            at = _dot(cp - v, cp - v) < 1e-12
            w = torch.where(at, angle_at(e1 - v, e2 - v), w)
        acc = acc + torch.where(tie, w * _dot(u, n),
                                torch.zeros_like(w)).sum(dim=1)
    return acc


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

    @property
    def cand_idx(self):
        """The (B, K) table of a single-bucket culling in block raster order
        (``build_init_culling(..., bucketed=False)``)."""
        if len(self.cands) != 1:
            raise ValueError("cand_idx needs a single-bucket culling "
                             "(build_init_culling(..., bucketed=False))")
        return self.cands[0]

    @property
    def max_k(self) -> int:
        return max(int(c.shape[1]) for c in self.cands)


def build_init_culling(grid: Grid3D, vertices, elements, *, block: int = 16,
                       tile: int = 128, margin: float = 0.0,
                       bucketed: bool = True) -> InitCulling:
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

    ``margin`` (distance units) widens every block's upper bound, so a
    culling built once stays exact while the vertices move by up to that
    much (a shape fitter's gradient steps reusing one culling).
    ``bucketed=False`` pads every block to one K (a multiple of ``tile``),
    one table in block raster order (:attr:`InitCulling.cand_idx`).
    """
    f = cull_cuda.cull_frame(grid, vertices, elements, block=block,
                             margin=margin)
    tri, tc32, t_sq, r32, slack = f.tri, f.tc32, f.t_sq, f.r32, f.slack
    B, E = f.centers.shape[0], tri.shape[0]
    hit_r_parts, hit_t_parts, hit_p_parts = [], [], []
    counts = np.zeros(B, np.int64)

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
        d_ex = np.sqrt(cull_cuda._np_point_tri_d2(cen_abs, tri[jg]))
        ub = (d_ex + Rb + margin).astype(np.float32)
        d -= rs[None, :]
        thresh = ub * np.float32(1.0 + 1e-3) + np.float32(Rb) + slack
        return d <= thresh[:, None]

    with span("lsf.init.culling.parents"):
        Bc = len(f.pcen)
        keep_c = keep_rows(f.pcen, f.pc_sq, f.pcen_abs, None, f.R_p)
        order = np.argsort(f.parent_of, kind="stable")
        bounds = np.searchsorted(f.parent_of[order], np.arange(Bc + 1))
    with span("lsf.init.culling.blocks"):
        for pc in range(Bc):
            rows = order[bounds[pc]:bounds[pc + 1]]
            if rows.size == 0:
                continue
            cols = np.nonzero(keep_c[pc])[0]
            keep = keep_rows(f.cen32[rows], f.c_sq[rows], f.centers[rows],
                             cols, f.R_b)
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
    with span("lsf.init.culling.buckets"):
        kmax = int(counts.max()) if B else 0
        if not bucketed:
            K = max(tile, -(-kmax // tile) * tile)
            cand = np.full((B, K), E, np.int32)
            cand[hit_r, pos] = hit_t
            return InitCulling((cand,), (np.arange(B, dtype=np.int32),),
                               f.block, f.nblocks)
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
        return InitCulling(tuple(cands), tuple(bidxs), f.block, f.nblocks)


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


@contextlib.contextmanager
def _stage(name, device):
    """The span ``lsf.init.<name>`` around the ``with`` block; when
    :data:`stage_times` is a dict, also adds the block's seconds to it,
    the device synchronised before and after (that clock survives only
    for the benchmark's ``init.culling_s``)."""
    with span("lsf.init." + name):
        if stage_times is None:
            yield
            return
        sync = (torch.cuda.synchronize if device.type == "cuda"
                else lambda _: None)
        sync(device)
        t0 = time.perf_counter()
        yield
        sync(device)
        stage_times[name] = (stage_times.get(name, 0.0)
                             + time.perf_counter() - t0)


def _init_rows(grid, tri, rows, block, nblocks, *, dtype, tile,
               index_offset=(0, 0, 0)):
    """The exact init over the scan rows ``rows`` (:class:`~.init_cuda.
    Rows`, one ``block``^3 point block each, of the ``nblocks`` raster).

    Every row's points are ``origin + dx * index`` of ``grid`` (for one block
    of a larger grid: :class:`_BlockView`, the larger grid's origin and the
    global index) and its shift their centre.  The selection scan (no
    gradient) is K7 for float32, through its wrapper, and the plain version
    for other dtypes; the exact squared distance to each point's triangle,
    through which alone gradients flow, is re-evaluated in chunks of
    :data:`_EXACT_POINTS` points.

    Every host array the init sends to the device goes before the scan is
    launched, and nothing after the launch reads back: a copy from
    pageable memory waits for the card's stream, so the host would wait
    for the scan, and the sharded init's next block, on another card,
    with it."""
    device = tri.device
    far = torch.full((1, 3, 3), 1e30, dtype=tri.dtype, device=device)
    tri_s = torch.cat([tri, far], dim=0)       # sentinel at index E
    _, ang = _triangle_features(tri_s.detach())
    nbx, nby, nbz = nblocks
    P = block ** 3
    bidx = rows.bidx
    borig = torch.as_tensor(
        np.stack([bidx // (nby * nbz), (bidx // nbz) % nby, bidx % nbz],
                 axis=-1) * block + np.asarray(index_offset, np.int64),
        device=device)
    origin = torch.tensor(grid.origin, dtype=dtype, device=device)
    dxv = float(scalar_type(dtype)(grid.dx))
    pts = origin + dxv * (
        borig[:, None, :] + _block_offsets(block, device)[None]).to(dtype)
    # each row's centre from the points' formula in float64, rounded once:
    # the same bits whatever the rows around it (a mean over the rows is
    # not: on the card its order of summation follows the number of rows),
    # so a block of the sharded init scans exactly as in the whole grid
    shift = (origin.double() + dxv * (borig.double()
                                      + (block - 1) / 2.0)).to(dtype)
    index = row_index(rows, device)
    dest = torch.as_tensor(bidx, device=device)
    count("init.pairs", rows.pairs_per_point * P)
    count("init.points", math.prod(grid.shape))
    with _stage("select", device), torch.no_grad():
        args = (pts, shift, tri_s.detach().contiguous(), ang.contiguous(),
                rows)
        if kernel_supported(grid.shape, dtype):
            best, acc = init_cuda.select_rows(*args, tile=tile, index=index)
        else:
            best, acc = init_cuda.select_rows_plain(*args, tile=tile)
    with _stage("exact", device):
        tid = triangle_ids(index, best)
        sgn = torch.where(acc < 0, -1.0, 1.0).to(dtype)
        step = max(1, _EXACT_POINTS // P)
        parts = []
        for r0 in range(0, pts.shape[0], step):
            sl = slice(r0, r0 + step)
            d2 = _exact_d2(pts[sl], tri_s[tid[sl]])
            parts.append(sgn[sl] * torch.sqrt(torch.clamp_min(d2, 1e-30)))
        results = torch.zeros((nbx * nby * nbz, P), dtype=dtype,
                              device=device)
        if parts:
            results = results.index_copy(0, dest, torch.cat(parts))
        return _blocks_to_grid(results, nblocks, block, grid.shape)


@dataclasses.dataclass(frozen=True)
class _BlockView:
    """One block of a larger grid as the scan sees it: the block's
    ``shape``, but the larger grid's ``origin`` and an index ``offset``
    folded into ``borig``, so that a block's points are computed from the
    same ``origin + dx * global_index`` as the whole grid's and round
    alike."""
    shape: tuple
    origin: tuple
    dx: float


def signed_distance_init(grid: Grid3D, vertices, elements, *,
                         dtype=torch.float32, device=None, tile: int = 512,
                         culling="auto", cull_block: int = 16,
                         block_of=None):
    """Exact-distance signed initialization on the full grid.

    ``culling``: ``"auto"`` builds per-block candidate lists from a
    detached host copy of the vertices, on the init's device: on a CUDA
    device kernel K10 (:func:`~.cull_cuda.cull_rows`) builds the scan's
    rows on the card, elsewhere the host (:func:`build_init_culling`); an
    :class:`InitCulling` is used as is (built on the host); ``None`` scans
    all pairs.
    ``vertices`` (n, 3) is a numpy array or a tensor — one that requires
    grad makes the field differentiable with respect to it — and
    ``elements`` (m, 3) an integer array or tensor.  ``device`` defaults
    to the vertices' (the CPU for numpy).

    ``block_of`` (larger grid, (i, j, k)): ``grid`` is the block of the
    larger grid that starts at that global index; the points are then
    formed from the larger grid's origin and the global index (see
    :func:`signed_distance_init_sharded`)."""
    with span("lsf.init"):
        elems = np.asarray(elements.cpu()
                           if isinstance(elements, torch.Tensor)
                           else elements)
        if isinstance(vertices, torch.Tensor):
            v = vertices.to(dtype=dtype, device=device or vertices.device)
            host_v = vertices.detach().cpu().double().numpy()
        else:
            host_v = np.asarray(vertices)
            v = torch.as_tensor(host_v, dtype=dtype, device=device or "cpu")
        rows = None
        if isinstance(culling, str) and culling == "auto":
            with _stage("culling", v.device):
                if v.device.type == "cuda":
                    frame = cull_cuda.cull_frame(grid, host_v, elems,
                                                 block=cull_block)
                    rows = cull_cuda.cull_rows(frame, v.device)
                    block, nblocks = frame.block, frame.nblocks
                else:
                    culling = build_init_culling(grid, host_v, elems,
                                                 block=cull_block, tile=tile)
        tri = v[torch.as_tensor(elems, dtype=torch.long, device=v.device)]
        off = (0, 0, 0)
        if block_of is not None:
            whole, off = block_of
            grid = _BlockView(grid.shape, whole.origin, whole.dx)
        E = tri.shape[0]
        with span("lsf.init.pack_rows"):
            if culling is None:
                block = 16  # the JAX package's dense block (init_sign.py:788)
                nblocks = tuple(-(-s // block) for s in grid.shape)
                rows = dense_rows(int(np.prod(nblocks)), E)
            elif rows is None:
                block, nblocks = culling.block, culling.nblocks
                rows = pack_rows(culling.cands, culling.bidxs, E)
        return _init_rows(grid, tri, rows, block, nblocks, dtype=dtype,
                          tile=tile, index_offset=off)


def signed_distance_init_sharded(grid: Grid3D, vertices, elements, mesh, *,
                                 dtype=torch.float32, tile: int = 512,
                                 culling="auto", cull_block: int = 16):
    """:func:`signed_distance_init` of a grid cut into the blocks of the
    shard mesh ``mesh`` (``init_sign.py:952`` of the JAX package): each
    shard runs the same init on its own block of grid points, on its own
    device, with the triangles replicated and the candidate culling built
    per block; the full grid is never on one device.  Returns the list of
    blocks; under a process group this rank's blocks only (None for the
    others').  ``culling``: ``"auto"`` or None; an :class:`InitCulling`
    raises.  A vertex tensor reaches the blocks through
    :func:`~..parallel.mesh.replicate`, so one that requires grad gets the
    cotangents of every shard added in shard order, across processes too.

    A block's points are bitwise the whole grid's (the global origin plus
    dx times the global index); its culling blocks are anchored on the
    block, not on the grid, so a point's candidates arrive in another
    order than in the whole-grid init and a tie between triangles may fall
    the other way (last-bit differences; the sign only where a point lies
    on the surface, ROADMAP H8).  The JAX package's rebalancing of uneven
    candidate counts (``_overflow_split``) is not ported.

    The blocks are enqueued one after another from this thread, and the
    host waits on no card once a block's scan is launched
    (:func:`_init_rows`), so blocks on different cards run at once; blocks
    on one card keep its stream's order.  Traced as ``lsf.sharded.init``,
    each block's ``signed_distance_init`` as ``lsf.sharded.init.block``;
    counters ``sharded.init_blocks`` and ``sharded.init_overlapped`` (the
    blocks enqueued while an earlier block's work on another card was
    still running: a CUDA event recorded after each block and queried
    without waiting, while a session records only)."""
    with span("lsf.sharded.init"):
        return _init_blocks(grid, vertices, elements, mesh, dtype, tile,
                            culling, cull_block)


def _init_blocks(grid, vertices, elements, mesh, dtype, tile, culling,
                 cull_block):
    from ..parallel.halo import local_offsets
    from ..parallel.mesh import replicate
    if not (culling is None or (isinstance(culling, str)
                                and culling == "auto")):
        raise ValueError(f"signed_distance_init_sharded: culling must be "
                         f"'auto' or None (each block builds its own "
                         f"candidate lists), got {culling!r}")
    b = mesh.block_shape(grid.shape)
    verts = (replicate(mesh, vertices) if isinstance(vertices, torch.Tensor)
             else [vertices] * mesh.n_shards)
    blocks, enqueued = [], []        # enqueued: (card, event) a block
    for off, dev, v in zip(local_offsets(mesh, b), mesh.devices, verts):
        if dev is None:
            blocks.append(None)
            continue
        sub = Grid3D(shape=b, origin=tuple(
            o + i * grid.dx for o, i in zip(grid.origin, off)), dx=grid.dx)
        with span("lsf.sharded.init.block"):
            blocks.append(signed_distance_init(
                sub, v, elements, dtype=dtype, device=dev, tile=tile,
                culling=culling, cull_block=cull_block,
                block_of=(grid, off)))
        if recording():
            count("sharded.init_blocks")
            count("sharded.init_overlapped", int(any(
                d != dev and not e.query() for d, e in enqueued)))
            if dev.type == "cuda":
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(dev))
                enqueued.append((dev, done))
    return blocks


# ------------------------- reference-mode init -------------------------

#: Bound on the (points, centroids) pairs of one nearest-centroid step:
#: 2^25 pairs, a few 128 MB float32 temporaries (the JAX package scans
#: every point at once, which at 222^3 would be ~19 GB per tile).
_CENTROID_PAIRS = 2 ** 25


def nearest_centroid(points: torch.Tensor, centroids: torch.Tensor,
                     tile: int = 512) -> torch.Tensor:
    """Index of the nearest centroid per point (``init_sign.py:726-764`` of
    the JAX package; reference ``set3d.f90:222-236``).

    The distance term is ``|c|^2 - 2 p.c`` per (point, centroid) pair,
    the dot product formed elementwise in the points' dtype, so no TF32
    matmul setting can reach it (the JAX package pins its matmul to
    HIGHEST for the same reason).  Centroids go in tiles of ``tile``; ties
    resolve to the lowest index: the first minimum within a tile, a strict
    ``<`` across tiles.  Points go in chunks (each point is independent,
    so chunking does not change the result)."""
    n_pts = points.shape[0]
    cn_all = torch.sum(centroids * centroids, dim=-1)
    best = torch.empty(n_pts, dtype=torch.long, device=points.device)
    step = max(1, _CENTROID_PAIRS // tile)
    for p0 in range(0, n_pts, step):
        px, py, pz = (points[p0:p0 + step, a, None] for a in range(3))
        best_d = torch.full((px.shape[0],), math.inf, dtype=points.dtype,
                            device=points.device)
        best_i = torch.zeros(px.shape[0], dtype=torch.long,
                             device=points.device)
        for base in range(0, centroids.shape[0], tile):
            c = centroids[base:base + tile]
            dot = px * c[:, 0]
            dot += py * c[:, 1]
            dot += pz * c[:, 2]
            d = cn_all[base:base + tile] - 2.0 * dot
            tile_best = torch.argmin(d, dim=1)
            tile_d = torch.gather(d, 1, tile_best[:, None])[:, 0]
            better = tile_d < best_d
            best_d = torch.where(better, tile_d, best_d)
            best_i = torch.where(better, base + tile_best, best_i)
        best[p0:p0 + step] = best_i
    return best


def orientation_sign(points: torch.Tensor, tri_verts: torch.Tensor
                     ) -> torch.Tensor:
    """Negated scalar triple product of the vectors point -> triangle
    vertices (``set3d.f90:239-258``): positive outside a CCW-outward
    surface."""
    a = tri_verts[..., 0, :] - points
    b = tri_verts[..., 1, :] - points
    c = tri_verts[..., 2, :] - points
    return -torch.sum(torch.linalg.cross(a, b, dim=-1) * c, dim=-1)


def subbox_ranges(grid: Grid3D, lo, hi, margin: int = 3):
    """Index sub-box per axis, clamped to the grid (set3d.f90:180-186)."""
    ranges = []
    for a in range(3):
        i0 = int(math.floor((lo[a] - grid.origin[a]) / grid.dx)) - margin
        i1 = int(math.floor((hi[a] - grid.origin[a]) / grid.dx)) + margin
        ranges.append((max(i0, 0), min(i1, grid.shape[a] - 1)))
    return ranges


def initialize_sign_field(grid: Grid3D, vertices, elements, *,
                          dtype=torch.float32, device=None, tile: int = 512,
                          margin: int = 3) -> torch.Tensor:
    """Reference-parity smeared +-1 inside/outside field, +1 far field
    (``init_sign.py:1091-1125`` of the JAX package; ``set3d.f90:196-268``).

    Nearest *centroid* search over the grid points of the bbox +- margin
    sub-box, the triple-product sign of that triangle, smeared with gM = 1
    (:func:`~.sign.smeared_sign`).  ``vertices`` is a numpy array or a
    tensor, ``device`` defaults to its (the CPU for numpy).  No kernel:
    PyTorch tensor ops on ``device``."""
    from .sign import smeared_sign
    if isinstance(vertices, torch.Tensor):
        v = vertices.detach().to(dtype=dtype, device=device or
                                 vertices.device)
    else:
        v = torch.as_tensor(np.asarray(vertices), dtype=dtype,
                            device=device or "cpu")
    elems = torch.as_tensor(np.asarray(
        elements.cpu() if isinstance(elements, torch.Tensor) else elements),
        dtype=torch.long, device=v.device)
    tri = v[elems]
    centroids = tri.mean(dim=1)

    # the bbox in the field's dtype and its arithmetic, as the JAX package
    # forms it from its dtype's host array (0-d tensors: numpy has no
    # bfloat16)
    host_v = v.detach().cpu()
    (i0, i1), (j0, j1), (k0, k1) = subbox_ranges(
        grid, host_v.amin(0), host_v.amax(0), margin)
    ni, nj, nk = i1 - i0 + 1, j1 - j0 + 1, k1 - k0 + 1
    rounded = scalar_type(dtype)
    dxv = float(rounded(grid.dx))
    xs, ys, zs = (float(rounded(grid.origin[a])) + dxv * (o + torch.arange(
        n, dtype=dtype, device=v.device))
        for a, o, n in ((0, i0, ni), (1, j0, nj), (2, k0, nk)))
    gx, gy, gz = torch.meshgrid(xs, ys, zs, indexing="ij")
    points = torch.stack([gx, gy, gz], dim=-1).reshape(-1, 3)
    nearest = nearest_centroid(points, centroids, tile=tile)
    ps = orientation_sign(points, tri[nearest])
    sgn = smeared_sign(ps, torch.tensor(grid.dx, dtype=dtype,
                                        device=v.device),
                       torch.tensor(1.0, dtype=dtype, device=v.device))
    phi = torch.ones(grid.shape, dtype=dtype, device=v.device)
    phi[i0:i1 + 1, j0:j1 + 1, k0:k1 + 1] = sgn.reshape(ni, nj, nk)
    return phi
