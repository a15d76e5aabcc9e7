"""Kernel K10 — the exact-distance init's candidate culling on the card —
with its plain PyTorch version.

K10 (``csrc/init_cull.cu``) replaces no Pallas kernel.  The JAX package
builds the culling on the host in numpy
(``levelsetfortran_tpu/ops/init_sign.py:495-657``), and so does the port
on the CPU (:func:`~.init_sign.build_init_culling`).  On the CUDA route of
``signed_distance_init(culling="auto")`` K10 takes over from that build:
it makes the selection scan's rows (:class:`~.init_cuda.Rows`) on the
card, so that the card no longer waits through the host's (block x
triangle) tests.

It computes the host build's definition.  The O(blocks + triangles)
constants come from the host, bitwise the host build's
(:func:`cull_frame`, which that build uses too).  The O(blocks x
triangles) work runs on the card in three passes: each 4^3-block parent's
threshold; each block's threshold (over its parent's survivors) and
count; the fill, each block's survivors in ascending triangle order.  A
row's threshold: ``j``, the argmin of ``d + r`` (the float32
centre-to-centroid distance plus the triangle's radius; the lowest index
on a tie, as ``np.argmin``); ``ub``, the float64 exact distance from the
row's centre to triangle ``j`` plus the row's radius, rounded to float32;
``ub * (1 + 1e-3) + R + slack``.  A triangle survives where ``d - r`` is
at most the threshold, for a block also its parent's.

The tests follow numpy's float32 steps in its order (the dot, ``* -2``,
``+ |c|^2``, ``+ |t|^2``, ``sqrt(max(., 0))``, ``- r``, ``<=``), with the
dot spelled out in a fixed order (as ``interp.dot3``) and the kernel
built with ``--fmad=false``: K10's rows are bitwise :func:`cull_rows_plain`'s.
The host build's BLAS may round the three-term dot another way, so a row
of the two builds can differ only by a pair within a few ulps of the
quadratic form from its threshold (:func:`margin_ulps`; the form cancels,
so that can be tens of ulps of the threshold).  Such a triangle lies
more than ``1.001 d_min + R_b`` from
every point of its block: it is no point's nearest triangle, no tie and no
term of a pseudonormal sum, and the scan takes candidates in ascending
order in both builds, so the init's field is bitwise the host-culled one.

What bounds K10 is its launches and its one host read: the row counts,
read between the count and the fill to size the output, from which the
host forms the offsets and the longest-first order as ``pack_rows`` does.
The tests are ~10 float operations a (row, triangle) pair, a few 10^7 on
a 256^3 grid.  Nothing of size (blocks x triangles) is kept; the build's
memory is O(blocks + triangles + survivors).

:func:`cull_rows` runs the plain version for the CPU; off the CPU it
launches K10 or raises.
"""

from __future__ import annotations

import dataclasses
import types

import numpy as np
import torch

from .. import cuda_build
from ..utils.profiling import count
from .init_cuda import Rows, longest_first, starts
from .interp import dot3
from .weno_cuda import on_device

#: A parent is PARENT^3 culling blocks.
PARENT = 4
#: The upper bound's relative widening, ``1 + 1e-3`` in float32.
_WIDEN = float(np.float32(1.0 + 1e-3))


@dataclasses.dataclass(frozen=True)
class CullFrame:
    """The O(blocks + triangles) constants of one culling build, on the
    host (:func:`cull_frame`): the ``B`` blocks in raster order of
    ``nblocks``, their ``Bc`` parents in raster order of ``nparents``, the
    ``E`` triangles.  The float32 distances are taken about ``shift``, the
    blocks' mean centre."""
    block: int
    nblocks: tuple
    nparents: tuple
    tri: np.ndarray        # (E, 3, 3) float64
    centers: np.ndarray    # (B, 3) float64, the blocks' centres
    cen32: np.ndarray      # (B, 3) float32, centres - shift
    c_sq: np.ndarray       # (B,) float32, |cen32|^2
    tc32: np.ndarray       # (3, E) float32, centroids - shift
    t_sq: np.ndarray       # (E,) float32, |tc32|^2
    r32: np.ndarray        # (E,) float32, centroid-to-vertex radii
    parent_of: np.ndarray  # (B,) int64
    pcen: np.ndarray       # (Bc, 3) float32, the mean of its blocks' cen32
    pc_sq: np.ndarray      # (Bc,) float32, |pcen|^2
    pcen_abs: np.ndarray   # (Bc, 3) float64, pcen + shift
    R_b: float             # a block's radius
    R_p: float             # a parent's radius plus a block's
    margin: float
    slack: np.float32


def cull_frame(grid, vertices, elements, *, block: int = 16,
               margin: float = 0.0) -> CullFrame:
    """The culling's constants for ``block``^3 point blocks of ``grid``, in
    float64 ``vertices`` (n, 3) and ``elements`` (m, 3) (host numpy)."""
    verts = np.asarray(vertices, np.float64)
    tri = verts[np.asarray(elements)]
    cent = tri.mean(axis=1)
    r_t = np.sqrt(((tri - cent[:, None, :]) ** 2).sum(-1)).max(axis=1)

    bs = int(block)
    nb = tuple(-(-s // bs) for s in grid.shape)
    ctr = [np.asarray(grid.origin[a]) + grid.dx *
           (np.arange(nb[a]) * bs + (bs - 1) / 2.0) for a in range(3)]
    cx, cy, cz = np.meshgrid(*ctr, indexing="ij")
    centers = np.stack([cx, cy, cz], axis=-1).reshape(-1, 3)
    R_b = grid.dx * np.sqrt(3.0) * (bs - 1) / 2.0
    shift = centers.mean(axis=0)
    cen32 = np.ascontiguousarray(centers - shift, np.float32)
    tc32 = np.ascontiguousarray((cent - shift).T, np.float32)

    nbc = tuple(-(-x // PARENT) for x in nb)
    R_c = grid.dx * np.sqrt(3.0) * (PARENT * bs - 1) / 2.0
    pid = np.arange(centers.shape[0])
    pbx = (pid // (nb[1] * nb[2])) // PARENT
    pby = ((pid // nb[2]) % nb[1]) // PARENT
    pbz = (pid % nb[2]) // PARENT
    parent_of = (pbx * nbc[1] + pby) * nbc[2] + pbz
    Bc = nbc[0] * nbc[1] * nbc[2]
    psum = np.zeros((Bc, 3), np.float64)
    pcnt = np.zeros(Bc, np.int64)
    np.add.at(psum, parent_of, cen32.astype(np.float64))
    np.add.at(pcnt, parent_of, 1)
    pcen = (psum / np.maximum(pcnt, 1)[:, None]).astype(np.float32)
    return CullFrame(
        block=bs, nblocks=nb, nparents=nbc, tri=tri, centers=centers,
        cen32=cen32, c_sq=(cen32 ** 2).sum(-1), tc32=tc32,
        t_sq=(tc32 ** 2).sum(0), r32=r_t.astype(np.float32),
        parent_of=parent_of, pcen=pcen, pc_sq=(pcen ** 2).sum(-1),
        pcen_abs=pcen.astype(np.float64) + shift, R_b=R_b, R_p=R_c + R_b,
        margin=margin, slack=np.float32(1e-3 * (R_b + margin) + 1e-9))


def _on(frame: CullFrame, device):
    """The frame's arrays on ``device``, from two copies: one of the
    float32 arrays, one of the float64."""
    B, Bc, E = len(frame.centers), len(frame.pcen), len(frame.tri)
    f32 = torch.as_tensor(np.concatenate([
        frame.cen32.ravel(), frame.c_sq, frame.pcen.ravel(), frame.pc_sq,
        frame.tc32.ravel(), frame.t_sq, frame.r32]), device=device)
    f64 = torch.as_tensor(np.concatenate([
        frame.centers.ravel(), frame.pcen_abs.ravel(), frame.tri.ravel()]),
        device=device)
    cen, c_sq, pcen, pc_sq, tc, t_sq, r = f32.split(
        [3 * B, B, 3 * Bc, Bc, 3 * E, E, E])
    centers, pcen_abs, tri = f64.split([3 * B, 3 * Bc, 9 * E])
    return types.SimpleNamespace(
        cen=cen.view(B, 3), c_sq=c_sq, pcen=pcen.view(Bc, 3), pc_sq=pc_sq,
        tc=tc.view(3, E), t_sq=t_sq, r=r, centers=centers.view(B, 3),
        pcen_abs=pcen_abs.view(Bc, 3), tri=tri.view(E, 3, 3))


def _np_point_tri_d2(p, t):
    """Exact squared point-triangle distance, host numpy, one pair per row
    (the culling's exact-centre upper bound; K10's ``point_tri_d2`` step
    for step)."""
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


def _keep(t, frame, cen, c_sq, cen_abs, cols, R):
    """The rows (``cen``, ``c_sq`` on ``t``'s device, the float64 centres
    ``cen_abs`` on the host) against the triangles ``cols`` (None: all):
    (``d - r`` (rows, cols), each row's threshold), the host build's
    ``keep_rows`` with the dot in a fixed order."""
    tc, t_sq, r = t.tc, t.t_sq, t.r
    if cols is not None:
        tc, t_sq, r = tc[:, cols], t_sq[cols], r[cols]
    d = (cen[:, 0, None] * tc[0] + cen[:, 1, None] * tc[1]
         + cen[:, 2, None] * tc[2])
    d = torch.sqrt(torch.clamp_min(d * -2.0 + c_sq[:, None] + t_sq, 0.0))
    j = torch.argmin(d + r, dim=1)
    jg = (j if cols is None else cols[j]).cpu().numpy()
    d_ex = np.sqrt(_np_point_tri_d2(cen_abs, frame.tri[jg]))
    ub = torch.as_tensor((d_ex + R + frame.margin).astype(np.float32),
                         device=d.device)
    thresh = ub * _WIDEN + float(np.float32(R)) + float(frame.slack)
    return d - r, thresh


def margin_ulps(frame: CullFrame, b: int, t: int, device="cpu") -> float:
    """How far triangle ``t`` lies from a threshold that decides it for
    block ``b``, the parent's test or the block's, whichever is nearer:
    ``|d^2 - (threshold + r)^2|`` in float32 ulps of ``|c|^2 + |t|^2``,
    the scale at which the quadratic form rounds (the plain version's
    arithmetic).  A pair that K10 and the host build keep apart lies
    within a few (the host's BLAS rounds the dot another way, and the
    form cancels: one ulp of it can be tens of ulps of the threshold)."""
    on = _on(frame, device)
    p = int(frame.parent_of[b])
    dr, th = _keep(on, frame, on.pcen[p:p + 1], on.pc_sq[p:p + 1],
                   frame.pcen_abs[p:p + 1], None, frame.R_p)
    near = [(float(dr[0, t]), float(th[0]), frame.pc_sq[p])]
    cols = torch.nonzero(dr[0] <= th[0])[:, 0]
    at = torch.nonzero(cols == t)[:, 0]
    if at.numel():
        dr, th = _keep(on, frame, on.cen[b:b + 1], on.c_sq[b:b + 1],
                       frame.centers[b:b + 1], cols, frame.R_b)
        near.append((float(dr[0, int(at[0])]), float(th[0]),
                      frame.c_sq[b]))
    r = float(frame.r32[t])
    return min(abs((x + r) ** 2 - (lim + r) ** 2)
               / float(np.spacing(c_sq + frame.t_sq[t]))
               for x, lim, c_sq in near)


def cull_rows_plain(frame: CullFrame, device="cpu") -> Rows:
    """The plain version of :func:`cull_rows` on ``device`` (any): the
    host build's loop over parents in PyTorch, each parent's blocks
    against its surviving triangles; each row's exact distance on the
    host (:func:`_np_point_tri_d2`, as the host build takes it)."""
    t = _on(frame, device)
    B = len(frame.centers)
    dr, th = _keep(t, frame, t.pcen, t.pc_sq, frame.pcen_abs, None,
                   frame.R_p)
    keep_c = dr <= th[:, None]
    order = np.argsort(frame.parent_of, kind="stable")
    bounds = np.searchsorted(frame.parent_of[order],
                             np.arange(len(frame.pcen) + 1))
    hit_r = [torch.empty(0, dtype=torch.long, device=device)]
    hit_t = [torch.empty(0, dtype=torch.long, device=device)]
    for pc in range(len(frame.pcen)):
        ids = order[bounds[pc]:bounds[pc + 1]]
        if ids.size == 0:
            continue
        rows = torch.as_tensor(ids, device=device)
        cols = torch.nonzero(keep_c[pc])[:, 0]
        dr, th = _keep(t, frame, t.cen[rows], t.c_sq[rows],
                       frame.centers[ids], cols, frame.R_b)
        rr, tt = torch.nonzero(dr <= th[:, None], as_tuple=True)
        hit_r.append(rows[rr])
        hit_t.append(cols[tt])
    hit_r = torch.cat(hit_r)
    # a parent's hits are row-major, ascending in triangle within a row
    flat = torch.cat(hit_t)[torch.argsort(hit_r, stable=True)].int()
    counts = torch.bincount(hit_r, minlength=B).cpu().numpy()
    return longest_first(np.arange(B), counts, starts(counts), flat)


def cull_rows(frame: CullFrame, device) -> Rows:
    """The scan's rows of the culling ``frame`` describes, built on
    ``device``: the plain version for the CPU; off it, K10's three passes
    and one host read (the row counts) or an error.  The rows' ``flat``
    stays on the card."""
    device = torch.device(device)
    if device.type == "cpu":
        return cull_rows_plain(frame, device)
    with on_device(device):
        t = _on(frame, device)
        B, Bc, E = len(frame.centers), len(frame.pcen), len(frame.tri)
        dims = (B, Bc, E, *frame.nblocks[1:], *frame.nparents[1:])
        thresh = torch.empty(Bc + B, dtype=torch.float32, device=device)
        counts = torch.empty(B, dtype=torch.int32, device=device)
        stream = torch.cuda.current_stream(device).cuda_stream
        cuda_build.launch(
            "lsf_cull_count", t.cen.data_ptr(), t.c_sq.data_ptr(),
            t.centers.data_ptr(), t.pcen.data_ptr(), t.pc_sq.data_ptr(),
            t.pcen_abs.data_ptr(), t.tc.data_ptr(), t.t_sq.data_ptr(),
            t.r.data_ptr(), t.tri.data_ptr(), *dims, frame.R_b, frame.R_p,
            frame.margin, _WIDEN, float(np.float32(frame.R_b)),
            float(np.float32(frame.R_p)), float(frame.slack),
            thresh.data_ptr(), counts.data_ptr(), stream)
        n = counts.cpu().numpy().astype(np.int64)    # the one host read
        offsets = starts(n)
        on_card = torch.as_tensor(offsets, device=device)
        flat = torch.empty(int(n.sum()), dtype=torch.int32, device=device)
        cuda_build.launch(
            "lsf_cull_fill", t.cen.data_ptr(), t.c_sq.data_ptr(),
            t.pcen.data_ptr(), t.pc_sq.data_ptr(), t.tc.data_ptr(),
            t.t_sq.data_ptr(), t.r.data_ptr(), *dims, thresh.data_ptr(),
            on_card.data_ptr(), flat.data_ptr(), stream)
    cull_rows.launches += 1
    count("init.culls_on_device")
    return longest_first(np.arange(B), n, offsets, flat)


cull_rows.launches = 0
