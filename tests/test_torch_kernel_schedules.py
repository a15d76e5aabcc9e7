"""CPU models of the schedules of the kernels redesigned for the H100,
written in torch from the plain helpers and held bitwise against the plain
versions, so that their index arithmetic is checked before the card runs
them (the CUDA kernels themselves run only on the card).  (c), (d) and
(e), the min/max step's march, the reinit step's bricks and the min/max
adjoint's march, are at the end.

(a) K5 (``csrc/reinit_bwd.cu``) in two stages: pass 1 runs the forward
    once per cell and stops at the one per-cell input of the per-axis
    adjoints, ``cot_gs``; pass 2 rebuilds each axis's adjoint from (phi,
    the sign, the deep flag, ``cot_gs``) on tiles of owned cells with a
    +-3 halo along that axis only, and adds it into each owned cell in the
    plain order (axes x, y, z; shifts k = -3..3).
(b) K4 (``csrc/minmax_step.cu``): a (y, z) column of 16 x 32 owned cells
    widened by K walks along x in chunks of slabs, split into runs of live
    slabs; level s (the field after s steps) is computed on plane t - 2s at
    step t from the three planes of level s - 1 around it; the last step's
    changes go through the x-tree of ``block_sum`` per column, then its y-
    and z-trees per brick, and the partials into ``reduce_partials``'s
    order.  It must equal K dense plain steps with the band mask's write,
    and the sum of K3's launch (``block_sum`` over each brick, then
    ``reduce_partials``), bitwise.
"""

import numpy as np
import pytest
import torch

from levelsetfortran_tpu_torch.ops import minmax_cuda as mc
from levelsetfortran_tpu_torch.ops import weno_cuda as wc
from levelsetfortran_tpu_torch.ops.stencil import (global_interior_mask,
                                                  interior_mask)
from levelsetfortran_tpu_torch.parallel import sharded as sh
from levelsetfortran_tpu_torch.parallel.halo import halo_exchange
from levelsetfortran_tpu_torch.parallel.mesh import (gather_blocks,
                                                     make_mesh, split_blocks)

BRICK = wc.BRICK


def _sphere(shape, dx, r, off, dtype=torch.float32):
    ax = [(np.arange(n) - (n - 1) / 2.0) * dx + o for n, o in zip(shape, off)]
    g = np.meshgrid(*ax, indexing="ij")
    return torch.tensor(np.sqrt(sum(x ** 2 for x in g)) - r, dtype=dtype)


def _bits(t):
    return t.view(torch.int64 if t.dtype == torch.float64 else torch.int32)


# ------------------------------ (a) K5 ------------------------------------

def _forward_axis(phi, axis, sc, rf, p5, deep):
    diffs = wc._axis_diffs(phi, axis)
    w_m, w_p = wc._weno5_pair(*diffs, sc["eps_scale"], sc["eps_floor"], rf,
                              p5)
    return (diffs, torch.where(deep, w_m, diffs[2]),
            torch.where(deep, w_p, diffs[3]))


def k5_two_stage(phi, sgn, g, sc, p5, origin, gshape, live, box, seg):
    """K5's two-stage schedule on an array whose cell 0 lies at global
    ``origin``; ``box``: the owned box in array coordinates ((lo, hi) per
    axis); ``seg``: owned cells per tile along the walked axis.  Returns
    the owned box's (cot_phi, cot_sign) and the sums (cot_dx, cot_h)."""
    f64 = phi.dtype == torch.float64
    rf, smf = (1e-70, 1e-30) if f64 else (1e-7, 1e-20)
    shape, dev = phi.shape, phi.device
    in_grid = global_interior_mask(shape, origin, gshape, 0, dev)
    interior = global_interior_mask(shape, origin, gshape, 1, dev)
    deep = global_interior_mask(shape, origin, gshape, 4, dev)
    stepped = interior if live is None else interior & live
    owned = torch.zeros(shape, dtype=torch.bool)
    owned[tuple(slice(lo, hi) for lo, hi in box)] = True
    counted = stepped & owned
    pos = sgn > 0.0
    zero = torch.zeros_like(phi)

    # pass 1: the forward once per cell, the tail's adjoint, cot_gs
    gsum = None
    for axis in range(3):
        _, d_m, d_p = _forward_axis(phi, axis, sc, rf, p5 and axis == 1,
                                    deep)
        gsq, _, _ = wc._godunov_routing(d_m, d_p, pos, zero)
        gsum = gsq if gsum is None else gsum + gsq
    face = in_grid & ~interior
    gf = torch.where(face, g, zero)
    for axis in (2, 1, 0):
        gf = wc._clamp_transpose(gf, axis, origin, gshape)
    big_g = torch.where(interior, g, zero) + gf
    cot_dx = torch.where(face & owned, g, zero).double().sum()
    nzm = gsum > 0.0
    gm_safe = torch.sqrt(torch.where(nzm, gsum, 1.0 + zero) * sc["inv_dx2"])
    gm = torch.where(nzm, gm_safe, zero)
    d2 = sgn * sgn + sc["dx2"] * gm
    m = torch.clamp_min(d2, smf)
    sq = torch.sqrt(m)
    sg = sgn / sq
    cot_hs = big_g * (1.0 - gm)
    cot_h = torch.where(counted, cot_hs * sg, zero).double().sum()
    cot_sg = cot_hs * sc["h"]
    cot_m = cot_sg * ((-0.5 * sg) / m)
    cot_d2 = torch.where(d2 > smf, cot_m,
                         torch.where(d2 == smf, 0.5 * cot_m, zero))
    cot_sign = torch.where(stepped, cot_sg / sq + (2.0 * sgn) * cot_d2, zero)
    cot_gm = -((sc["h"] * sg) * big_g) + sc["dx2"] * cot_d2
    cot_u = torch.where(nzm, cot_gm * (0.5 / gm_safe), zero)
    cot_gs = cot_u * sc["inv_dx2"]
    cdx = ((2.0 * sc["dx"]) * (gm * cot_d2).double()
           - (2.0 * sc["dx"] * sc["inv_dx2"] * sc["inv_dx2"])
           * (cot_u * gsum).double())
    cot_dx = cot_dx + torch.where(counted, cdx, torch.zeros_like(cdx)).sum()

    # pass 2: per axis, tiles of owned cells with their sources within 3
    acc = big_g
    for axis in range(3):
        n = shape[axis]
        p5z = p5 and axis == 1
        new = acc.clone()
        lo_box, hi_box = box[axis]
        for lo in range(lo_box, hi_box, seg):
            hi = min(lo + seg, hi_box)                 # targets [lo, hi)
            s0, s1 = max(lo - 3, 0), min(hi + 3, n)    # their sources
            r0, r1 = max(s0 - 3, 0), min(s1 + 3, n)    # what those read

            def cut(t, a, b):
                return t.narrow(axis, a, b - a)

            diffs = [cut(d, s0 - r0, s1 - r0)
                     for d in wc._axis_diffs(cut(phi, r0, r1), axis)]
            dp_ = cut(deep, s0, s1)
            w_m, w_p = wc._weno5_pair(*diffs, sc["eps_scale"],
                                      sc["eps_floor"], rf, p5z)
            d_m = torch.where(dp_, w_m, diffs[2])
            d_p = torch.where(dp_, w_p, diffs[3])
            zt = torch.zeros_like(d_m)
            _, c_dm, c_dp = wc._godunov_routing(d_m, d_p, cut(pos, s0, s1),
                                                cut(cot_gs, s0, s1))
            cps, cot_ef = wc._weno5_pair_bwd(
                diffs, sc["eps_scale"], sc["eps_floor"], rf, p5z,
                torch.where(dp_, c_dm, zt), torch.where(dp_, c_dp, zt))
            cps[2] = cps[2] + torch.where(dp_, zt, c_dm)
            cps[3] = cps[3] + torch.where(dp_, zt, c_dp)
            qs = [-cps[0]] + [cps[i] - cps[i + 1] for i in range(5)] + [cps[5]]
            st = cut(stepped, s0, s1)
            own_src = torch.zeros_like(st)
            cut(own_src, lo - s0, hi - s0).fill_(True)
            ef = torch.where(cut(counted, s0, s1) & own_src,
                             cot_ef.double(), zt.double())
            cot_dx = cot_dx + sc["ef_dx"] * ef.sum()
            tile = cut(acc, lo, hi)
            for k, q in zip(range(-3, 4), qs):          # the plain order
                qz = torch.where(st, q, zt)
                add = torch.zeros_like(tile)
                # target t takes q_k(t - k); a source past the array adds 0
                t0, t1 = max(lo, s0 + k), min(hi, s1 + k)
                if t1 > t0:
                    cut(add, t0 - lo, t1 - lo).copy_(
                        qz.narrow(axis, t0 - k - s0, t1 - t0))
                tile = tile + add
            cut(new, lo, hi).copy_(tile)
        acc = new
    sl = tuple(slice(lo, hi) for lo, hi in box)
    return acc[sl], cot_sign[sl], cot_dx, cot_h


def _k5_case(shape, dtype, p5=False, banded=False, seg=7):
    rng = np.random.default_rng(11)
    dx = 0.1
    phi = _sphere(shape, dx, 0.6, (0.1, -0.05, 0.03), dtype)
    sgn = _sphere(shape, dx, 0.66, (0.1, -0.05, 0.03), dtype)
    g = torch.tensor(rng.standard_normal(shape), dtype=dtype)
    h = 0.1 * dx / 3.0
    active = None
    if banded:
        active = wc.tile_activity(phi.float(), dx, 3.1, window="band4")
        active[0, 0, :] = 0              # frozen bricks on global faces
        active[-1, :, -1] = 0
        active[:, 1, 0] = 1
        assert 0 < int(active.sum()) < active.numel()
    return phi, sgn, g, dx, h, active


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("banded", [False, True])
def test_k5_two_stage_matches_plain_bitwise(dtype, banded):
    shape = (19, 23, 26)
    phi, sgn, g, dx, h, active = _k5_case(shape, dtype, banded=banded)
    for p5 in (False, True):
        sc = wc.step_scalars(dtype, dx, h, 1e-6, None)
        live = None if active is None else wc.brick_cells(active, shape)
        got = k5_two_stage(phi, sgn, g, sc, p5, (0, 0, 0), shape, live,
                           [(0, n) for n in shape], seg=7)
        want = wc.reinit_step_vjp_plain(phi, sgn, g, dx, h,
                                        quirk_y_p5_zero=p5, active=active)
        for a, b in zip(got[:2], want[:2]):
            assert torch.equal(_bits(a), _bits(b))
        # the scalar sums add the same terms in another order (the kernel's
        # gate, rel 1e-9: the terms cancel, so the order shows above 1e-15)
        for a, b in zip(got[2:], want[2:]):
            assert abs(float(a) - float(b)) <= 1e-9 * abs(float(b))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k5_two_stage_block_geometry_bitwise(dtype):
    """One shard's padded block of a (2,2,1) cut: the model on the owned
    box equals the block plain version bitwise, and gathered, the solo
    plain version."""
    shape = (24, 22, 13)
    phi, sgn, g, dx, h, _ = _k5_case(shape, dtype)
    mesh = make_mesh((2, 2, 1), ["cpu"])
    widths = sh.sharded_widths(mesh, wc.VJP_HALO["reinit"])
    geoms = sh.reinit_geoms(mesh, shape, widths)
    pads = [halo_exchange(split_blocks(mesh, f), widths, mesh)
            for f in (phi, sgn, g)]
    sc = wc.step_scalars(dtype, dx, h, 1e-6, None)
    outs = []
    for a, b, c, ge in zip(*pads, geoms):
        box = [(s.start, s.stop) for s in wc.owned_slices(ge)]
        got = k5_two_stage(a, b, c, sc, False, ge.origin, ge.gshape, None,
                           box, seg=5)
        want = wc.reinit_step_block_vjp_plain(a, b, c, dx, h, ge)
        for x, y in zip(got[:2], want[:2]):
            assert torch.equal(_bits(x), _bits(y))
        outs.append(got)
    solo = wc.reinit_step_vjp_plain(phi, sgn, g, dx, h)
    for i in range(2):
        whole = gather_blocks(mesh, [o[i] for o in outs])
        assert torch.equal(_bits(whole), _bits(solo[i]))


# ------------------------------ (b) K4 ------------------------------------

TY, TZ = 16, 32


def _tree(v):
    """``lsf::block_sum``'s pairing over the last axis: s[t] += s[t + w]
    for w = n/2 .. 1."""
    while v.shape[-1] > 1:
        w = v.shape[-1] // 2
        v = v[..., :w] + v[..., w:]
    return v[..., 0]


def _reduce_partials(parts):
    """``reduce_partials``: 1024 threads each add every 1024th partial from
    0.0, then a tree over the threads."""
    n = parts.numel()
    acc = torch.zeros(1024, dtype=torch.float64)
    for r in range(0, n, 1024):
        row = parts[r:r + 1024]
        acc[:row.numel()] = acc[:row.numel()] + row
    return _tree(acc)


def k3_launch_partials(new, old):
    """The per-brick partials of K3's fused sum: each brick's squared
    changes through block_sum's tree (x slowest), in brick order; their sum
    is ``reduce_partials`` of them."""
    nb = wc.brick_grid(new.shape)
    d = torch.zeros(tuple(b * BRICK for b in nb), dtype=torch.float64)
    dd = (new - old).double()
    d[:new.shape[0], :new.shape[1], :new.shape[2]] = dd * dd
    d = d.reshape(nb[0], BRICK, nb[1], BRICK, nb[2], BRICK)
    d = d.permute(0, 2, 4, 1, 3, 5).reshape(-1, BRICK ** 3)
    return _tree(d)


def k4_wavefront(phi, dx, h1, ksteps, active, chunk, geom=None):
    """K4's schedule (mint): the field after ``ksteps`` steps and the last
    step's per-brick partials.  ``geom``: the block-mode record (None: the
    whole grid), its brick grid the launch's columns and slabs, a cell
    stepping where it is interior in the array and in the global grid, the
    sum counting ``geom``'s box; cells the brick grid does not cover keep
    ``phi``."""
    K = ksteps
    sc = mc.minmax_scalars(phi.dtype, dx, h1, 4.1, 0.0)
    nx, ny, nz = phi.shape
    geom = geom or wc.BlockGeom(tuple(phi.shape))
    nbx, nby, nbz = geom.bricks(phi.shape)
    c0, c1, c2 = geom.brick_origin
    o, g = geom.origin, geom.gshape
    ones = torch.ones((nbx, nby, nbz), dtype=torch.int32)
    covered = wc.brick_cells(ones, phi.shape, geom.brick_origin)
    out = torch.where(covered, torch.full_like(phi, float("nan")), phi)
    parts = torch.full((nbx * nby * nbz,), float("nan"), dtype=torch.float64)
    act = ones if active is None else active
    live_cells = wc.brick_cells(act, phi.shape, geom.brick_origin)
    box = wc.box_cells(geom, phi.shape, phi.device)

    def brick_id(bx, by, bz):
        return (bx * nby + by) * nbz + bz

    def x_ok(i):
        return 1 <= i <= nx - 2 and 1 <= o[0] + i <= g[0] - 2

    for by0 in range(0, nby, TY // BRICK):
        for bz0 in range(0, nbz, TZ // BRICK):
            y0, z0 = c1 + by0 * BRICK, c2 + bz0 * BRICK
            ylo, yhi = max(y0 - K, 0), min(y0 + TY + K, ny)  # widened column
            zlo, zhi = max(z0 - K, 0), min(z0 + TZ + K, nz)
            bys = range(by0, min(by0 + TY // BRICK, nby))
            bzs = range(bz0, min(bz0 + TZ // BRICK, nbz))
            # the owned column: cells of the launch's bricks in the array
            yc0, yc1 = max(y0, 0), min(y0 + TY, ny, c1 + nby * BRICK)
            zc0, zc1 = max(z0, 0), min(z0 + TZ, nz, c2 + nbz * BRICK)
            yc, zc = slice(yc0 - ylo, yc1 - ylo), slice(zc0 - zlo, zc1 - zlo)
            # a three-plane slab's middle plane steps where its cells are
            # interior in the array and the global grid (planes that are
            # not copy their values)
            shp = (3, yhi - ylo, zhi - zlo)
            inner = (global_interior_mask(shp, (0, ylo, zlo), (3, ny, nz), 1)
                     & global_interior_mask(shp, (0, o[1] + ylo, o[2] + zlo),
                                            (3, g[1], g[2]), 1))

            def x0_of(bx):
                return c0 + bx * BRICK

            def live(bx):
                return bool(act[bx, bys.start:bys.stop,
                                bzs.start:bzs.stop].any())

            for b0 in range(0, nbx, chunk):
                b1 = min(b0 + chunk, nbx)
                first = b0
                while first < b1:
                    if not live(first):
                        x = slice(max(x0_of(first), 0),
                                  min(x0_of(first) + BRICK, nx))
                        out[x, yc0:yc1, zc0:zc1] = phi[x, yc0:yc1, zc0:zc1]
                        for by in bys:
                            for bz in bzs:
                                parts[brick_id(first, by, bz)] = 0.0
                        first += 1
                        continue
                    last = first
                    while last + 1 < b1 and (live(last + 1) or (
                            last + 2 < b1 and live(last + 2))):
                        last += 1
                    xs, xe = max(x0_of(first), 0), min(x0_of(last + 1), nx)
                    xr, xl = max(xs - K, 0), min(xe + K, nx)
                    lev = [dict() for _ in range(K + 1)]
                    dq = {}
                    for t in range(xr, xe + 2 * K):
                        for s in range(K, 0, -1):
                            p = t - 2 * s
                            lo_s = 0 if xr == 0 else xr + s
                            hi_s = nx - 1 if xl == nx else xl - 1 - s
                            if not lo_s <= p <= hi_s:
                                continue
                            if s == K and not xs <= p < xe:
                                continue
                            src = lev[s - 1]
                            if not x_ok(p):          # no step on this plane
                                lev[s][p] = src[p]
                            else:
                                slab = torch.stack([src[p - 1], src[p],
                                                    src[p + 1]])
                                lev[s][p] = mc._dense_step(slab, sc,
                                                           inner)[1]
                            for q in [q for q in src if q < p - 1]:
                                del src[q]          # the ring's depth
                        if t < xl:
                            lev[0][t] = phi[t, ylo:yhi, zlo:zhi]
                        p = t - 2 * K
                        if xs <= p < xe:
                            new = lev[K][p][yc, zc]
                            old = lev[K - 1][p][yc, zc]
                            cells = live_cells[p, yc0:yc1, zc0:zc1]
                            out[p, yc0:yc1, zc0:zc1] = torch.where(
                                cells, new, phi[p, yc0:yc1, zc0:zc1])
                            d = torch.zeros(TY, TZ, dtype=torch.float64)
                            dd = (new - old).double()
                            dd = torch.where(box[p, yc0:yc1, zc0:zc1],
                                             dd * dd, torch.zeros_like(dd))
                            d[yc0 - y0:yc1 - y0, zc0 - z0:zc1 - z0] = dd
                            m = (p - c0) % BRICK
                            dq[m] = d
                            if m == BRICK - 1 or p == xe - 1:
                                col = torch.stack(
                                    [dq.get(i, torch.zeros(TY, TZ,
                                                           dtype=torch.float64))
                                     for i in range(BRICK)])
                                xt = _tree(col.permute(1, 2, 0))  # (TY, TZ)
                                bx = (p - c0) // BRICK
                                for by in bys:
                                    for bz in bzs:
                                        ly = (by - by0) * BRICK
                                        lz = (bz - bz0) * BRICK
                                        blk = xt[ly:ly + BRICK, lz:lz + BRICK]
                                        v = _tree(blk.reshape(-1))
                                        parts[brick_id(bx, by, bz)] = (
                                            v if act[bx, by, bz] else 0.0)
                                dq = {}
                    first = last + 1
    return out, parts


@pytest.mark.parametrize("shape,ksteps,chunk", [
    ((19, 23, 37), 1, 2), ((19, 23, 37), 2, 1), ((19, 23, 37), 3, 2),
    ((19, 23, 37), 4, 3), ((262, 42, 42), 4, 5), ((262, 42, 42), 1, 33)])
@pytest.mark.parametrize("case", ["dense", "banded", "noisy"])
def test_k4_wavefront_matches_k_plain_steps_bitwise(shape, ksteps, chunk,
                                                     case):
    """"noisy": a field in the band everywhere whose changes span eight
    decades, so that the sum's partial sums round and its order shows in
    its bits (float32 changes squared in float64 are exact, and sums of
    them over a narrow range stay exact in any order)."""
    banded = case == "banded"
    dx = 0.05 if shape[0] == 262 else 0.1
    r = 0.3 if shape[0] == 262 else 0.7
    phi = _sphere(shape, dx, r, (0.13, -0.05, 0.02))
    if shape[0] == 262:               # two blobs along the long axis
        phi = torch.minimum(phi, _sphere(shape, dx, r, (-4.5, 0.0, 0.0)))
    if case == "noisy":
        rng = np.random.default_rng(5)
        noise = (rng.standard_normal(shape) * dx
                 * 10.0 ** rng.uniform(-8.0, 0.0, shape))
        phi = (0.02 * phi + torch.tensor(noise, dtype=phi.dtype)
               ).clamp(-3.0 * dx, 3.0 * dx)
    h1 = 0.3 * dx * dx
    active = wc.tile_activity(phi, dx, 4.1, window="owned") if banded \
        else None
    if banded:
        assert 0 < int(active.sum()) < active.numel()
    got, got_parts = k4_wavefront(phi, dx, h1, ksteps, active, chunk)
    prev = new = phi
    for _ in range(ksteps):
        prev, new = new, mc.minmax_step_plain(new, dx, h1)
    want = mc.minmax_fusedk_plain(phi, dx, h1, ksteps=ksteps, active=active)
    assert torch.equal(_bits(got), _bits(want))
    cells = wc.brick_cells(active, shape) if banded else None
    if banded:                                # frozen bricks change nothing
        prev, new = torch.where(cells, prev, phi), torch.where(cells, new,
                                                               phi)
    want_parts = k3_launch_partials(new, prev)
    assert torch.equal(_bits(got_parts), _bits(want_parts))
    assert torch.equal(_bits(_reduce_partials(got_parts)),
                       _bits(_reduce_partials(want_parts)))


@pytest.mark.parametrize("ksteps,chunk", [(1, 2), (2, 1), (3, 2), (4, 3)])
@pytest.mark.parametrize("mesh_shape", [(2, 2, 1), (2, 2, 2)])
@pytest.mark.parametrize("case", ["dense", "banded", "noisy"])
def test_k4_wavefront_block_geometry_bitwise(mesh_shape, ksteps, chunk,
                                            case):
    """K4's block mode: the wavefront in one shard's padded block (a halo
    of K, blocks that are not multiples of 8, so the last bricks reach into
    the halo) against the plain block version (fields, bitwise) and a
    brick-per-block launch's partials of the last step over the owned box
    (bitwise)."""
    shape, dx = (38, 46, 22), 0.1
    h1 = 0.15 * dx * dx
    mesh = make_mesh(mesh_shape, ["cpu"])
    phi = _sphere(shape, dx, 1.2, (0.13, -0.05, 0.02))
    if case == "noisy":
        rng = np.random.default_rng(7)
        noise = (rng.standard_normal(shape) * dx
                 * 10.0 ** rng.uniform(-8.0, 0.0, shape))
        phi = (0.02 * phi + torch.tensor(noise, dtype=phi.dtype)
               ).clamp(-3.0 * dx, 3.0 * dx)
    w = sh.sharded_widths(mesh, ksteps)
    pads = halo_exchange(split_blocks(mesh, phi), w, mesh)
    geoms = sh.minmax_geoms(mesh, shape, w)
    blocks = split_blocks(mesh, phi)
    for n in (0, len(pads) - 1):
        pad, geom = pads[n].contiguous(), geoms[n]
        act = None
        if case == "banded":
            act = wc.tile_activity(blocks[n], dx, 4.1, window="owned")
            act.view(-1)[::5] = 0
            assert 0 < int(act.sum()) < act.numel()
        got, parts = k4_wavefront(pad, dx, h1, ksteps, act, chunk, geom)
        want = mc.minmax_fusedk_block_plain(pad, dx, h1, geom, ksteps=ksteps,
                                            active=act)
        assert torch.equal(_bits(got), _bits(want))
        prev = pad if ksteps == 1 else mc.minmax_fusedk_block_plain(
            pad, dx, h1, geom, ksteps=ksteps - 1, active=act)
        nb = geom.bricks(pad.shape)
        counted = (wc.brick_cells(torch.ones(nb, dtype=torch.int32)
                                  if act is None else act, pad.shape,
                                  geom.brick_origin)
                   & wc.box_cells(geom, pad.shape, "cpu"))
        d = torch.where(counted, want - prev, torch.zeros_like(pad))
        ref = box_partials(d, _launch_record(geom, pad.shape))
        assert torch.equal(_bits(parts), _bits(ref))


# ---------------------- (c, d) the march of K3 and K1 ----------------------
#
# Both kernels walk x with a block per (y, z) column of TY x 32 cells and a
# chunk of x-slabs of the launch's brick box (``csrc/common.cuh``), in runs
# of live slabs; K3 (TY = 16) steps each plane from a ring plane with a
# one-cell y/z rim, K1 (TY = 8) from a 7-plane window with a 3-cell rim, a
# y/z face cell taking its clamped inner neighbour's value from the plane's
# exchange (or, outside the block, from the whole array) and an x face
# plane its column's value once plane 1 (or nx - 2) is done.  Cells outside
# the array are NaN in the model's windows: a cell that read one would turn
# NaN.  Each slab's squared changes go through block_sum's trees per brick,
# the partials into the launch box's brick order, the sum through
# ``reduce_partials``'s order.

MZ = 32


def _launch_record(geom, shape, tile_range=None):
    """The kernels' host record of ``geom`` (``BlockGeom.ints``)."""
    v = list(geom.ints(tuple(shape), tile_range))
    return dict(g=v[0:3], o=v[3:6], c=v[6:9], nb=v[9:12], t0=v[12:15],
                rms=v[15:21], tn=v[21:24])


def _march_cut(tn, ty, groups, slots, warm):
    """``common.cuh:march_launch``: (x-slabs per block, blocks along x)."""
    by, bz = ty // BRICK, MZ // BRICK
    cols = -(-tn[2] // bz) * -(-tn[1] // by) * groups
    best, chunk = None, 1
    for c in range(1, tn[0] + 1):
        cost = ((-(-tn[0] // c) * cols + slots - 1) // slots) * (BRICK * c
                                                                  + warm)
        if best is None or cost < best:
            best, chunk = cost, c
    return chunk, -(-tn[0] // chunk)


def _runs(bxa, bxb, live):
    """A chunk's slabs as ("dead", s, s) and ("run", first, last), a single
    dead slab between two live ones joining the run."""
    first = bxa
    while first < bxb:
        if not live(first):
            yield "dead", first, first
            first += 1
            continue
        last = first
        while last + 1 < bxb and (live(last + 1) or (last + 2 < bxb
                                                     and live(last + 2))):
            last += 1
        yield "run", first, last
        first = last + 1


def _window(f, planes, y0, z0, ty, rim):
    """Planes of ``f`` over the column (ty x 32) with a ``rim``-cell y/z rim,
    NaN outside the array (and for planes outside it)."""
    nx, ny, nz = f.shape
    w = torch.full((len(planes), ty + 2 * rim, MZ + 2 * rim), float("nan"),
                   dtype=f.dtype)
    ya, yb = max(y0 - rim, 0), min(y0 + ty + rim, ny)
    za, zb = max(z0 - rim, 0), min(z0 + MZ + rim, nz)
    for n, i in enumerate(planes):
        if 0 <= i < nx and ya < yb and za < zb:
            w[n, ya - y0 + rim:yb - y0 + rim, za - z0 + rim:zb - z0 + rim] = \
                f[i, ya:yb, za:zb]
    return w


class _Tile:
    """The column a block owns: cell (ty, tz) at array (y0 + ty, z0 + tz)."""

    def __init__(self, q, shape, ty, byl0, bzl0):
        self.y0 = q["c"][1] + (q["t0"][1] + byl0) * BRICK
        self.z0 = q["c"][2] + (q["t0"][2] + bzl0) * BRICK
        j = (self.y0 + torch.arange(ty)).reshape(-1, 1)
        k = (self.z0 + torch.arange(MZ)).reshape(1, -1)
        gj, gk = q["o"][1] + j, q["o"][2] + k
        self.j, self.k, self.gj, self.gk = j, k, gj, gk
        self.col_in = (j >= 0) & (j < shape[1]) & (k >= 0) & (k < shape[2])
        self.in_range = ((byl0 + torch.arange(ty) // BRICK < q["tn"][1])
                         .reshape(-1, 1)
                         & (bzl0 + torch.arange(MZ) // BRICK < q["tn"][2])
                         .reshape(1, -1))
        self.box = ((gj >= q["rms"][2]) & (gj < q["rms"][3])
                    & (gk >= q["rms"][4]) & (gk < q["rms"][5]))
        self.bricks = [(byl0 + b // 4, bzl0 + b % 4)
                       for b in range((ty // BRICK) * 4)
                       if byl0 + b // 4 < q["tn"][1]
                       and bzl0 + b % 4 < q["tn"][2]]
        self.ty, self.byl0, self.bzl0 = ty, byl0, bzl0

    def cells(self, f, i):
        """Plane i of ``f`` over the column (NaN outside the array)."""
        return _window(f, [i], self.y0, self.z0, self.ty, 0)[0]

    def put(self, out, i, vals, mask):
        cur = self.cells(out, i)
        new = torch.where(mask, vals, cur)
        ya, za = max(self.y0, 0), max(self.z0, 0)
        yb = min(self.y0 + self.ty, out.shape[1])
        zb = min(self.z0 + MZ, out.shape[2])
        out[i, ya:yb, za:zb] = new[ya - self.y0:yb - self.y0,
                                   za - self.z0:zb - self.z0]

    def active_map(self, q, active, bxl):
        """Per cell of the column: its brick (slab bxl) is active."""
        m = torch.ones(self.ty, MZ, dtype=torch.bool)
        if active is None:
            return m
        for ty in range(self.ty // BRICK):
            for tz in range(MZ // BRICK):
                byl, bzl = self.byl0 + ty, self.bzl0 + tz
                on = (byl < q["tn"][1] and bzl < q["tn"][2]
                      and bool(active[q["t0"][0] + bxl, q["t0"][1] + byl,
                                      q["t0"][2] + bzl]))
                m[ty * BRICK:(ty + 1) * BRICK, tz * BRICK:(tz + 1) * BRICK] = on
        return m

    def slab_partials(self, dq, parts, q, bxl, square=True):
        """One slab's partials: block_sum's x-tree per column over the BRICK
        planes dq (float32 changes, squared; or the values themselves),
        then the y- and z-trees per brick."""
        dd = torch.stack(dq).double()                       # (8, ty, 32)
        if square:
            dd = dd ** 2
        xt = _tree(dd.permute(1, 2, 0))
        for byl, bzl in self.bricks:
            ly, lz = (byl - self.byl0) * BRICK, (bzl - self.bzl0) * BRICK
            blk = xt[ly:ly + BRICK, lz:lz + BRICK]
            parts[(bxl * q["tn"][1] + byl) * q["tn"][2] + bzl] = \
                _tree(blk.reshape(-1))


def _march_tiles(q, ty):
    by = ty // BRICK
    for byt in range(-(-q["tn"][1] // by)):
        for bzt in range(-(-q["tn"][2] // 4)):
            yield byt * by, bzt * 4


def k3_march(pad, sc, q, chunk, active=None, copy_inactive=True, out=None,
             glive=True):
    """K3's march (``csrc/minmax_step.cu:minmax_march_kernel``) on one
    geometry: the output (``out`` updated) and the launch's partials."""
    TY = 16
    nx, ny, nz = pad.shape
    out = torch.full_like(pad, float("nan")) if out is None else out.clone()
    tn = q["tn"]
    parts = torch.full((tn[0] * tn[1] * tn[2],), float("nan"),
                       dtype=torch.float64)
    nchunk = -(-tn[0] // chunk)
    g = q["g"]
    for byl0, bzl0 in _march_tiles(q, TY):
        t = _Tile(q, pad.shape, TY, byl0, bzl0)
        col = t.col_in & t.in_range
        col_steps = ((t.gj >= 1) & (t.gj <= g[1] - 2) & (t.gk >= 1)
                     & (t.gk <= g[2] - 2) & (t.j >= 1) & (t.j <= ny - 2)
                     & (t.k >= 1) & (t.k <= nz - 2))

        def x0_of(bxl):
            return q["c"][0] + (q["t0"][0] + bxl) * BRICK

        def live(bxl):
            x0 = x0_of(bxl)
            if not glive or x0 + BRICK <= 0 or x0 >= nx:
                return False
            return active is None or bool(t.active_map(q, active, bxl).any()
                                          and any(True for _ in t.bricks))

        for cx in range(nchunk):
            bxa, bxb = cx * chunk, min(cx * chunk + chunk, tn[0])
            for kind, first, last in _runs(bxa, bxb, live):
                if kind == "dead":
                    x0 = x0_of(first)
                    if copy_inactive or not glive:
                        for i in range(max(x0, 0), min(x0 + BRICK, nx)):
                            t.put(out, i, t.cells(pad, i), col)
                    for byl, bzl in t.bricks:
                        parts[(first * tn[1] + byl) * tn[2] + bzl] = 0.0
                    continue
                xs, xe = max(x0_of(first), 0), min(x0_of(last + 1), nx)
                for sl in range(first, last + 1):
                    act = col & t.active_map(q, active, sl)
                    dq = []
                    for m in range(BRICK):
                        i = x0_of(sl) + m
                        if not xs <= i < xe:
                            dq.append(torch.zeros(TY, MZ))
                            continue
                        w = _window(pad, [i - 1, i, i + 1], t.y0, t.z0, TY, 1)
                        gi = q["o"][0] + i
                        plane = 1 <= gi <= g[0] - 2 and 1 <= i <= nx - 2
                        gate = torch.zeros(w.shape, dtype=torch.bool)
                        gate[1, 1:-1, 1:-1] = act & col_steps & plane
                        c = w[1, 1:-1, 1:-1]
                        r = mc._dense_step(w, sc, gate)[1, 1:-1, 1:-1]
                        t.put(out, i, r, col & (act | copy_inactive))
                        box = col & t.box & (q["rms"][0] <= gi < q["rms"][1])
                        dq.append(torch.where(box, r - c, torch.zeros_like(c)))
                    t.slab_partials(dq, parts, q, sl)
    return out, parts


def box_partials(d, q, square=True):
    """``block_sum`` over each brick of the launch box of the float32
    changes ``d`` (0 where the sum does not count), squared (or the values
    themselves): the partials of a brick-per-block launch, in its order."""
    tn, c, t0 = q["tn"], q["c"], q["t0"]
    full = torch.zeros(tuple(n * BRICK for n in tn), dtype=torch.float64)
    src, dst = [], []
    for a in range(3):
        lo = c[a] + t0[a] * BRICK
        s0, s1 = max(lo, 0), min(lo + tn[a] * BRICK, d.shape[a])
        src.append(slice(s0, s1))
        dst.append(slice(s0 - lo, s1 - lo))
    full[tuple(dst)] = d[tuple(src)].double() ** (2 if square else 1)
    full = full.reshape(tn[0], BRICK, tn[1], BRICK, tn[2], BRICK)
    return _tree(full.permute(0, 2, 4, 1, 3, 5).reshape(-1, BRICK ** 3))


def _geom_sphere(shape, dx, scale=2.0):
    r = 0.35 * min(shape) * dx
    return (scale * _sphere(shape, dx, r, (0.05, -0.03, 0.02)),
            _sphere(shape, dx, 1.1 * r, (0.05, -0.03, 0.02)))


MARCH_SHAPES = [(67, 45, 39), (66, 46, 38), (20, 9, 35), (6, 30, 41)]
MARCH_MODES = ["dense", "banded", "carry", "pack", "block221", "block222"]


def _march_cases(mode, shape, dx, kernel):
    """(pad, sign, geom, tile_range, active, copy_inactive, out) for one
    geometry of a mode; pack and block give several."""
    phi, sgn = _geom_sphere(shape, dx, 2.0 if kernel == "k1" else 1.0)
    if mode in ("dense", "banded", "carry", "pack"):
        geom = wc.BlockGeom(tuple(shape))
        act = None
        if mode in ("banded", "carry"):
            act = (wc.tile_activity(phi, dx, 3.1, window="band4")
                   if kernel == "k1" else
                   wc.tile_activity(phi, dx, 4.1, window="owned"))
            act.view(-1)[::7] = 0
        out = None
        if mode == "carry":
            # the ping-pong buffer: a frozen brick holds the field's values
            # (the BC of a face cell may read them), the rest is stale
            out = torch.where(wc.brick_cells(act, phi.shape), phi + 0.25, phi)
        return [(phi, sgn, geom, None, act, mode != "carry", out)]
    mesh = make_mesh((2, 2, 1) if mode == "block221" else (2, 2, 2),
                     ["cpu"])
    # blocks at least a brick on the sharded axes (the exchange's widths)
    gs = tuple(max(-(-n // m), BRICK) * m if m > 1 else n
               for n, m in zip(shape, mesh.shape))
    phi, sgn = _geom_sphere(gs, dx, 2.0 if kernel == "k1" else 1.0)
    if kernel == "k1":
        w = sh.sharded_widths(mesh, sh.HALO)
        geoms = sh.reinit_geoms(mesh, gs, w)
    else:
        w = sh.sharded_widths(mesh, 1)
        geoms = sh.minmax_geoms(mesh, gs, w)
    pads = halo_exchange(split_blocks(mesh, phi), w, mesh)
    spads = halo_exchange(split_blocks(mesh, sgn), w, mesh)
    cases = []
    for n, (p, s, g) in enumerate(zip(pads, spads, geoms)):
        nb = g.bricks(p.shape)
        tr = None
        if kernel == "k1" and n == 1:         # a sub-box of the brick grid
            tr = ((1, 0, 1), (max(nb[0] - 2, 1), nb[1], max(nb[2] - 1, 1)))
        act = None
        if n == 2:
            act = torch.ones(nb, dtype=torch.int32)
            act.view(-1)[::3] = 0
        cases.append((p.contiguous(), s.contiguous(), g, tr, act, True,
                      p.clone()))
    return cases


@pytest.mark.parametrize("slots", [264, 1])
@pytest.mark.parametrize("shape", MARCH_SHAPES)
@pytest.mark.parametrize("mode", MARCH_MODES)
def test_k3_march_matches_plain_bitwise(mode, shape, slots):
    """K3's march on every mode against the plain versions (fields) and a
    brick-per-block launch's block_sum + reduce_partials (sums), bitwise;
    ``slots`` = 1 walks the whole x extent in one block."""
    dx = 0.05
    h1 = 0.3 * dx * dx
    if mode == "pack":
        b = 3
        phis = torch.stack([_geom_sphere(shape, dx, 1.0)[0] * (1 + 0.1 * n)
                            for n in range(b)])
        h1s = [h1 * (1 + 0.2 * n) for n in range(b)]
        live = [1, 0, 1]
        want, want_dsq = mc.minmax_step_packed_plain(phis, dx, h1s, live,
                                                     with_rms=True)
        geom = wc.BlockGeom(tuple(shape))
        q = _launch_record(geom, shape)
        chunk, _ = _march_cut(q["tn"], 16, b, slots, 2)
        for n in range(b):
            sc = mc.minmax_scalars(torch.float32, dx, h1s[n], 4.1, 0.0)
            got, parts = k3_march(phis[n], sc, q, chunk, glive=bool(live[n]))
            assert torch.equal(_bits(got), _bits(want[n]))
            d = (want[n] - phis[n]) if live[n] else torch.zeros(shape)
            ref = box_partials(d, q)
            assert torch.equal(_bits(parts), _bits(ref))
            assert float(_reduce_partials(parts)) == float(
                _reduce_partials(ref))
        return
    sc = mc.minmax_scalars(torch.float32, dx, h1, 4.1, 0.0)
    for pad, _, geom, _, act, mint, out in _march_cases(mode, shape, dx,
                                                        "k3"):
        q = _launch_record(geom, pad.shape)
        chunk, _ = _march_cut(q["tn"], 16, 1, slots, 2)
        got, parts = k3_march(pad, sc, q, chunk, act, mint, out)
        if mode.startswith("block"):
            want, dsq = mc.minmax_step_block_plain(pad, dx, h1, geom,
                                                   active=act,
                                                   out=out.clone(),
                                                   with_rms=True)
            written = wc.brick_cells(torch.ones(geom.bricks(pad.shape),
                                                dtype=torch.int32),
                                     pad.shape, geom.brick_origin)
            d = torch.where(written & wc.box_cells(geom, pad.shape, "cpu"),
                            want - pad, torch.zeros_like(pad))
        else:
            want = mc.minmax_step_plain(pad, dx, h1, active=act,
                                        out=None if out is None
                                        else out.clone(), mint=mint)
            mint_want = mc.minmax_step_plain(pad, dx, h1, active=act)
            d = mint_want - pad
        assert torch.equal(_bits(got), _bits(want))
        ref = box_partials(d, q)
        assert torch.equal(_bits(parts), _bits(ref))
        if mode.startswith("block"):
            assert abs(float(_reduce_partials(parts)) - float(dsq)) <= \
                1e-12 * float(dsq)


def _per_brick(x, tn):
    """(tn0 * 8, tn1 * 8, tn2 * 8) -> (bricks, 512), each brick's cells in
    thread-rank order (x slowest, z fastest), bricks in launch order."""
    x = x.reshape(tn[0], BRICK, tn[1], BRICK, tn[2], BRICK)
    return x.permute(0, 2, 4, 1, 3, 5).reshape(-1, BRICK ** 3)


def k1_bricks(pad, sgn, sc, q, active=None, copy_inactive=True, out=None,
              glive=True, p5=False):
    """K1's schedule (``csrc/reinit_step.cu:reinit_brick_kernel``) on one
    geometry, all bricks of the launch box at once: one thread per cell; a
    face cell evaluates its clamped inner neighbour, every evaluation reads
    that cell's stencil (the update where its brick is active, else its
    value) and is written where the stencil stays in the array; a frozen
    brick with no face cell and no copy is idle; each brick's squared
    changes go through the kernel's one-barrier tree.  Returns the output
    (``out`` updated) and the launch's partials."""
    nx, ny, nz = pad.shape
    out = torch.full_like(pad, float("nan")) if out is None else out.clone()
    tn, g, o, c, t0, nb = q["tn"], q["g"], q["o"], q["c"], q["t0"], q["nb"]
    # the update of every cell from its own stencil (valid where the
    # stencil stays in the array: the only cells the kernel evaluates)
    upd = wc._interior_update(pad, sgn, sc, p5,
                              deep=global_interior_mask(pad.shape, o, g, 4))
    act = torch.ones(nb, dtype=torch.bool) if active is None else \
        active.bool()
    idx = [(c[a] + t0[a] * BRICK + torch.arange(tn[a] * BRICK))
           .reshape([-1 if b == a else 1 for b in range(3)])
           .expand(*(n * BRICK for n in tn)) for a in range(3)]
    n_ = (nx, ny, nz)
    gl = [o[a] + idx[a] for a in range(3)]
    in_grid = torch.ones(idx[0].shape, dtype=torch.bool)
    for a in range(3):
        in_grid &= ((idx[a] >= 0) & (idx[a] < n_[a]) & (gl[a] >= 0)
                    & (gl[a] < g[a]))
    live = act[t0[0]:t0[0] + tn[0], t0[1]:t0[1] + tn[1],
               t0[2]:t0[2] + tn[2]]
    for a in range(3):
        live = live.repeat_interleave(BRICK, dim=a)
    gs = [torch.clamp(gl[a], 1, g[a] - 2) for a in range(3)]
    face = (gs[0] != gl[0]) | (gs[1] != gl[1]) | (gs[2] != gl[2])
    sv = [gs[a] - o[a] for a in range(3)]
    deep = torch.ones(idx[0].shape, dtype=torch.bool)
    for a in range(3):
        deep &= (gs[a] >= 4) & (gs[a] <= g[a] - 5)
    r = torch.where(deep, 3, 1)
    valid = torch.ones(idx[0].shape, dtype=torch.bool)
    for a in range(3):
        valid &= (sv[a] >= r) & (sv[a] + r < n_[a])
    cl = [idx[a].clamp(0, n_[a] - 1) for a in range(3)]
    scl = [sv[a].clamp(0, n_[a] - 1) for a in range(3)]
    # the evaluated cell's brick: the kernel's truncating index
    nba = [torch.div(scl[a] - c[a], BRICK, rounding_mode="trunc")
           .clamp(0, nb[a] - 1) for a in range(3)]
    on = act[nba[0], nba[1], nba[2]]
    phi_c = pad[cl[0], cl[1], cl[2]]
    v = torch.where(on, upd[scl[0], scl[1], scl[2]],
                    pad[scl[0], scl[1], scl[2]])
    res = torch.where(face, v + sc["dx"], v)
    # a brick is idle when frozen, not copying and without an in-grid face
    busy = _per_brick(in_grid & face, tn).any(dim=1)
    idle_b = ~_per_brick(live, tn)[:, 0] & ~busy if not copy_inactive \
        else torch.zeros_like(busy)
    idle = idle_b.reshape(tn).repeat_interleave(BRICK, 0) \
        .repeat_interleave(BRICK, 1).repeat_interleave(BRICK, 2)
    if not glive:
        wr, vals, d = in_grid, phi_c, torch.zeros(idx[0].shape)
    else:
        ev = in_grid & (face | live) & ~idle
        wr_ev = ev & valid
        wr_cp = in_grid & ~(face | live) & copy_inactive
        wr = wr_ev | wr_cp
        vals = torch.where(wr_ev, res, phi_c)
        box = torch.ones(idx[0].shape, dtype=torch.bool)
        for a in range(3):
            box &= (gl[a] >= q["rms"][2 * a]) & (gl[a] < q["rms"][2 * a + 1])
        d = torch.where(wr_ev & box, res - phi_c, torch.zeros_like(res))
    out[cl[0][wr], cl[1][wr], cl[2][wr]] = vals[wr]
    # the kernel's tree: x (rank + 256, + 128, + 64) and the first y step
    # (+ 32) in shared memory, then one warp's shuffles (+ 16, .., + 1)
    dd = _per_brick(d, tn).double() ** 2
    x = (((dd[:, 0:64] + dd[:, 256:320]) + (dd[:, 128:192] + dd[:, 384:448]))
         + ((dd[:, 64:128] + dd[:, 320:384])
            + (dd[:, 192:256] + dd[:, 448:512])))
    return out, _tree(x[:, :32] + x[:, 32:])


@pytest.mark.parametrize("shape", MARCH_SHAPES)
@pytest.mark.parametrize("mode", MARCH_MODES)
def test_k1_bricks_match_plain_bitwise(mode, shape):
    """K1's brick schedule on every mode against the plain versions
    (fields) and block_sum over each brick + reduce_partials (sums),
    bitwise."""
    dx = 0.05
    h = 0.1 * dx
    if mode == "pack":
        b = 3
        phis, sgns = zip(*[_geom_sphere(shape, dx * (1 + 0.1 * n))
                           for n in range(b)])
        phis, sgns = torch.stack(phis), torch.stack(sgns)
        hs = [h * (1 + 0.2 * n) for n in range(b)]
        live = [1, 0, 1]
        want = wc.reinit_step_packed_plain(phis, sgns, dx, hs, live)
        q = _launch_record(wc.BlockGeom(tuple(shape)), shape)
        for n in range(b):
            sc = wc.step_scalars(torch.float32, dx, hs[n])
            got, parts = k1_bricks(phis[n], sgns[n], sc, q,
                                   glive=bool(live[n]))
            assert torch.equal(_bits(got), _bits(want[n]))
            d = want[n] - phis[n] if live[n] else torch.zeros(shape)
            assert torch.equal(_bits(parts), _bits(box_partials(d, q)))
        return
    sc = wc.step_scalars(torch.float32, dx, h)
    for pad, sgn, geom, tr, act, mint, out in _march_cases(mode, shape, dx,
                                                           "k1"):
        q = _launch_record(geom, pad.shape, tr)
        got, parts = k1_bricks(pad, sgn, sc, q, act, mint, out)
        if mode.startswith("block"):
            want, dsq = wc.reinit_step_block_plain(
                pad, sgn, dx, h, geom, active=act, tile_range=tr,
                out=out.clone(), with_rms=True)
            written = wc._range_cells(geom, pad.shape, tr, "cpu")
            d = torch.where(written & wc.box_cells(geom, pad.shape, "cpu"),
                            want - pad, torch.zeros_like(pad))
        else:
            want = wc.reinit_step_plain(pad, sgn, dx, h, active=act,
                                        out=None if out is None
                                        else out.clone(), mint=mint)
            mint_want = wc.reinit_step_plain(pad, sgn, dx, h, active=act)
            d = mint_want - pad
            if act is not None:     # a frozen brick's interior copies
                frozen = ~wc.brick_cells(act, pad.shape) & \
                    interior_mask(pad.shape, 1)
                d = torch.where(frozen, torch.zeros_like(d), d)
        assert torch.equal(_bits(got), _bits(want))
        ref = box_partials(d, q)
        assert torch.equal(_bits(parts), _bits(ref))
        assert float(_reduce_partials(parts)) == float(_reduce_partials(ref))
        if mode.startswith("block"):
            assert abs(float(_reduce_partials(parts)) - float(dsq)) <= \
                1e-12 * float(dsq)


# ------------------------- (e) K6's march ----------------------------------
# ``csrc/minmax_bwd.cu:minmax_bwd_march_kernel``: K3's column tiles and x
# chunks split into runs of live slabs; each step evaluates cot_lap once per
# cell of the next plane over the column and a 1-cell y/z rim (phi read with
# a 2-cell rim), keeps cs = cot_lap / dx^2 of two planes (the y/z
# neighbours) and the column's own of the planes around (x), and gathers
# the current plane in the order x+, x-, y+, y-, z-, z+ into the owned box;
# a frozen slab run passes g through.  Both sums take block_sum's trees per
# brick and reduce_partials's order.

def _k6_frame(w, gw, ev, sc):
    """cot_lap, lap and cot_h1 over one plane's 1-rim frame: ``w`` the phi
    planes p - 1 .. p + 1 with a 2-cell rim, ``gw`` plane p of g with a
    1-cell rim, ``ev`` the cells that evaluate."""
    c = w[1, 1:-1, 1:-1]
    sum6 = ((((w[0, 1:-1, 1:-1] + w[2, 1:-1, 1:-1]) + w[1, :-2, 1:-1])
             + w[1, 2:, 1:-1]) + w[1, 1:-1, 2:]) + w[1, 1:-1, :-2]
    lap = (sum6 - 6.0 * c) * sc["inv_dx2"]
    sel = (sum6 + c) * (1.0 / 7.0) < sc["threshold"]
    f = torch.where(sel, torch.clamp_max(lap, 0.0),
                    torch.clamp_min(lap, 0.0))
    zero = torch.zeros_like(c)
    tie = torch.where(lap == 0.0, 0.5 + zero, zero)
    dlap = torch.where(sel, torch.where(lap < 0.0, 1.0 + zero, tie),
                       torch.where(lap > 0.0, 1.0 + zero, tie))
    gate = ev & (torch.abs(c) < sc["band_dx"])
    g = gw[0]
    return (torch.where(gate, (sc["h1"] * g) * dlap, zero),
            torch.where(gate, lap, zero), torch.where(gate, f * g, zero))


def k6_march(pad, g, sc, q, chunk, active=None):
    """K6's march on one array: ``cot_phi`` of the owned box (q's rms box)
    and the launch's two partial vectors (cot_lap * lap, F g)."""
    TY = 16
    nx, ny, nz = pad.shape
    gs, o, box, tn = q["g"], q["o"], q["rms"], q["tn"]
    out = torch.full((box[1] - box[0], box[3] - box[2], box[5] - box[4]),
                     float("nan"), dtype=pad.dtype)
    nbr = tn[0] * tn[1] * tn[2]
    pdx = torch.full((nbr,), float("nan"), dtype=torch.float64)
    ph = torch.full((nbr,), float("nan"), dtype=torch.float64)
    inv = sc["inv_dx2"]
    for byl0, bzl0 in _march_tiles(q, TY):
        t = _Tile(q, pad.shape, TY, byl0, bzl0)
        col_w = t.col_in & t.in_range & t.box
        fj = (t.y0 - 1 + torch.arange(TY + 2)).reshape(-1, 1)
        fk = (t.z0 - 1 + torch.arange(MZ + 2)).reshape(1, -1)
        yz_ev = ((o[1] + fj >= 1) & (o[1] + fj <= gs[1] - 2)
                 & (o[2] + fk >= 1) & (o[2] + fk <= gs[2] - 2)
                 & (fj >= 1) & (fj <= ny - 2) & (fk >= 1) & (fk <= nz - 2))
        rj = (t.gj - box[2]).expand(TY, MZ)
        rk = (t.gk - box[4]).expand(TY, MZ)

        def x0_of(bxl):
            return q["c"][0] + (q["t0"][0] + bxl) * BRICK

        def live(bxl):
            x0 = x0_of(bxl)
            if x0 + BRICK <= 0 or x0 >= nx:
                return False
            return active is None or bool(t.active_map(q, active, bxl).any()
                                          and any(True for _ in t.bricks))

        def write(i, vals):
            """Plane i's cells into the owned box; the mask of cells it
            wrote (none when the plane lies outside the box)."""
            if not box[0] <= o[0] + i < box[1]:
                return torch.zeros_like(col_w)
            out[o[0] + i - box[0], rj[col_w], rk[col_w]] = vals[col_w]
            return col_w

        def evaluate(p):
            w = _window(pad, [p - 1, p, p + 1], t.y0, t.z0, TY, 2)
            gw = _window(g, [p], t.y0, t.z0, TY, 1)
            x_ok = 1 <= o[0] + p <= gs[0] - 2 and 1 <= p <= nx - 2
            cl, lap, ch = _k6_frame(w, gw, yz_ev & x_ok, sc)
            return cl * inv, cl, lap, ch, gw[0]

        def brick_slots(bxl):
            return [(bxl * tn[1] + byl) * tn[2] + bzl for byl, bzl in t.bricks]

        for cx in range(-(-tn[0] // chunk)):
            bxa, bxb = cx * chunk, min(cx * chunk + chunk, tn[0])
            for kind, first, last in _runs(bxa, bxb, live):
                if kind == "dead":
                    x0 = x0_of(first)
                    for i in range(max(x0, 0), min(x0 + BRICK, nx)):
                        write(i, t.cells(g, i) + 0.0)
                    for n in brick_slots(first):
                        pdx[n] = ph[n] = 0.0
                    continue
                xs, xe = max(x0_of(first), 0), min(x0_of(last + 1), nx)
                own = (slice(1, -1), slice(1, -1))
                csm = evaluate(xs - 1)[0][own]
                cur = evaluate(xs)
                ring = {xs & 1: cur[0]}         # cs planes: y/z neighbours
                for sl in range(first, last + 1):
                    act = t.col_in & t.in_range & t.active_map(q, active, sl)
                    vdx, vh = [], []
                    for m in range(BRICK):
                        i = x0_of(sl) + m
                        zero = torch.zeros(TY, MZ, dtype=pad.dtype)
                        if not xs <= i < xe:
                            vdx.append(zero)
                            vh.append(zero)
                            continue
                        nxt = evaluate(i + 1)
                        ring[(i + 1) & 1] = nxt[0]
                        csc = ring[i & 1]
                        cl, lap, ch, gi = (v[own] for v in cur[1:])
                        acc = gi - (6.0 * inv) * cl
                        acc = acc + nxt[0][own]                    # x+
                        acc = acc + csm                            # x-
                        acc = acc + csc[2:, 1:-1]                  # y+
                        acc = acc + csc[:-2, 1:-1]                 # y-
                        acc = acc + csc[1:-1, :-2]                 # z-
                        acc = acc + csc[1:-1, 2:]                  # z+
                        wm = write(i, torch.where(act, acc, gi + 0.0))
                        vdx.append(torch.where(wm & act, cl * lap, zero))
                        vh.append(torch.where(wm & act, ch, zero))
                        csm, cur = cur[0][own], nxt
                    t.slab_partials(vdx, pdx, q, sl, square=False)
                    t.slab_partials(vh, ph, q, sl, square=False)
    return out, pdx, ph


K6_SHAPES = [(37, 45, 39), (20, 9, 35), (6, 30, 41)]
K6_MODES = ["dense", "banded", "block221", "block222"]


def _k6_inputs(mode, shape, dx, dtype, rng):
    """[(pad, g, geom, active)] of a mode: a sphere after one min/max step
    (rounded so that exact ties lap == 0 occur), a standard-normal g; a
    random brick mask; the blocks of a (2,2,1) or (2,2,2) cut whose sizes
    are not multiples of 8 on the sharded axes."""
    def field(s):
        phi = _geom_sphere(s, dx, 1.0)[0].to(dtype)
        phi = torch.round(phi / (dx / 8)) * (dx / 8)
        return phi, torch.tensor(rng.standard_normal(s), dtype=dtype)
    if mode in ("dense", "banded"):
        phi, g = field(shape)
        act = None
        if mode == "banded":
            act = torch.tensor(rng.random(wc.brick_grid(shape)) < 0.5,
                               dtype=torch.int32)
        return [(phi, g, wc.BlockGeom(tuple(shape)), act)]
    mesh = make_mesh((2, 2, 1) if mode == "block221" else (2, 2, 2), ["cpu"])
    gs = tuple(max(-(-n // m), 3) * m if m > 1 else n
               for n, m in zip(shape, mesh.shape))
    phi, g = field(gs)
    w = sh.sharded_widths(mesh, wc.VJP_HALO["minmax"])
    geoms = sh.minmax_geoms(mesh, gs, w)
    pads, gpads = ([p.contiguous() for p in halo_exchange(
        split_blocks(mesh, f), w, mesh)] for f in (phi, g))
    return [(p, q, ge, None) for p, q, ge in zip(pads, gpads, geoms)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", K6_SHAPES)
@pytest.mark.parametrize("mode", K6_MODES)
def test_k6_march_matches_plain_bitwise(mode, shape, dtype):
    """K6's march against the plain versions, bitwise: the owned box's
    cotangent field, and each sum's partials against block_sum's tree over
    the plain per-cell terms (a brick-per-block launch), reduced in
    reduce_partials's order; the sums themselves against the plain ones
    (another order) to 1e-12.  Two chunkings: the card's (264 resident
    blocks) and one block walking the whole x extent."""
    dx = 0.05
    h1 = 0.3 * dx * dx
    rng = np.random.default_rng(5)
    sc = mc.minmax_scalars(dtype, dx, h1, 4.1, 0.0)
    for pad, g, geom, act in _k6_inputs(mode, shape, dx, dtype, rng):
        q = _launch_record(geom, pad.shape)
        solo = not mode.startswith("block")
        if solo:
            want = mc.minmax_step_vjp_plain(pad, g, dx, h1, active=act)
            live = None if act is None else wc.brick_cells(act, pad.shape)
            _, tdx, th = mc._vjp_cells(pad, g, sc, (0, 0, 0),
                                       tuple(pad.shape), live, None)
        else:
            want = mc.minmax_step_block_vjp_plain(pad, g, dx, h1, geom)
            _, tdx, th = mc._vjp_cells(pad, g, sc, geom.origin, geom.gshape,
                                       None, wc.box_cells(geom, pad.shape,
                                                          "cpu"))
        for slots in (264, 1):
            chunk, _ = _march_cut(q["tn"], 16, 1, slots, 2)
            got, pdx, ph = k6_march(pad, g, sc, q, chunk, act)
            assert torch.equal(_bits(got), _bits(want[0]))
            for parts, terms, total, scale in (
                    (pdx, tdx, want[1], -2.0 / sc["dx"]),
                    (ph, th, want[2], 1.0)):
                ref = box_partials(terms, q, square=False)
                assert torch.equal(_bits(parts), _bits(ref))
                s = scale * float(_reduce_partials(parts))
                assert abs(s - float(total)) <= 1e-12 * max(
                    abs(float(total)), 1e-300)
