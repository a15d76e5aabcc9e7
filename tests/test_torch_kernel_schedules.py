"""CPU models of the schedules of the two kernels redesigned for the H100,
written in torch from the plain helpers and held bitwise against the plain
versions, so that their index arithmetic is checked before the card runs
them (the CUDA kernels themselves run only on the card).

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
from levelsetfortran_tpu_torch.ops.stencil import global_interior_mask
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


def k4_wavefront(phi, dx, h1, ksteps, active, chunk):
    """K4's schedule (mint): the field after ``ksteps`` steps and the last
    step's per-brick partials."""
    K = ksteps
    sc = mc.minmax_scalars(phi.dtype, dx, h1, 4.1, 0.0)
    nx, ny, nz = phi.shape
    nbx, nby, nbz = wc.brick_grid(phi.shape)
    out = torch.full_like(phi, float("nan"))
    parts = torch.full((nbx * nby * nbz,), float("nan"), dtype=torch.float64)
    act = torch.ones((nbx, nby, nbz), dtype=torch.int32) if active is None \
        else active
    live_cells = wc.brick_cells(act, phi.shape)

    def brick_id(bx, by, bz):
        return (bx * nby + by) * nbz + bz

    for y0 in range(0, ny, TY):
        for z0 in range(0, nz, TZ):
            ylo, yhi = max(y0 - K, 0), min(y0 + TY + K, ny)  # widened column
            zlo, zhi = max(z0 - K, 0), min(z0 + TZ + K, nz)
            bys = range(y0 // BRICK, min((y0 + TY) // BRICK, nby))
            bzs = range(z0 // BRICK, min((z0 + TZ) // BRICK, nbz))
            yc = slice(y0 - ylo, min(y0 + TY, ny) - ylo)  # the owned column
            zc = slice(z0 - zlo, min(z0 + TZ, nz) - zlo)
            # a three-plane slab's middle plane steps where its cells are
            # interior in global coordinates (face planes are copied)
            inner = global_interior_mask((3, yhi - ylo, zhi - zlo),
                                         (0, ylo, zlo), (3, ny, nz), 1)

            def live(bx):
                return bool(act[bx, bys.start:bys.stop,
                                bzs.start:bzs.stop].any())

            for c0 in range(0, nbx, chunk):
                c1 = min(c0 + chunk, nbx)
                first = c0
                while first < c1:
                    if not live(first):
                        x = slice(first * BRICK, min(first * BRICK + BRICK,
                                                     nx))
                        out[x, y0:y0 + TY, z0:z0 + TZ] = \
                            phi[x, y0:y0 + TY, z0:z0 + TZ]
                        for by in bys:
                            for bz in bzs:
                                parts[brick_id(first, by, bz)] = 0.0
                        first += 1
                        continue
                    last = first
                    while last + 1 < c1 and (live(last + 1) or (
                            last + 2 < c1 and live(last + 2))):
                        last += 1
                    xs, xe = first * BRICK, min((last + 1) * BRICK, nx)
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
                            if p in (0, nx - 1):     # a face plane: no step
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
                            cells = live_cells[p, y0:y0 + TY, z0:z0 + TZ]
                            out[p, y0:y0 + TY, z0:z0 + TZ] = torch.where(
                                cells, new, phi[p, y0:y0 + TY, z0:z0 + TZ])
                            d = torch.zeros(TY, TZ, dtype=torch.float64)
                            dd = (new - old).double()
                            d[:dd.shape[0], :dd.shape[1]] = dd * dd
                            dq[p % BRICK] = d
                            if p % BRICK == BRICK - 1 or p == xe - 1:
                                col = torch.stack(
                                    [dq.get(i, torch.zeros(TY, TZ,
                                                           dtype=torch.float64))
                                     for i in range(BRICK)])
                                xt = _tree(col.permute(1, 2, 0))  # (TY, TZ)
                                bx = p // BRICK
                                for by in bys:
                                    for bz in bzs:
                                        blk = xt[(by * BRICK - y0):
                                                 (by * BRICK - y0) + BRICK,
                                                 (bz * BRICK - z0):
                                                 (bz * BRICK - z0) + BRICK]
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
