"""The block modes of kernels K1 (reinit step) and K3 (min/max step): one
shard's halo-padded block of a domain-decomposed grid, every mask in global
coordinates.  On the CPU the wrappers run the plain versions, held here

* against the port's solo plain step on the whole grid: BITWISE, float32
  and float64, meshes (2,2,1), (2,2,2), (1,2,4), (4,2,1);
* against the JAX package's Pallas block step in interpret mode on virtual
  CPU devices: 1e-6 (K1; measured 1.2e-7) and 1e-7 (K3; measured 3.0e-8),
  the tolerances of the solo kernels (other reciprocals, ROADMAP H5);
* two steps per exchange and the overlapped step against plain stepping:
  bitwise; the owned-range sums against the solo sum: 1e-12 relative
  (measured <= 2e-16); the brick mask with a block origin against the solo
  mask on aligned blocks: equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from levelsetfortran_tpu.parallel.mesh import make_mesh as jax_make_mesh
from levelsetfortran_tpu.parallel.sharded import \
    ShardedLevelSet as JaxShardedLevelSet
from levelsetfortran_tpu_torch.ops import minmax_cuda as mc
from levelsetfortran_tpu_torch.ops import weno_cuda as wc
from levelsetfortran_tpu_torch.parallel import sharded as sh
from levelsetfortran_tpu_torch.parallel.halo import (crop, halo_exchange,
                                                     local_offsets)
from levelsetfortran_tpu_torch.parallel.mesh import (gather_blocks,
                                                     make_mesh, split_blocks)

torch.set_num_threads(1)
MESHES = [(2, 2, 1), (2, 2, 2), (1, 2, 4), (4, 2, 1)]
DTYPES = [torch.float32, torch.float64]
N = (32, 24, 32)
DX = 2.4 / 31
H, H1 = 0.1 * DX, 0.05 * DX * DX


def sphere(n, scale=2.0, radius=0.6, noise=0.0, seed=0):
    xs = [np.linspace(-1.2, 1.2, k) for k in n]
    gx, gy, gz = np.meshgrid(*xs, indexing="ij")
    p = scale * (np.sqrt(gx ** 2 + gy ** 2 + gz ** 2) - radius)
    if noise:
        p = p + noise * np.random.default_rng(seed).standard_normal(n)
    return p


def fields(dtype, n=N):
    """A distorted sphere and a sign source that differs from it."""
    return (torch.tensor(sphere(n, noise=0.01), dtype=dtype),
            torch.tensor(sphere(n, radius=0.66, noise=0.01, seed=1),
                         dtype=dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mesh_shape", MESHES)
def test_reinit_block_step_bitwise_equals_solo_plain(mesh_shape, dtype):
    phi, sgn = fields(dtype)
    m = make_mesh(mesh_shape, ["cpu"])
    solo = wc.reinit_step_plain(phi, sgn, DX, H)
    out = sh.reinit_step_local(split_blocks(m, phi), split_blocks(m, sgn),
                               DX, H, gshape=N, mesh=m)
    assert torch.equal(gather_blocks(m, out), solo)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mesh_shape", MESHES)
def test_minmax_block_step_bitwise_equals_solo_plain(mesh_shape, dtype):
    phi = 0.1 * fields(dtype)[0]
    m = make_mesh(mesh_shape, ["cpu"])
    solo = mc.minmax_step_plain(phi, DX, H1)
    assert not torch.equal(solo, phi)
    out = sh.minmax_step_local(split_blocks(m, phi), DX, H1, gshape=N,
                               mesh=m)
    assert torch.equal(gather_blocks(m, out), solo)


@pytest.mark.parametrize("mesh_shape", MESHES)
def test_two_steps_per_exchange_bitwise_equal_two_exchanges(mesh_shape):
    phi, sgn = fields(torch.float32)
    m = make_mesh(mesh_shape, ["cpu"])
    bl, sb = split_blocks(m, phi), split_blocks(m, sgn)
    kw = dict(gshape=N, mesh=m)
    one = sh.reinit_step_local(bl, sb, DX, H, **kw)
    two = sh.reinit_step_local(one, sb, DX, H, **kw)
    k2 = sh.reinit_k_steps_local(bl, sb, DX, H, 2, **kw)
    assert torch.equal(gather_blocks(m, k2), gather_blocks(m, two))
    solo = wc.reinit_step_plain(wc.reinit_step_plain(phi, sgn, DX, H), sgn,
                                DX, H)
    assert torch.equal(gather_blocks(m, k2), solo)


@pytest.mark.parametrize("mesh_shape", MESHES)
def test_owned_range_sums_add_up_to_the_solo_sum(mesh_shape):
    """rms_bounds: with a halo the padded blocks overlap, the sums do not.
    Also the min/max step's."""
    phi, sgn = fields(torch.float32)
    m = make_mesh(mesh_shape, ["cpu"])
    w = sh.sharded_widths(m, 6)
    geoms = sh.reinit_geoms(m, N, w)
    pads = halo_exchange(split_blocks(m, phi), w, m)
    spads = halo_exchange(split_blocks(m, sgn), w, m)
    total = sum(float(wc.reinit_step_block(p, s, DX, H, g,
                                           with_rms=True)[1])
                for p, s, g in zip(pads, spads, geoms))
    solo = float(wc.reinit_step_plain(phi, sgn, DX, H, with_rms=True)[1])
    assert abs(total - solo) <= 1e-12 * solo
    whole = sum(float(wc.reinit_step_block(
        p, s, DX, H, wc.BlockGeom(g.gshape, g.origin, g.brick_origin),
        with_rms=True)[1]) for p, s, g in zip(pads, spads, geoms))
    assert whole > 1.05 * solo          # without bounds: double counting

    w1 = sh.sharded_widths(m, 1)
    mphi = 0.1 * phi
    total = sum(float(mc.minmax_step_block(p, DX, H1, g, with_rms=True)[1])
                for p, g in zip(halo_exchange(split_blocks(m, mphi), w1, m),
                                sh.minmax_geoms(m, N, w1)))
    solo = float(mc.minmax_step_plain(mphi, DX, H1, with_rms=True)[1])
    assert solo > 0 and abs(total - solo) <= 1e-12 * solo


@pytest.mark.parametrize("n,mesh_shape", [((48, 48, 24), (2, 2, 1)),
                                          ((48, 48, 48), (2, 2, 2)),
                                          ((24, 48, 96), (1, 2, 4))])
def test_overlap_steps_bitwise_equal_plain_step(n, mesh_shape):
    """Both overlap forms — the plain one (interior pass + 9-wide slabs)
    and the kernel route's (interior bricks + up to six shell slabs written
    into one output) — give the plain block step's cells bit for bit."""
    phi, sgn = fields(torch.float32, n)
    dx = 2.4 / 47
    m = make_mesh(mesh_shape, ["cpu"])
    bl, sb = split_blocks(m, phi), split_blocks(m, sgn)
    plain = gather_blocks(m, sh.reinit_step_local(bl, sb, dx, H, gshape=n,
                                                  mesh=m))
    assert torch.equal(plain, wc.reinit_step_plain(phi, sgn, dx, H))
    ov = sh.reinit_step_local_overlap(bl, sb, dx, H, gshape=n, mesh=m)
    assert torch.equal(gather_blocks(m, ov), plain)
    s = sh.ShardedLevelSet(m, n, dx, overlap=True)
    assert s.use_overlap
    n_shells = {len(r[1]) for r in s._ranges}
    assert n_shells == {2 * sum(k > 1 for k in mesh_shape)}
    assert torch.equal(gather_blocks(m, s.reinit_step(bl, sb, H)), plain)


def test_tile_ranges_partition_the_brick_grid():
    """Interior + shells cover every brick exactly once, and the interior
    bricks read no halo cell: garbage in the halo does not reach them."""
    n, mesh_shape = (48, 48, 48), (2, 2, 2)
    m = make_mesh(mesh_shape, ["cpu"])
    s = sh.ShardedLevelSet(m, n, 2.4 / 47)
    geom, (inner, shells) = s._rgeoms[0], s._ranges[0]
    pad_shape = tuple(b + 2 * w for b, w in zip(s.block, s.widths))
    count = torch.zeros(pad_shape, dtype=torch.int32)
    for r in [inner, *shells]:
        count += wc._range_cells(geom, pad_shape, r, "cpu").int()
    assert int(count.min()) == int(count.max()) == 1
    phi, sgn = fields(torch.float32, n)
    pads = halo_exchange(split_blocks(m, phi), s.widths, m)
    spads = halo_exchange(split_blocks(m, sgn), s.widths, m)
    kw = dict(tile_range=inner, out=torch.zeros_like(pads[0]))
    good = wc.reinit_step_block(pads[0], spads[0], s.dx, H, geom, **kw)
    dirty = pads[0].clone()
    own = tuple(slice(w, w + b) for w, b in zip(s.widths, s.block))
    mask = torch.ones(pad_shape, dtype=torch.bool)
    mask[own] = False
    dirty[mask] = float("nan")
    kw["out"] = torch.zeros_like(pads[0])
    assert torch.equal(wc.reinit_step_block(dirty, spads[0], s.dx, H, geom,
                                            **kw), good)
    with pytest.raises(ValueError):
        geom.ints(pad_shape, ((0, 0, 0), (99, 1, 1)))
    rec = list(geom.ints(pad_shape, inner))
    assert rec[:3] == list(n) and rec[3:6] == [-4, -4, -4]
    assert rec[6:9] == [-4, -4, -4] and rec[9:12] == [5, 5, 5]
    assert rec[12:15] == list(inner[0]) and rec[21:24] == list(inner[1])
    assert rec[15:21] == [0, 24, 0, 24, 0, 24]


def test_brick_mask_with_an_origin_equals_solo_mask_on_aligned_blocks():
    """Blocks of 24 = 3 bricks with a halo of 4: the owned bricks of every
    shard are the solo grid's bricks, and their band4 windows see the
    neighbours' cells across the seams; then one banded sharded step is
    bitwise the solo banded step."""
    n, dx = (48, 48, 24), 2.4 / 47
    phi = torch.tensor(sphere(n, radius=0.4), dtype=torch.float32)
    m = make_mesh((2, 2, 1), ["cpu"])
    s = sh.ShardedLevelSet(m, n, dx, narrow_band=True, band_radius=3.1)
    solo_mask = wc.tile_activity(phi, dx, 3.1, H / dx, window="band4")
    assert 0 < int(solo_mask.sum()) < solo_mask.numel()
    pads = halo_exchange(split_blocks(m, phi), s.widths, m)
    for off, p, g in zip(local_offsets(m, s.block), pads, s._rgeoms):
        act = wc.tile_activity(p, dx, 3.1, H / dx, window="band4", geom=g)
        assert tuple(act.shape) == (5, 5, 3)
        ref = solo_mask[off[0] // 8:off[0] // 8 + 3,
                        off[1] // 8:off[1] // 8 + 3]
        assert torch.equal(act[1:4, 1:4], ref)
    out, it, _ = s.reinit(split_blocks(m, phi), H, 1, 0.0)
    solo = wc.reinit_step_plain(phi, phi, dx, H, active=solo_mask)
    assert it == 1 and torch.equal(gather_blocks(m, out), solo)
    assert not torch.equal(solo, wc.reinit_step_plain(phi, phi, dx, H))


def test_unwritten_cells_keep_the_output_and_faces_stay_in_grid():
    """A cell whose stencil leaves the padded array is not written; halo
    cells past a global face are never read: poisoning them changes
    nothing, not even through the first-order path at global index 1."""
    phi, sgn = fields(torch.float32)
    m = make_mesh((2, 2, 2), ["cpu"])
    w = sh.sharded_widths(m, 4)
    geoms = sh.reinit_geoms(m, N, w)
    pads = halo_exchange(split_blocks(m, phi), w, m)
    spads = halo_exchange(split_blocks(m, sgn), w, m)
    p, s, g = pads[0], spads[0], geoms[0]        # the (0, 0, 0) corner
    out = wc.reinit_step_block(p, s, DX, H, g, out=torch.full_like(p, 7.0))
    assert bool((out[:4] == 7.0).all())          # past the global face
    assert bool((out[-1] == 7.0).all())          # stencil leaves the array
    assert bool((out[-3:, 8:-3, 8:-3] == 7.0).all())   # ... by WENO's +3
    assert bool((out[-3:-1, 5:8, 8:-3] != 7.0).all())  # first order: +1
    assert bool((out[4:-3, 4:-3, 4:-3] != 7.0).all())
    poisoned = p.clone()
    poisoned[:4] = float("nan")
    poisoned[:, :4] = float("nan")
    poisoned[:, :, :4] = float("nan")
    again = wc.reinit_step_block(poisoned, s, DX, H, g,
                                 out=torch.full_like(p, 7.0))
    assert torch.equal(crop(again, w), crop(out, w))


def _jax_solver(devices, n, dx, **kw):
    s = JaxShardedLevelSet(jax_make_mesh((2, 2, 1), devices[:4]), n, dx,
                           use_pallas=True, **kw)
    assert s.use_pallas
    return s


def test_reinit_block_step_matches_jax_pallas_block_step(eight_devices):
    """K1's block mode against the TPU kernel with ``offsets`` (interpret
    mode, (2,2,1) virtual devices), one step: 1e-6."""
    n, dx = (32, 32, 16), 2.4 / 31
    p0 = sphere(n).astype(np.float32)
    s = _jax_solver(eight_devices, n, dx)
    ref, it, _ = s.reinit(s.device_put(jnp.asarray(p0)), 0.1 * dx, 1, 0.0)
    m = make_mesh((2, 2, 1), ["cpu"])
    bl = split_blocks(m, torch.tensor(p0))
    out = sh.reinit_step_local(bl, bl, dx, 0.1 * dx, gshape=n, mesh=m)
    d = np.abs(gather_blocks(m, out).numpy()
               - np.asarray(jax.device_get(ref))).max()
    assert int(it) == 1 and d <= 1e-6, d


def test_minmax_block_step_matches_jax_pallas_block_step(eight_devices):
    """K3's block mode against the TPU kernel with ``offsets``: 1e-7 (the
    band stays off the global faces, ROADMAP H4)."""
    n, dx = (32, 32, 16), 2.4 / 31
    p0 = sphere(n, scale=1.0).astype(np.float32)
    h1 = 0.05 * dx * dx
    s = _jax_solver(eight_devices, n, dx)
    ref, it, _ = s.minmax_flow(s.device_put(jnp.asarray(p0)), h1, 1, 0.0)
    m = make_mesh((2, 2, 1), ["cpu"])
    out = sh.minmax_step_local(split_blocks(m, torch.tensor(p0)), dx, h1,
                               gshape=n, mesh=m)
    got = gather_blocks(m, out).numpy()
    assert np.abs(got - p0).max() > 0
    d = np.abs(got - np.asarray(jax.device_get(ref))).max()
    assert int(it) == 1 and d <= 1e-7, d
