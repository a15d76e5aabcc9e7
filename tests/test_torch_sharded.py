"""``ShardedLevelSet`` and ``advect_nodes_sharded`` of the port against the
JAX package's on virtual CPU devices and against the port's own solo
solvers.

Against the solo solvers (the same plain step per cell): fields BITWISE,
counts equal, the RMS to 1e-12 relative (another summation order).  Against
the JAX package: counts equal, fields within 2e-6 after 4 reinit and 5
min/max steps (the JAX tests' own gate against its single-device solver;
measured 2.4e-7 and 3.0e-8, on its Pallas-interpret and its jnp route
alike), the RMS within 1e-4 relative (measured 4.9e-7), advected nodes
within 2e-6 (measured 1.2e-7, residual phi 2.5e-7).  The sharded narrow band
refreshes its mask every exchange (the solo one every chunk), so it is held
against the sharded dense run in the band, as the JAX package's test does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from levelsetfortran_tpu.grid.grid import Grid3D as JaxGrid3D
from levelsetfortran_tpu.parallel.mesh import make_mesh as jax_make_mesh
from levelsetfortran_tpu.parallel.sharded import \
    ShardedLevelSet as JaxShardedLevelSet
from levelsetfortran_tpu.parallel.sharded import \
    advect_nodes_sharded as jax_advect_nodes_sharded
from levelsetfortran_tpu_torch.grid.grid import Grid3D
from levelsetfortran_tpu_torch.parallel import sharded as sh
from levelsetfortran_tpu_torch.parallel.mesh import make_mesh
from levelsetfortran_tpu_torch.solvers.advect import advect_nodes
from levelsetfortran_tpu_torch.solvers.minmax_flow import minmax_flow
from levelsetfortran_tpu_torch.solvers.reinit import reinit

torch.set_num_threads(1)


def sphere(n, scale=2.0, radius=0.6):
    xs = [np.linspace(-1.2, 1.2, k) for k in n]
    gx, gy, gz = np.meshgrid(*xs, indexing="ij")
    return (scale * (np.sqrt(gx ** 2 + gy ** 2 + gz ** 2)
                     - radius)).astype(np.float32)


def _solver(mesh_shape, n, dx, **kw):
    return sh.ShardedLevelSet(make_mesh(mesh_shape, ["cpu"]), n, dx, **kw)


@pytest.mark.parametrize("mesh_shape,kw", [
    ((2, 2, 1), {}), ((2, 2, 2), {}), ((4, 2, 1), {}),
    ((2, 2, 1), {"steps_per_exchange": 2}),
    ((2, 2, 2), {"steps_per_exchange": 2}),
    ((2, 2, 1), {"overlap": True})])
def test_reinit_bitwise_equals_solo_solver(mesh_shape, kw):
    n, dx = (48, 48, 16), 2.4 / 47
    phi, h = torch.tensor(sphere(n)), 0.1 * 2.4 / 47
    s = _solver(mesh_shape, n, dx, **kw)
    assert s.use_overlap == bool(kw.get("overlap"))
    out, it, rms = s.reinit(s.device_put(phi), h, 4, 0.0)
    ref = reinit(phi, dx, h, 4, 0.0)
    assert it == ref.iterations == 4
    assert torch.equal(s.gather(out), ref.phi)
    assert rms == pytest.approx(ref.final_rms, rel=1e-12)


@pytest.mark.parametrize("narrow_band", [False, True])
@pytest.mark.parametrize("mesh_shape", [(2, 2, 1), (2, 2, 2)])
def test_minmax_flow_bitwise_equals_solo_solver(mesh_shape, narrow_band):
    """Banded or dense: the update gate is the cell's own value, so
    freezing bricks with no in-band cell changes nothing."""
    n, dx = (32, 32, 16), 2.4 / 31
    phi, h1 = torch.tensor(sphere(n, scale=1.0)), 0.05 * (2.4 / 31) ** 2
    s = _solver(mesh_shape, n, dx, narrow_band=narrow_band)
    out, it, rms = s.minmax_flow(s.device_put(phi), h1, 6, 0.0)
    ref = minmax_flow(phi, dx, h1, 6, 0.0)
    assert it == ref.iterations == 6
    assert torch.equal(s.gather(out), ref.phi)
    assert not torch.equal(ref.phi, phi)
    assert rms == pytest.approx(ref.final_rms, rel=1e-12)


@pytest.mark.parametrize("k", [1, 2])
def test_stop_test_takes_the_solo_solvers_counts(k):
    """With a tolerance the sharded solve stops where the solo one does
    (k = 1), or at the next multiple of k: the RMS differs only in the
    last bits (1e-12 relative), far from the tolerances here."""
    n, dx = (32, 32, 16), 2.4 / 31
    phi, h = torch.tensor(sphere(n, scale=1.2)), 0.1 * 2.4 / 31
    s = _solver((2, 2, 1), n, dx, steps_per_exchange=k)
    ref = reinit(phi, dx, h, 100, 2e-3)
    assert 2 < ref.iterations < 100
    out, it, rms = s.reinit(s.device_put(phi), h, 100, 2e-3)
    assert it == -(-ref.iterations // k) * k
    if k == 1:
        assert torch.equal(s.gather(out), ref.phi)
    mref = minmax_flow(ref.phi, dx, 0.05 * dx * dx, 100, 4.5e-4)
    assert 2 < mref.iterations < 100
    mout, mit, _ = s.minmax_flow(s.device_put(ref.phi), 0.05 * dx * dx, 100,
                                 4.5e-4)
    assert mit == mref.iterations and torch.equal(s.gather(mout), mref.phi)


@pytest.mark.parametrize("mesh_shape,kw,pallas", [
    ((2, 2, 1), {}, True), ((2, 2, 1), {"steps_per_exchange": 2}, True),
    ((2, 2, 2), {}, False), ((2, 2, 2), {"overlap": True}, False)])
def test_reinit_and_minmax_match_jax_sharded_solver(eight_devices,
                                                    mesh_shape, kw, pallas):
    n, dx = (32, 64, 16), 2.4 / 31
    p0, h, h1 = sphere(n), 0.1 * 2.4 / 31, 0.05 * (2.4 / 31) ** 2
    nd = int(np.prod(mesh_shape))
    js = JaxShardedLevelSet(jax_make_mesh(mesh_shape, eight_devices[:nd]),
                            n, dx, use_pallas=pallas, **kw)
    assert js.use_pallas == pallas
    jr, jit_, jrms = js.reinit(js.device_put(jnp.asarray(p0)), h, 4, 0.0)
    s = _solver(mesh_shape, n, dx, **kw)
    out, it, rms = s.reinit(s.device_put(p0), h, 4, 0.0)
    assert it == int(jit_) == 4
    jr = np.asarray(jax.device_get(jr))
    np.testing.assert_allclose(s.gather(out).numpy(), jr, rtol=0, atol=2e-6)
    assert rms == pytest.approx(float(jrms), rel=1e-4)
    jm, jmit, _ = js.minmax_flow(js.device_put(jnp.asarray(0.5 * jr)), h1,
                                 5, 0.0)
    mout, mit, _ = s.minmax_flow(s.device_put(0.5 * jr), h1, 5, 0.0)
    assert mit == int(jmit) == 5
    np.testing.assert_allclose(s.gather(mout).numpy(),
                               np.asarray(jax.device_get(jm)), rtol=0,
                               atol=2e-6)


@pytest.mark.parametrize("mesh_shape,k", [((4, 2, 1), 1), ((2, 1, 1), 2)])
def test_narrowband_matches_dense_in_band(mesh_shape, k):
    """In-band cells equal the dense sharded solve (gate 5e-6, the JAX
    test's; measured 0), far cells are frozen or dense (gate 2e-5, measured
    3.5e-6), and freezing does occur (41% of the far cells)."""
    n = (96, 32, 16)
    xs = [np.linspace(-1, 1, m) for m in n]
    gx, gy, gz = np.meshgrid(*xs, indexing="ij")
    p0 = (np.sqrt(gx ** 2 + (0.3 * gy) ** 2 + (0.3 * gz) ** 2)
          - 0.3).astype(np.float32)
    dx = 2.0 / (n[0] - 1)
    h, band = 0.1 * dx, 8.1
    dense = _solver(mesh_shape, n, dx, steps_per_exchange=k)
    nb = _solver(mesh_shape, n, dx, steps_per_exchange=k, narrow_band=True,
                 band_radius=band)
    d, it_d, _ = dense.reinit(dense.device_put(p0), h, 4, 0.0)
    b, it_n, _ = nb.reinit(nb.device_put(p0), h, 4, 0.0)
    assert it_d == it_n == 4
    d, b = dense.gather(d).numpy(), nb.gather(b).numpy()
    in_band = np.abs(p0) < band * dx
    np.testing.assert_allclose(b[in_band], d[in_band], rtol=0, atol=5e-6)
    # a frozen brick's global-face cells still take the ghost BC: p0 + dx
    resid = np.minimum(np.abs(b - d), np.abs(b - p0))[1:-1, 1:-1, 1:-1]
    assert resid[~in_band[1:-1, 1:-1, 1:-1]].max() < 2e-5
    assert np.any(b[~in_band] == p0[~in_band])


def _advection_case():
    n, dx = (32, 32, 16), 0.1
    origin = (-1.55, -1.55, -0.75)
    axes = [o + dx * np.arange(k) for o, k in zip(origin, n)]
    gx, gy, gz = np.meshgrid(*axes, indexing="ij")
    phi = (np.sqrt(gx ** 2 + gy ** 2 + gz ** 2) - 0.6).astype(np.float32)
    rng = np.random.default_rng(0)
    d = rng.normal(size=(40, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[:, 2] *= 0.4
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return n, dx, origin, phi, (0.66 * d).astype(np.float32)


@pytest.mark.parametrize("mesh_shape", [(4, 2, 1), (2, 2, 2), (1, 1, 1)])
def test_advect_nodes_sharded_bitwise_equals_solo(mesh_shape):
    """The owner's sample plus the other shards' zeros: the solo
    advection's positions bit for bit, nodes on seams included."""
    n, dx, origin, phi, nodes = _advection_case()
    grid = Grid3D(shape=n, origin=origin, dx=dx)
    nodes[0] = (0.05, 0.05, 0.6)        # base cell on an x and a y seam
    ref = advect_nodes(torch.tensor(phi), grid, torch.tensor(nodes), dx,
                       iters=30)
    s = _solver(mesh_shape, n, dx)
    out = sh.advect_nodes_sharded(s.mesh, s.device_put(phi), grid,
                                  torch.tensor(nodes), dx, iters=30)
    assert torch.equal(out.positions, ref.positions)
    assert torch.equal(out.phi_surf, ref.phi_surf)
    assert float((ref.positions - torch.tensor(nodes)).abs().max()) > 1e-3


def test_advect_nodes_sharded_matches_jax(eight_devices):
    n, dx, origin, phi, nodes = _advection_case()
    jmesh = jax_make_mesh((2, 2, 2), eight_devices)
    phi_s = jax.device_put(jnp.asarray(phi), jax.sharding.NamedSharding(
        jmesh, jax.sharding.PartitionSpec("x", "y", "z")))
    ref = jax_advect_nodes_sharded(
        jmesh, phi_s, JaxGrid3D(shape=n, origin=origin, dx=dx),
        jnp.asarray(nodes), dx, iters=30)
    s = _solver((2, 2, 2), n, dx)
    out = sh.advect_nodes_sharded(
        s.mesh, s.device_put(phi), Grid3D(shape=n, origin=origin, dx=dx),
        torch.tensor(nodes), dx, iters=30)
    np.testing.assert_allclose(out.positions.numpy(),
                               np.asarray(jax.device_get(ref.positions)),
                               rtol=0, atol=2e-6)
    np.testing.assert_allclose(out.phi_surf.numpy(),
                               np.asarray(jax.device_get(ref.phi_surf)),
                               rtol=0, atol=2e-6)


def test_reinit_step_with_another_sign_source():
    n, dx = (32, 32, 16), 2.4 / 31
    phi, sgn = torch.tensor(sphere(n)), torch.tensor(sphere(n, radius=0.7))
    s = _solver((2, 2, 1), n, dx)
    one = s.reinit_step(s.device_put(phi), s.device_put(sgn), 0.1 * dx)
    ref = reinit(phi, dx, 0.1 * dx, 1, 0.0, sign_src=sgn)
    assert torch.equal(s.gather(one), ref.phi)


@pytest.mark.parametrize("args,kw,match", [
    (((2, 2, 1), (33, 32, 16)), {}, "not divisible"),
    (((2, 2, 4), (32, 32, 12)), {}, "need >= 4"),
    (((2, 2, 1), (32, 10, 16)), {"steps_per_exchange": 2}, "need >= 6"),
    (((2, 2, 1), (32, 32, 16)), {"steps_per_exchange": 0}, ">= 1")])
def test_constructor_errors(args, kw, match):
    with pytest.raises(ValueError, match=match):
        _solver(*args, 0.1, **kw)


def test_auto_mesh_device_put_and_overlap_without_interior_bricks():
    m = sh.ShardedLevelSet.auto_mesh(devices=["cpu"])
    assert m.shape == (1, 1, 1)
    s = _solver((2, 2, 1), (32, 32, 16), 0.1, overlap=True)
    assert not s.use_overlap        # blocks of 16: every brick is shell
    with pytest.raises(ValueError):
        s.device_put(np.zeros((32, 32, 8), np.float32))
    blocks = s.device_put(np.zeros((32, 32, 16), np.float32))
    assert len(blocks) == 4 and blocks[0].shape == (16, 16, 16)
