"""Kernels K3/K4's plain versions against the JAX package's Pallas kernels
in interpret mode and its jnp step, and the port's min/max solvers.

Tolerances: float32 atol 1e-7 per step (the band stays off the faces, where
the TPU kernel clamps and the jnp path wraps; the port reads nothing
outside the grid); K4 against K launches of K3 and the banded solver
against the dense one bitwise; float64 solvers against the JAX jnp solver
atol 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from levelsetfortran_tpu.ops import minmax_pallas as mp
from levelsetfortran_tpu.solvers.minmax_flow import minmax_flow as j_flow
from levelsetfortran_tpu_torch.ops import minmax_cuda as mc
from levelsetfortran_tpu_torch.ops.weno_cuda import brick_grid, tile_activity
from levelsetfortran_tpu_torch.solvers.minmax_flow import (
    minmax_flow, minmax_flow_narrowband)

torch.set_num_threads(1)


def _sdf(shape, radius=0.45, dtype=np.float32):
    """A bumpy sphere whose band (|phi| < 4.1 dx) stays off the faces."""
    xs = [np.linspace(-1, 1, k) for k in shape]
    gx, gy, gz = np.meshgrid(*xs, indexing="ij")
    phi = np.sqrt(gx ** 2 + 1.2 * gy ** 2 + gz ** 2) - radius
    phi += 0.02 * np.sin(7 * gx) * np.cos(5 * gz)
    return phi.astype(dtype), 2.0 / (shape[0] - 1)


def _jax_args(dx, h1):
    return (jnp.float32(dx), jnp.float32(h1), jnp.float32(4.1),
            jnp.float32(0.0))


@pytest.mark.parametrize("shape", [(32, 30, 28), (29, 23, 19)])
def test_plain_step_matches_pallas_interpret_and_jnp(shape):
    phi, dx = _sdf(shape)
    h1 = 0.05 * dx * dx
    tile = mp._pick_tile(shape)
    pad = mp.pad_for_pallas(jnp.asarray(phi), tile)
    ref, ref_dsq = mp.minmax_step_padded(pad, *_jax_args(dx, h1),
                                         gshape=shape, tile=tile,
                                         interpret=True, with_rms=True)
    ref = np.asarray(mp.crop_from_pallas(ref, shape))
    jnp_ref = np.asarray(mp._jnp_step(jnp.asarray(phi), jnp.float32(dx),
                                      jnp.float32(h1), 4.1, 0.0))
    t = torch.from_numpy(phi)
    out, dsq = mc.minmax_step(t, dx, h1, with_rms=True)
    assert float(torch.max(torch.abs(out - t))) > 0      # something moved
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-7)
    np.testing.assert_allclose(out.numpy(), jnp_ref, rtol=0, atol=1e-7)
    assert float(dsq) == pytest.approx(float(ref_dsq), rel=1e-5)


@pytest.mark.parametrize("ksteps", [1, 2, 3, 4])
def test_plain_fusedk_matches_pallas_interpret(ksteps):
    shape = (32, 32, 24)
    phi, dx = _sdf(shape)
    h1 = 0.05 * dx * dx
    tile = mp._pick_fusedk_tile(shape)
    pad = mp.pad_for_pallas(jnp.asarray(phi), tile)
    ref, ref_dsq = mp.minmax_fusedk_padded(pad, *_jax_args(dx, h1),
                                           gshape=shape, tile=tile,
                                           interpret=True, ksteps=ksteps,
                                           with_rms=True)
    out, dsq = mc.minmax_fusedk(torch.from_numpy(phi), dx, h1,
                                ksteps=ksteps, with_rms=True)
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(mp.crop_from_pallas(ref, shape)),
                               rtol=0, atol=1e-7)
    assert float(dsq) == pytest.approx(float(ref_dsq), rel=1e-5)


@pytest.mark.parametrize("ksteps", [1, 2, 3, 4])
@pytest.mark.parametrize("mask", ["dense", "owned"])
def test_fusedk_equals_k_single_steps_bitwise(ksteps, mask):
    phi, dx = _sdf((33, 27, 21))
    t = torch.from_numpy(phi)
    h1 = 0.2 * dx * dx
    active = None if mask == "dense" else tile_activity(t, dx, 4.1,
                                                        window="owned")
    if active is not None:
        assert 0 < int(active.sum()) < active.numel()
    fused, fdsq = mc.minmax_fusedk(t, dx, h1, ksteps=ksteps, active=active,
                                   with_rms=True)
    q = t
    for _ in range(ksteps):
        q, qdsq = mc.minmax_step(q, dx, h1, active=active, with_rms=True)
    assert torch.equal(fused, q)
    assert float(fdsq) == float(qdsq)
    # carry mode: the out buffer holds the frozen values already
    if active is not None:
        carry = mc.minmax_fusedk(t, dx, h1, ksteps=ksteps, active=active,
                                 out=t.clone(), mint=False)
        assert torch.equal(carry, fused)


def test_banded_step_freezes_inactive_bricks():
    phi, dx = _sdf((24, 24, 24))
    t = torch.from_numpy(phi)
    h1 = 0.2 * dx * dx
    rng = np.random.default_rng(0)
    active = torch.from_numpy(
        (rng.random(brick_grid(t.shape)) < 0.5).astype(np.int32))
    from levelsetfortran_tpu_torch.ops.weno_cuda import brick_cells
    cells = brick_cells(active, t.shape)
    out = mc.minmax_step(t, dx, h1, active=active)
    dense = mc.minmax_step(t, dx, h1)
    assert torch.equal(out[cells], dense[cells])
    assert torch.equal(out[~cells], t[~cells])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("iters", [25, 12, 41])
def test_narrowband_flow_equals_dense_bitwise(dtype, iters):
    phi, dx = _sdf((40, 34, 30), radius=0.35, dtype=dtype)
    t = torch.from_numpy(phi)
    h1 = 0.01 * dx * dx * 20
    dense = minmax_flow(t, dx, h1, iters, 0.0)
    banded = minmax_flow_narrowband(t, dx, h1, iters, 0.0, refresh_every=16)
    assert banded.iterations == dense.iterations == iters
    assert torch.equal(banded.phi, dense.phi)
    assert banded.final_rms == pytest.approx(dense.final_rms, rel=1e-12)
    assert torch.equal(t, torch.from_numpy(phi))      # input untouched


def test_narrowband_flow_stops_at_tolerance():
    phi, dx = _sdf((40, 34, 30), radius=0.35)
    t = torch.from_numpy(phi)
    h1 = 0.2 * dx * dx
    loose = minmax_flow_narrowband(t, dx, h1, 200, 1e-3)
    assert loose.iterations % 20 == 0 and loose.final_rms < 1e-3
    assert minmax_flow_narrowband(t, dx, h1, 0, 0.0).iterations == 0


@pytest.mark.parametrize("solver", ["dense", "narrowband"])
def test_float64_solvers_match_jax_jnp_solver(solver):
    phi, dx = _sdf((36, 32, 28), radius=0.4, dtype=np.float64)
    h1 = 0.01 * dx * dx * 20
    ref = j_flow(jnp.asarray(phi), dx, h1, 25, 0.0, use_pallas=False)
    fn = minmax_flow if solver == "dense" else minmax_flow_narrowband
    res = fn(torch.from_numpy(phi), dx, h1, 25, 0.0)
    assert res.iterations == int(ref.iterations)
    np.testing.assert_allclose(res.phi.numpy(), np.asarray(ref.phi),
                               rtol=0, atol=1e-12)
    assert res.final_rms == pytest.approx(float(ref.final_rms), rel=1e-6)


def test_other_halfwidths_run_the_whole_grid_step():
    phi, dx = _sdf((24, 24, 24), dtype=np.float64)
    h1 = 0.01 * dx * dx
    ref = j_flow(jnp.asarray(phi), dx, h1, 4, 0.0, avg_halfwidth=2,
                 use_pallas=False)
    res = minmax_flow(torch.from_numpy(phi), dx, h1, 4, 0.0,
                      avg_halfwidth=2)
    np.testing.assert_allclose(res.phi.numpy(), np.asarray(ref.phi),
                               rtol=0, atol=1e-12)
