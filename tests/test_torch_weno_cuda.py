"""Kernel K1's plain version (the function the CUDA kernel computes) against
the JAX package's Pallas kernel in interpret mode and its jnp step, the
banded modes, and the brick activity mask.

Tolerances: float32 atol 1e-6 on unit-scale SDFs (~1 ulp at |phi| ~ 2-4:
the two frameworks round the same expressions); the fused sum of squared
changes rel 1e-5 (f32 accumulation in the TPU kernel, f64 here); float64
atol 1e-12 against the jnp step (raw differences vs differences / dx).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from levelsetfortran_tpu.ops import weno_pallas as wp
from levelsetfortran_tpu_torch.ops import weno_cuda as wc
from levelsetfortran_tpu_torch.solvers.reinit import (reinit,
                                                      reinit_narrowband)

torch.set_num_threads(1)
DX, H = 0.05, 0.005


def _field(shape, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    xs = [np.linspace(-1, 1, k) for k in shape]
    gx, gy, gz = np.meshgrid(*xs, indexing="ij")
    phi = np.sqrt(gx ** 2 + gy ** 2 + gz ** 2) - 0.5
    return (2.0 * phi + 0.01 * rng.standard_normal(shape)).astype(dtype)


def _jax_kernel_step(phi, quirk):
    shape = phi.shape
    tile = wp._pick_tile(shape)
    pad = wp.pad_for_pallas(jnp.asarray(phi), tile)
    out, dsq = wp._pallas_step_padded(
        pad, pad, jnp.float32(DX), jnp.float32(H), gshape=shape,
        eps_scale=1e-6, eps_floor=1e-18, quirk_y_p5_zero=quirk, tile=tile,
        interpret=True, with_rms=True)
    return np.asarray(wp.crop_from_pallas(out, shape)), float(dsq)


@pytest.mark.parametrize("shape", [(24, 20, 16), (19, 13, 11)])
@pytest.mark.parametrize("quirk", [False, True])
def test_plain_step_matches_pallas_interpret_and_jnp(shape, quirk):
    phi = _field(shape)
    ref, ref_dsq = _jax_kernel_step(phi, quirk)
    jnp_ref = np.asarray(wp._reinit_step_jnp(
        jnp.asarray(phi), jnp.asarray(phi), jnp.float32(DX), jnp.float32(H),
        1e-6, 1e-18, quirk))
    t = torch.from_numpy(phi)
    out, dsq = wc.reinit_step(t, t, DX, H, quirk_y_p5_zero=quirk,
                              with_rms=True)
    assert out.dtype == torch.float32 and dsq.dtype == torch.float64
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(out.numpy(), jnp_ref, rtol=0, atol=1e-6)
    assert float(dsq) == pytest.approx(ref_dsq, rel=1e-5)
    # the wrapper on a CPU tensor IS the plain version
    assert torch.equal(out, wc.reinit_step_plain(t, t, DX, H,
                                                 quirk_y_p5_zero=quirk))


@pytest.mark.parametrize("shape", [(24, 20, 16), (19, 13, 11)])
def test_float64_matches_jnp_step(shape):
    phi = _field(shape, seed=1, dtype=np.float64)
    ref = np.asarray(wp._reinit_step_jnp(
        jnp.asarray(phi), jnp.asarray(phi), jnp.float64(DX),
        jnp.float64(H), 1e-6, 1e-99, False))
    t = torch.from_numpy(phi)
    np.testing.assert_allclose(wc.reinit_step(t, t, DX, H).numpy(), ref,
                               rtol=0, atol=1e-12)


def _random_mask(shape, seed):
    nb = wc.brick_grid(shape)
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.random(nb) < 0.5).astype(np.int32))


@pytest.mark.parametrize("shape", [(24, 20, 16), (19, 13, 11), (33, 17, 9)])
def test_banded_step_semantics(shape):
    """Interior cells of active bricks take the dense step, interior cells
    of frozen bricks keep the input, and every face cell is its clamped
    inner neighbour's new value + dx — bitwise, in mint and carry mode."""
    phi = torch.from_numpy(_field(shape, seed=2))
    sign = torch.from_numpy(_field(shape, seed=3))
    active = _random_mask(shape, 4)
    cells = wc.brick_cells(active, shape)
    assert 0 < int(active.sum()) < active.numel()
    dense = wc.reinit_step(phi, sign, DX, H)
    mint = wc.reinit_step(phi, sign, DX, H, active=active)
    interior = torch.zeros(shape, dtype=torch.bool)
    interior[1:-1, 1:-1, 1:-1] = True
    assert torch.equal(mint[interior & cells], dense[interior & cells])
    assert torch.equal(mint[interior & ~cells], phi[interior & ~cells])
    dxf = float(np.float32(DX))
    inner = mint[np.ix_(*[np.clip(np.arange(n), 1, n - 2) for n in shape])]
    assert torch.equal(mint[~interior], (inner + dxf)[~interior])
    # carry: the out buffer already holds the frozen values
    carry = wc.reinit_step(phi, sign, DX, H, active=active,
                           out=phi.clone(), mint=False)
    assert torch.equal(carry, mint)
    # all bricks active == dense
    full = torch.ones_like(active)
    assert torch.equal(wc.reinit_step(phi, sign, DX, H, active=full), dense)


def _brute_activity(phi, dx, thresh_cells, dilate):
    a = np.abs(phi)
    nb = wc.brick_grid(phi.shape)
    out = np.zeros(nb, np.int32)
    b = wc.BRICK
    for i in range(nb[0]):
        for j in range(nb[1]):
            for k in range(nb[2]):
                win = a[max(0, i * b - dilate):(i + 1) * b + dilate,
                        max(0, j * b - dilate):(j + 1) * b + dilate,
                        max(0, k * b - dilate):(k + 1) * b + dilate]
                out[i, j, k] = win.min() < np.float32(thresh_cells) * \
                    np.float32(dx)
    return out


@pytest.mark.parametrize("window,dilate", [("owned", 0), ("band4", 4)])
@pytest.mark.parametrize("shape", [(40, 27, 19), (30, 12, 25)])
def test_tile_activity_matches_brute_force(window, dilate, shape):
    xs = [np.arange(n) * 0.05 for n in shape]
    gx, gy, gz = np.meshgrid(*xs, indexing="ij")
    phi = (np.sqrt((gx - 0.4) ** 2 + (gy - 0.3) ** 2 + gz ** 2)
           - 0.25).astype(np.float32)
    act = wc.tile_activity(torch.from_numpy(phi), 0.05, 4.1, 0.5,
                           window=window)
    assert act.dtype == torch.int32
    ref = _brute_activity(phi, 0.05, 4.6, dilate)
    np.testing.assert_array_equal(act.numpy(), ref)
    assert 0 < ref.sum() < ref.size


def test_narrowband_solver_matches_dense_in_band():
    """On a near-converged SDF the banded solve equals the dense one in
    the band (a frozen brick lies >= 4 cells plus the drift margin away),
    and iterations advance in whole chunks."""
    shape = (48, 40, 32)
    xs = [(np.arange(n) - 10) * 0.05 for n in shape]
    gx, gy, gz = np.meshgrid(*xs, indexing="ij")
    phi0 = torch.from_numpy(
        (np.sqrt(gx ** 2 + gy ** 2 + gz ** 2) - 0.3).astype(np.float32))
    dense = reinit(phi0, 0.05, 0.005, 9, 0.0)
    nb = reinit_narrowband(phi0, 0.05, 0.005, 7, 0.0, band_radius=8.1,
                           refresh_every=8)
    assert nb.iterations == 9 and dense.iterations == 9 and not nb.diverged
    band = phi0.abs() < 8.1 * 0.05
    assert torch.equal(nb.phi[band], dense.phi[band])
    assert torch.equal(phi0, torch.from_numpy(
        (np.sqrt(gx ** 2 + gy ** 2 + gz ** 2) - 0.3).astype(np.float32)))
    active = wc.tile_activity(phi0, 0.05, 8.1, 9 * 0.005 / 0.05)
    assert 0 < int(active.sum()) < active.numel()
