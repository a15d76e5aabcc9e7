"""Kernel K5's plain version (the VJP of one reinit step, as the CUDA
kernel computes it) against the JAX package: ``jax.vjp`` of the jnp step
and the Pallas adjoint kernel in interpret mode.

Tolerances: float32 at the JAX package's own Pallas-vs-jnp gate (atol 2e-4,
rtol 1e-3, ``tests/test_pallas.py:140-143``), scalar cotangents rtol 2e-3
(the TPU kernel sums them in f32 tile by tile, the port in f64); float64
at 1e-10 on fields without exact ties (the only difference is the
summation order).  Measured: f64 1.6e-15 absolute; f32 against the Pallas
kernel 9.5e-7 on max |cot| ~5 (gate 2e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from levelsetfortran_tpu.ops import weno_pallas as wp
from levelsetfortran_tpu_torch.ops import weno_cuda as wc

torch.set_num_threads(1)
DX, H = 0.05, 0.005


def _field(shape, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    xs = [np.linspace(-1, 1, k) for k in shape]
    gx, gy, gz = np.meshgrid(*xs, indexing="ij")
    phi = np.sqrt(gx ** 2 + gy ** 2 + gz ** 2) - 0.5
    return (2.0 * phi + 0.01 * rng.standard_normal(shape)).astype(dtype)


def _jnp_vjp(phi, sgn, g, quirk=False):
    """jax.vjp of the jnp step w.r.t. (phi, sign, dx, h)."""
    f64 = phi.dtype == np.float64
    jt = jnp.float64 if f64 else jnp.float32
    ef = 1e-99 if f64 else 1e-18

    def step(p, s, d, hh):
        return wp._reinit_step_jnp(p, s, d, hh, 1e-6, ef, quirk)

    _, vjp = jax.vjp(step, jnp.asarray(phi), jnp.asarray(sgn), jt(DX), jt(H))
    return [np.asarray(c) for c in vjp(jnp.asarray(g))]


def _port_vjp(phi, sgn, g, quirk=False):
    res = wc.reinit_step_vjp(torch.from_numpy(phi), torch.from_numpy(sgn),
                             torch.from_numpy(g), DX, H,
                             quirk_y_p5_zero=quirk)
    return [r.numpy() for r in res]


@pytest.mark.parametrize("quirk", [False, True])
def test_float64_matches_jnp_vjp(quirk):
    shape = (14, 12, 11)
    phi, sgn = _field(shape, 0, np.float64), _field(shape, 1, np.float64)
    g = np.random.default_rng(2).standard_normal(shape)
    ref = _jnp_vjp(phi, sgn, g, quirk)
    out = _port_vjp(phi, sgn, g, quirk)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-10 * max(
            1.0, np.abs(b).max()))


@pytest.mark.parametrize("shape", [(14, 12, 11), (3, 9, 10)])
def test_face_cotangents_reach_corners(shape):
    """Cotangent on the faces only: the ghost-BC transpose gathers each
    face cell's g onto its clamped inner neighbour (up to 7 at a grid
    corner, up to 27 on an axis of 3 points), and every face adds to
    cot_dx."""
    phi, sgn = _field(shape, 3, np.float64), _field(shape, 4, np.float64)
    g = np.random.default_rng(5).standard_normal(shape)
    g[1:-1, 1:-1, 1:-1] = 0.0
    ref = _jnp_vjp(phi, sgn, g)
    out = _port_vjp(phi, sgn, g)
    assert np.abs(out[0][1, 1, 1]) > 0
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-10 * max(
            1.0, np.abs(b).max()))


def test_float32_matches_jnp_vjp():
    shape = (16, 13, 12)
    phi, sgn = _field(shape, 6), _field(shape, 7)
    g = np.random.default_rng(8).standard_normal(shape).astype(np.float32)
    ref = _jnp_vjp(phi, sgn, g)
    out = _port_vjp(phi, sgn, g)
    for a, b in zip(out[:2], ref[:2]):
        np.testing.assert_allclose(a, b, atol=2e-4, rtol=1e-3)
    for a, b in zip(out[2:], ref[2:]):
        np.testing.assert_allclose(float(a), float(b), rtol=2e-3)
    # the wrapper on a CPU tensor IS the plain version
    t = [torch.from_numpy(x) for x in (phi, sgn, g)]
    plain = wc.reinit_step_vjp_plain(*t, DX, H)
    for a, b in zip(out, plain):
        np.testing.assert_array_equal(a, b.numpy())


def test_plain_vjp_matches_pallas_adjoint_kernel():
    """One step against K5 itself (``_pallas_bwd_padded``, interpret mode)
    at the smallest grid it tiles: ~23 s on a CPU core."""
    shape = (12, 16, 16)
    phi, sgn = _field(shape, 8), _field(shape, 9)
    g = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    tile = wp._pick_tile(shape)
    pad = wp.pad_for_pallas(jnp.asarray(phi), tile)
    cp, cs, cdx, ch = wp._pallas_bwd_padded(
        pad, wp.pad_for_pallas(jnp.asarray(sgn), tile),
        wp.pad_zero_for_pallas(jnp.asarray(g), tile), jnp.float32(DX),
        jnp.float32(H), gshape=shape, eps_scale=1e-6, eps_floor=1e-18,
        quirk_y_p5_zero=False, tile=wp._pick_bwd_tile(pad.shape, tile),
        interpret=True)
    out = _port_vjp(phi, sgn, g)
    np.testing.assert_allclose(out[0], np.asarray(
        wp.crop_from_pallas(cp, shape)), atol=2e-6, rtol=0)
    np.testing.assert_allclose(out[1], np.asarray(
        wp.crop_from_pallas(cs, shape)), atol=2e-7, rtol=0)
    np.testing.assert_allclose(float(out[2]), float(cdx), rtol=2e-5)
    np.testing.assert_allclose(float(out[3]), float(ch), rtol=2e-5)
