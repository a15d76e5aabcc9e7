"""Kernel K6's plain version (the VJP of one min/max step, as the CUDA
kernel computes it) against the JAX package's adjoint kernel in interpret
mode and the jnp VJP, including exact ``lap == 0`` ties; the fixed-step
solver ``minmax_flow_fixed`` against the JAX package's.

Tolerances: float32 against the Pallas kernel atol 1e-6 on max |cot| ~4
(measured 2.4e-7: the same expressions), the scalars rtol 1e-4 (summed in
f64 here and in f32 tile by tile there: measured 1.5e-5); float64 against
the jnp VJP 1e-12; the solver at the JAX package's own fused-vs-jnp gates
(phi0 atol 2e-5, rtol 1e-3; scalars rtol 2e-3,
``tests/test_minmax_pallas.py:40-75``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from levelsetfortran_tpu.ops import minmax_pallas as mp
from levelsetfortran_tpu.ops import weno_pallas as wp
from levelsetfortran_tpu.solvers.minmax_flow import minmax_flow_fixed as jmf
from levelsetfortran_tpu.solvers.minmax_flow import minmax_step as jstep
from levelsetfortran_tpu_torch.ops import minmax_cuda as mc
from levelsetfortran_tpu_torch.ops import reverse
from levelsetfortran_tpu_torch.solvers.minmax_flow import minmax_flow_fixed

torch.set_num_threads(1)
SHAPE = (16, 24, 32)
DX = 3.0 / 15
H1 = 0.05 * DX * DX


def _sdf(shape=SHAPE, dtype=np.float32):
    xs = [np.linspace(-1.5, 1.5, k) for k in shape]
    gx, gy, gz = np.meshgrid(*xs, indexing="ij")
    return (np.sqrt(gx ** 2 + gy ** 2 + gz ** 2) - 0.7).astype(dtype)


def _planes(shape=SHAPE, dtype=np.float64):
    """A field that is linear in every cell's stencil except along one
    crease: lap == 0 exactly on both sides of it, inside the band."""
    xs = [np.arange(k, dtype=dtype) * 0.125 for k in shape]
    gx, gy, gz = np.meshgrid(*xs, indexing="ij")
    return np.abs(gx - xs[0][shape[0] // 2]) - 0.25 + 0.0 * gy * gz


def _cotangent(shape, seed, dtype):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _port(phi, g, dx=DX, h1=H1):
    res = mc.minmax_step_vjp(torch.from_numpy(phi), torch.from_numpy(g), dx,
                             h1)
    return [r.numpy() for r in res]


def test_plain_vjp_matches_pallas_adjoint_kernel():
    phi, g = _sdf(), _cotangent(SHAPE, 1, np.float32)
    tile = wp._pick_tile(SHAPE)
    cp, cdx, ch = mp.minmax_bwd_padded(
        mp.pad_for_pallas(jnp.asarray(phi), tile),
        wp.pad_zero_for_pallas(jnp.asarray(g), tile), jnp.float32(DX),
        jnp.float32(H1), 4.1, 0.0, gshape=SHAPE, tile=tile, interpret=True)
    out = _port(phi, g)
    ref = np.asarray(mp.crop_from_pallas(cp, SHAPE))
    assert np.abs(out[0] - g).max() > 0.1          # the band moves cot_phi
    np.testing.assert_allclose(out[0], ref, atol=1e-6, rtol=0)
    np.testing.assert_allclose(float(out[1]), float(cdx), rtol=1e-4)
    np.testing.assert_allclose(float(out[2]), float(ch), rtol=1e-4)
    # the wrapper on a CPU tensor IS the plain version
    plain = mc.minmax_step_vjp_plain(torch.from_numpy(phi),
                                     torch.from_numpy(g), DX, H1)
    for a, b in zip(out, plain):
        np.testing.assert_array_equal(a, b.numpy())


def _jnp_vjp(phi, g, dx):
    jt = jnp.float64 if phi.dtype == np.float64 else jnp.float32

    def step(p, d, hh):
        return jstep(p, d, hh, band_radius=4.1, threshold=0.0)

    _, vjp = jax.vjp(step, jnp.asarray(phi), jt(dx), jt(H1))
    return [np.asarray(c) for c in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("field", ["sdf", "planes"])
def test_float64_matches_jnp_vjp_with_ties(field):
    """JAX routes half the cotangent through min(lap, 0) at lap == 0; the
    planes field puts hundreds of in-band cells on that tie, where
    autograd of ``torch.clamp`` would route all of it."""
    phi = _sdf(dtype=np.float64) if field == "sdf" else _planes()
    dx = DX if field == "sdf" else 0.125
    g = _cotangent(SHAPE, 2, np.float64)
    out = _port(phi, g, dx=dx)
    ref = _jnp_vjp(phi, g, dx)
    if field == "planes":
        sc = mc.minmax_scalars(torch.float64, dx, H1, 4.1, 0.0)
        sum6 = sum(np.roll(phi, s, a) for a in range(3) for s in (1, -1))
        lap = (sum6 - 6.0 * phi) * sc["inv_dx2"]
        inner = np.zeros(SHAPE, bool)
        inner[1:-1, 1:-1, 1:-1] = True
        ties = inner & (lap == 0.0) & (np.abs(phi) < sc["band_dx"])
        assert ties.sum() > 100
    np.testing.assert_allclose(out[0], ref[0], rtol=0, atol=1e-12)
    np.testing.assert_allclose(float(out[1]), float(ref[1]), rtol=1e-12)
    np.testing.assert_allclose(float(out[2]), float(ref[2]), rtol=1e-12)


def test_scalar_cotangents_of_band_and_threshold_are_zero():
    phi = torch.from_numpy(_sdf())
    br = torch.tensor(4.1, requires_grad=True)
    th = torch.tensor(0.0, requires_grad=True)
    p = phi.clone().requires_grad_(True)
    (minmax_flow_fixed(p, DX, H1, 3, band_radius=br, threshold=th) ** 2
     ).sum().backward()
    assert float(p.grad.abs().max()) > 0
    assert br.grad is not None and float(br.grad) == 0.0
    assert th.grad is not None and float(th.grad) == 0.0


def test_minmax_flow_fixed_matches_jax():
    phi = _sdf()

    def jloss(q, d, hh):
        return jnp.sum(jmf(q, d, hh, 3, use_pallas=False) ** 2)

    gp, gd, gh = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(phi), jnp.float32(DX), jnp.float32(H1))
    p = torch.from_numpy(phi).requires_grad_(True)
    d = torch.tensor(DX, dtype=torch.float32, requires_grad=True)
    hh = torch.tensor(H1, dtype=torch.float32, requires_grad=True)
    out = minmax_flow_fixed(p, d, hh, 3)
    (out ** 2).sum().backward()
    assert reverse.last_branch["minmax_flow_fixed"] == "flat"
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(
        jmf(jnp.asarray(phi), DX, H1, 3, use_pallas=False)),
        atol=2e-6, rtol=1e-5)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(gp), atol=2e-5,
                               rtol=1e-3)
    np.testing.assert_allclose(float(d.grad), float(gd), rtol=2e-3)
    np.testing.assert_allclose(float(hh.grad), float(gh), rtol=2e-3)


def test_minmax_sqrtn_equals_flat(monkeypatch):
    phi = _sdf()

    def grad():
        p = torch.from_numpy(phi).requires_grad_(True)
        (minmax_flow_fixed(p, DX, H1, 5) ** 2).sum().backward()
        return p.grad

    g_flat = grad()
    monkeypatch.setattr(reverse, "_FLAT_TRAJ_BYTES", 0)
    g_sqrt = grad()
    assert reverse.last_branch["minmax_flow_fixed"] == "sqrtn"
    assert torch.equal(g_flat, g_sqrt)
