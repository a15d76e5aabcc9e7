"""The banded modes of the adjoint kernels K5 (reinit step) and K6 (min/max
step) and the differentiable narrow-band solves that run them,
``weno_cuda.reinit_scan_banded`` and ``minmax_cuda.minmax_scan(banded=
True)``.  On the CPU the wrappers run the plain versions, held here

* with every brick active, against the dense adjoints: equal;
* banded min/max against dense min/max: values and gradients BITWISE with a
  real mask (banded min/max is the dense function), the dx/h1 cotangents
  1e-12 relative (measured 0);
* banded reinit against the JAX package's ``reinit_scan_pallas_banded`` at
  ``band_radius=1e3`` (every brick and tile active: the port's 8^3 bricks
  are not the TPU's tiles), Pallas in interpret mode: forward atol 1e-6
  (ROADMAP H5), gradient atol 2e-4 / rtol 1e-3;
* banded reinit with a real mask (bricks frozen, faces among them) against
  a float64 directional finite difference: 1e-3 relative at eps 1e-7
  (measured 2e-5; the step's Godunov and WENO switches are kinks, so the
  difference converges only linearly in eps);
* the sharded banded solve against the solo banded one, on blocks that are
  multiples of 8: forward and gradient BITWISE.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from levelsetfortran_tpu.ops.weno_pallas import reinit_scan_pallas_banded
from levelsetfortran_tpu_torch.ops import minmax_cuda as mc
from levelsetfortran_tpu_torch.ops import weno_cuda as wc
from levelsetfortran_tpu_torch.parallel import sharded as sh
from levelsetfortran_tpu_torch.parallel.mesh import (gather_blocks,
                                                     make_mesh, split_blocks)
from levelsetfortran_tpu_torch.solvers.minmax_flow import minmax_flow_fixed
from levelsetfortran_tpu_torch.solvers.reinit import reinit_fixed

torch.set_num_threads(1)
DTYPES = [torch.float32, torch.float64]
N = (48, 48, 32)
DX = 0.1
H, H1 = 0.1 * DX, 0.05 * DX * DX


def sphere(n, radius, scale=1.0, dx=DX, dtype=torch.float64):
    axes = [(np.arange(k) - (k - 1) / 2.0) * dx for k in n]
    g = np.meshgrid(*axes, indexing="ij")
    return torch.tensor(scale * (np.sqrt(sum(a * a for a in g)) - radius),
                        dtype=dtype)


def weights(n=N, dtype=torch.float64, seed=1):
    return torch.tensor(np.random.default_rng(seed).standard_normal(n),
                        dtype=dtype)


def grad_of(fn, x0, w):
    x = x0.clone().requires_grad_(True)
    out = fn(x)
    torch.sum(w * out).backward()
    return out.detach(), x.grad


@pytest.mark.parametrize("dtype", DTYPES)
def test_all_active_banded_adjoints_equal_dense(dtype):
    phi = sphere(N, 1.0, 1.5, dtype=dtype)
    sgn = sphere(N, 1.1, dtype=dtype)
    g = weights(dtype=dtype)
    ones = torch.ones(wc.brick_grid(N), dtype=torch.int32)
    banded = wc.reinit_step_vjp_banded(phi, sgn, g, DX, H, ones)
    dense = wc.reinit_step_vjp(phi, sgn, g, DX, H)
    assert all(torch.equal(a, b) for a, b in zip(banded, dense))
    banded = mc.minmax_step_vjp_banded(phi, g, DX, H1, ones)
    dense = mc.minmax_step_vjp(phi, g, DX, H1)
    assert all(torch.equal(a, b) for a, b in zip(banded, dense))


@pytest.mark.parametrize("dtype", DTYPES)
def test_banded_minmax_scan_is_the_dense_solve_bitwise(dtype):
    phi = sphere(N, 1.0, dtype=dtype)
    assert int((wc.tile_activity(phi, DX, 4.1, window="band4") == 0).sum())
    w = weights(dtype=dtype)
    grads = {}
    for banded in (False, True):
        x = phi.clone().requires_grad_(True)
        dx = torch.tensor(DX, dtype=dtype, requires_grad=True)
        h1 = torch.tensor(H1, dtype=dtype, requires_grad=True)
        out = mc.minmax_scan(x, dx, h1, 7, banded=banded, refresh_every=3)
        torch.sum(w * out).backward()
        grads[banded] = (out.detach(), x.grad, dx.grad, h1.grad)
    assert not torch.equal(grads[True][0], phi)
    assert all(torch.equal(a, b) for a, b in zip(grads[True][:2],
                                                 grads[False][:2]))
    for a, b in zip(grads[True][2:], grads[False][2:]):
        assert abs(float(a) - float(b)) <= 1e-12 * abs(float(b))
    ref = minmax_flow_fixed(phi, DX, H1, 7)
    assert torch.equal(grads[False][0], ref)


def test_banded_reinit_matches_jax_every_tile_active():
    n = (16, 16, 16)
    axes = [np.linspace(-1.0, 1.0, k) for k in n]
    g = np.meshgrid(*axes, indexing="ij")
    phi = (2.0 * np.sqrt(sum(a * a for a in g)) - 1.0).astype(np.float32)
    dx = 2.0 / 15
    h = 0.1 * dx
    w = np.random.default_rng(0).standard_normal(n).astype(np.float32)

    def jfn(p):
        return reinit_scan_pallas_banded(p, dx, h, 2, band_radius=1e3,
                                         refresh_every=1,
                                         axis_order=(0, 1, 2))

    jout = np.asarray(jfn(jnp.asarray(phi)))
    jgrad = np.asarray(jax.grad(lambda p: jnp.sum(jnp.asarray(w) * jfn(p)))(
        jnp.asarray(phi)))
    out, grad = grad_of(lambda x: wc.reinit_scan_banded(
        x, dx, h, 2, band_radius=1e3, refresh_every=1), torch.tensor(phi),
        torch.tensor(w))
    assert np.abs(jgrad).max() > 0
    np.testing.assert_allclose(out.numpy(), jout, atol=1e-6)
    np.testing.assert_allclose(grad.numpy(), jgrad, atol=2e-4, rtol=1e-3)


def test_banded_reinit_every_brick_active_is_the_dense_solve():
    """With every brick active the banded scan is the dense fixed solve:
    values and gradients bitwise, the dx/h cotangents to 1e-12."""
    phi = sphere(N, 1.0, 1.5)
    w = weights()
    res = []
    for fn in (lambda x, dx, h: wc.reinit_scan_banded(
            x, dx, h, 5, band_radius=1e3, refresh_every=2),
            lambda x, dx, h: reinit_fixed(x, dx, h, 5)):
        x = phi.clone().requires_grad_(True)
        dx = torch.tensor(DX, dtype=torch.float64, requires_grad=True)
        h = torch.tensor(H, dtype=torch.float64, requires_grad=True)
        out = fn(x, dx, h)
        torch.sum(w * out).backward()
        res.append((out.detach(), x.grad, float(dx.grad), float(h.grad)))
    assert torch.equal(res[0][0], res[1][0])
    assert torch.equal(res[0][1], res[1][1])
    for a, b in zip(res[0][2:], res[1][2:]):
        assert abs(a - b) <= 1e-12 * abs(b)


def _banded(x):
    return wc.reinit_scan_banded(x, DX, H, 5, band_radius=2.1,
                                 refresh_every=3)


def test_banded_reinit_gradient_finite_difference():
    """A real mask (bricks frozen, the grid's faces and corners among them):
    the gradient of the banded solve is the transpose of what the forward
    ran, frozen bricks included."""
    phi = sphere(N, 1.0, 1.5)
    act = wc.tile_activity(phi, DX, 2.1, 3 * H / DX, window="band4")
    assert 0 < int(act.sum()) < act.numel()
    assert int(act[0, 0, 0]) == 0                     # a corner brick froze
    out = _banded(phi)
    assert bool((out == phi).any())                    # frozen cells kept
    w = weights()
    _, grad = grad_of(_banded, phi, w)
    d = weights(seed=2)
    eps = 1e-7
    with torch.no_grad():
        num = (float(torch.sum(w * _banded(phi + eps * d)))
               - float(torch.sum(w * _banded(phi - eps * d)))) / (2 * eps)
    ana = float(torch.sum(grad * d))
    assert abs(ana - num) <= 1e-3 * abs(num)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mesh_shape", [(2, 2, 1), (2, 1, 2), (2, 2, 2)])
def test_sharded_banded_equals_solo_banded(mesh_shape, dtype):
    phi = sphere(N, 1.0, 1.5, dtype=dtype)
    w = weights(dtype=dtype)
    m = make_mesh(mesh_shape, ["cpu"])
    ref = grad_of(_banded, phi, w)

    def sharded(x):
        return gather_blocks(m, sh.reinit_fixed_sharded(
            m, split_blocks(m, x), DX, H, 5, band_radius=2.1,
            refresh_every=3))

    got = grad_of(sharded, phi, w)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
