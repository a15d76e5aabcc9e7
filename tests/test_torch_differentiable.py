"""The whole differentiable path — init, ``reinit_fixed``,
``minmax_flow_fixed``, the renderer — against the JAX package's
``image_loss_and_vertex_grad`` on the octahedron of ``tests/test_render.py``
at 24^3 (reinit 5, min/max 3, 12x12), and its finite-difference gate.

Tolerances: float64 loss rtol 1e-12 and gradient 1e-9 relative to
max |grad| (measured 1.2e-11 of 5.8: summation order only); float32 loss
rtol 1e-4, gradient atol 1e-4 and rtol 1e-3 (measured 3.3e-6).  The sharded
path (``mesh=``, four blocks on the CPU) against the JAX package's sharded
path on four virtual devices and against the port's own solo path: the
JAX package's sharded-vs-single gates, loss rtol 1e-4, gradient atol 1e-4
and rtol 1e-3 (``tests/test_render.py:132-155``; the per-block init may
break a tie the other way, ROADMAP H8).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from levelsetfortran_tpu.grid.grid import Grid3D as JGrid
from levelsetfortran_tpu.parallel.mesh import make_mesh as jax_make_mesh
from levelsetfortran_tpu.pipeline import differentiable as jdiff
from levelsetfortran_tpu_torch import (image_loss_and_vertex_grad,
                                       render_from_vertices)
from levelsetfortran_tpu_torch.grid.grid import Grid3D
from levelsetfortran_tpu_torch.ops.init_sign import signed_distance_init
from levelsetfortran_tpu_torch.parallel.mesh import make_mesh
from levelsetfortran_tpu_torch.render.sphere_trace import (camera_rays,
                                                           trace_depth)
from levelsetfortran_tpu_torch.solvers.reinit import reinit_fixed

torch.set_num_threads(1)
KW = dict(eye=(0.0, -3.0, 0.0), target=(0.0, 0.0, 0.0), reinit_steps=5,
          minmax_steps=3, height=12, width=12, n_march_steps=48)


def _grids(n=24, half=1.2):
    dx = 2 * half / (n - 1)
    kw = dict(shape=(n, n, n), origin=(-half,) * 3, dx=dx)
    return Grid3D(**kw), JGrid(**kw)


def _octahedron(scale=0.7):
    v = scale * np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                          [0, 0, 1], [0, 0, -1]], np.float64)
    f = np.array([[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4],
                  [2, 0, 5], [1, 2, 5], [3, 1, 5], [0, 3, 5]], np.int32)
    return v, f


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_loss_and_vertex_grad_match_jax(dtype):
    v, f = _octahedron()
    tg, jg = _grids()
    f64 = dtype == torch.float64
    jt = jnp.float64 if f64 else jnp.float32
    lj, gj = jdiff.image_loss_and_vertex_grad(
        jnp.asarray(v, jt), jnp.asarray(f), jg, jnp.zeros((12, 12), jt),
        use_pallas=False, **KW)
    lt, gt = image_loss_and_vertex_grad(
        torch.tensor(v, dtype=dtype), torch.from_numpy(f), tg,
        torch.zeros((12, 12), dtype=dtype), **KW)
    gj = np.asarray(gj)
    assert lt.dtype == gt.dtype == dtype and gt.shape == (6, 3)
    assert np.abs(gj).max() > 0
    if f64:
        np.testing.assert_allclose(float(lt), float(lj), rtol=1e-12)
        np.testing.assert_allclose(gt.numpy(), gj, rtol=0,
                                   atol=1e-9 * np.abs(gj).max())
    else:
        np.testing.assert_allclose(float(lt), float(lj), rtol=1e-4)
        np.testing.assert_allclose(gt.numpy(), gj, atol=1e-4, rtol=1e-3)


def test_end_to_end_vertex_gradient_and_culling():
    v, f = _octahedron()
    tg, _ = _grids()
    vt = torch.tensor(v, dtype=torch.float32)
    out = render_from_vertices(vt, f, tg, **KW)
    assert float(out.image[6, 6]) > 0.0 and out.phi.shape == tg.shape
    target = torch.zeros((12, 12))
    loss, grad = image_loss_and_vertex_grad(vt, f, tg, target, **KW)
    assert torch.isfinite(grad).all() and float(grad.abs().max()) > 0
    # the culled init is exact: same loss and gradient
    lc, gc = image_loss_and_vertex_grad(vt, f, tg, target, culling="auto",
                                        **KW)
    assert float(lc) == pytest.approx(float(loss), rel=1e-6)
    np.testing.assert_allclose(gc.numpy(), grad.numpy(), atol=1e-6,
                               rtol=1e-5)
    # mesh= runs: the sharded path renders the same image
    om = render_from_vertices(vt, f, tg, mesh=make_mesh((2, 2, 1), ["cpu"]),
                              **KW)
    np.testing.assert_allclose(om.image.numpy(), out.image.numpy(),
                               atol=1e-5)


def test_vertex_gradient_finite_difference():
    """Directional finite difference through init + reinit + trace, as in
    ``tests/test_render.py``: a tightly converged march over the central
    2x2 rays, agreement within 15%."""
    v, f = _octahedron()
    tg, _ = _grids()
    dx = tg.dx
    origins, dirs = camera_rays(8, 8, eye=(0.0, -3.0, 0.0),
                                target=(0.0, 0.0, 0.0))

    def loss(vv):
        phi0 = signed_distance_init(tg, vv, f, dtype=torch.float32)
        phi = reinit_fixed(phi0, dx, 0.1 * dx, 3)
        t = trace_depth(phi, tg, origins, dirs, 200, 0.01 * dx, 10.0)
        return torch.sum(t[3:5, 3:5] ** 2)

    rng = np.random.default_rng(0)
    d = torch.from_numpy(rng.standard_normal(v.shape).astype(np.float32))
    d = 0.3 * d / torch.linalg.vector_norm(d)
    vt = torch.tensor(v, dtype=torch.float32, requires_grad=True)
    loss(vt).backward()
    ana = float(torch.sum(vt.grad * d))
    eps = 1e-3
    base = torch.tensor(v, dtype=torch.float32)
    with torch.no_grad():
        num = (float(loss(base + eps * d)) - float(loss(base - eps * d))) \
            / (2 * eps)
    assert abs(ana - num) < 0.15 * max(1.0, abs(num))


def test_sharded_loss_and_vertex_grad_match_jax_and_solo(eight_devices):
    """``image_loss_and_vertex_grad(mesh=...)``: sharded init, then the
    sharded fixed-step solvers, gathered for the renderer, on a (2, 2, 1)
    mesh of four CPU blocks."""
    v, f = _octahedron()
    tg, jg = _grids()
    lj, gj = jdiff.image_loss_and_vertex_grad(
        jnp.asarray(v, jnp.float32), jnp.asarray(f), jg,
        jnp.zeros((12, 12), jnp.float32), use_pallas=False,
        mesh=jax_make_mesh((2, 2, 1), eight_devices[:4]), **KW)
    gj = np.asarray(gj)
    vt = torch.tensor(v, dtype=torch.float32)
    target = torch.zeros((12, 12))
    lm, gm = image_loss_and_vertex_grad(
        vt, f, tg, target, mesh=make_mesh((2, 2, 1), ["cpu"] * 4), **KW)
    ls, gs = image_loss_and_vertex_grad(vt, f, tg, target, **KW)
    assert np.abs(gj).max() > 0 and gm.shape == (6, 3)
    for loss, grad in ((float(lj), gj), (float(ls), gs.numpy())):
        np.testing.assert_allclose(float(lm), loss, rtol=1e-4)
        np.testing.assert_allclose(gm.numpy(), grad, atol=1e-4, rtol=1e-3)
