"""Grid operators of the port against the JAX package's jnp versions, in
float64 at (20, 18, 16), atol 1e-12 (the same expressions, reassociated at
most by the two frameworks' elementwise kernels)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from levelsetfortran_tpu.grid.grid import Grid3D as JGrid
from levelsetfortran_tpu.ops import band as jband
from levelsetfortran_tpu.ops import derivs as jderivs
from levelsetfortran_tpu.ops import interp as jinterp
from levelsetfortran_tpu.ops import minmax as jminmax
from levelsetfortran_tpu.ops import sign as jsign
from levelsetfortran_tpu.ops import stencil as jstencil
from levelsetfortran_tpu.ops import weno as jweno
from levelsetfortran_tpu.solvers.advect import advect_nodes as j_advect_nodes
from levelsetfortran_tpu.solvers.advect import banded_gradient as j_banded_gradient
from levelsetfortran_tpu.solvers.minmax_flow import minmax_step as j_minmax_step
from levelsetfortran_tpu.solvers.reinit import reinit_step as j_reinit_step
from levelsetfortran_tpu_torch.grid.grid import Grid3D as TGrid
from levelsetfortran_tpu_torch.ops import band as tband
from levelsetfortran_tpu_torch.ops import derivs as tderivs
from levelsetfortran_tpu_torch.ops import interp as tinterp
from levelsetfortran_tpu_torch.ops import minmax as tminmax
from levelsetfortran_tpu_torch.ops import sign as tsign
from levelsetfortran_tpu_torch.ops import stencil as tstencil
from levelsetfortran_tpu_torch.ops import weno as tweno
from levelsetfortran_tpu_torch.solvers import advect as tadvect
from levelsetfortran_tpu_torch.solvers import minmax_flow as tmm
from levelsetfortran_tpu_torch.solvers import reinit as treinit

torch.set_num_threads(1)
SHAPE = (20, 18, 16)
DX = 0.1
ATOL = 1e-12


def _field(seed=0, shape=SHAPE):
    """A bumpy sphere-like SDF, unit scale, float64."""
    rng = np.random.default_rng(seed)
    xs = [(np.arange(n) - (n - 1) / 2.0) * DX for n in shape]
    gx, gy, gz = np.meshgrid(*xs, indexing="ij")
    phi = np.sqrt(gx ** 2 + 1.3 * gy ** 2 + gz ** 2) - 0.5
    return phi + 0.02 * rng.standard_normal(shape)


def _pair(a):
    return jnp.asarray(a, jnp.float64), torch.tensor(a, dtype=torch.float64)


def _close(j, t, atol=ATOL):
    np.testing.assert_allclose(np.asarray(j), t.numpy(), rtol=0, atol=atol)


@pytest.mark.parametrize("depth", [1, 4])
def test_interior_mask(depth):
    np.testing.assert_array_equal(
        np.asarray(jstencil.interior_mask(SHAPE, depth)),
        tstencil.interior_mask(SHAPE, depth).numpy())


@pytest.mark.parametrize("axis,off", [(0, 1), (1, -2), (2, 3)])
def test_shift(axis, off):
    j, t = _pair(_field())
    _close(jstencil.shift(j, axis, off), tstencil.shift(t, axis, off), 0)


def test_boundary_extrapolate():
    j, t = _pair(_field())
    _close(jstencil.boundary_extrapolate(j, DX),
           tstencil.boundary_extrapolate(t, DX))


def test_smeared_sign():
    j, t = _pair(_field())
    jg, tg = _pair(np.abs(_field(1)))
    _close(jsign.smeared_sign(j, DX, jg), tsign.smeared_sign(t, DX, tg))


def test_narrow_band():
    j, t = _pair(_field())
    for a, b in zip(jband.narrow_band(j, DX), tband.narrow_band(t, DX)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("quirk", [False, True])
def test_weno_derivatives_and_godunov(quirk):
    j, t = _pair(_field())
    js, ts = _pair(_field(2))
    ef = jweno.default_eps_floor(jnp.float64)
    assert ef == tweno.default_eps_floor(torch.float64)
    assert jweno.default_eps_floor(jnp.float32) == tweno.default_eps_floor(
        torch.float32)
    jd = jweno.weno_derivatives(j, DX, quirk_y_p5_zero=quirk)
    td = tweno.weno_derivatives(t, DX, quirk_y_p5_zero=quirk)
    for a, b in zip(jd.minus + jd.plus, td.minus + td.plus):
        _close(a, b)          # derivatives are O(1/dx) = O(10)
    for sw in (None, "s"):
        jm, jsq = jweno.godunov_select(j, jd, None if sw is None else js)
        tm, tsq = tweno.godunov_select(t, td, None if sw is None else ts)
        _close(jm, tm)
        _close(jsq, tsq)
    jm, _ = jweno.weno_godunov(j, DX, quirk_y_p5_zero=quirk, switch=js)
    tm, _ = tweno.weno_godunov(t, DX, quirk_y_p5_zero=quirk, switch=ts)
    _close(jm, tm)


@pytest.mark.parametrize("order", [1, 2, 4, 6, 8])
@pytest.mark.parametrize("quirk", [False, True])
def test_first_derivative(order, quirk):
    j, t = _pair(_field())
    kw = dict(quirk_deriv8_y=quirk, quirk_deriv1_plus=quirk)
    jg, jm = jderivs.first_derivative(j, DX, order, **kw)
    tg, tm = tderivs.first_derivative(t, DX, order, **kw)
    _close(jg, tg)
    _close(jm, tm)


def test_second_derivative_and_laplacian():
    j, t = _pair(_field())
    for a, b in zip(jderivs.second_derivative(j, DX),
                    tderivs.second_derivative(t, DX)):
        _close(a, b)
    with pytest.raises(ValueError):
        tderivs.second_derivative(t, DX, order=4)
    with pytest.raises(ValueError):
        tderivs.first_derivative(t, DX, order=3)


@pytest.mark.parametrize("halfwidth", [1, 2, 3])
def test_minmax_rhs(halfwidth):
    j, t = _pair(_field())
    _close(jminmax.seven_point_average(j, halfwidth),
           tminmax.seven_point_average(t, halfwidth))
    kw = dict(threshold=0.05, avg_halfwidth=halfwidth)
    _close(jminmax.minmax_rhs(j, DX, **kw), tminmax.minmax_rhs(t, DX, **kw))


def test_trilinear_and_sample_surface():
    phi = _field()
    jg = JGrid(SHAPE, (-1.0, -0.9, -0.8), DX)
    tg = TGrid(SHAPE, (-1.0, -0.9, -0.8), DX)
    pts = np.random.default_rng(3).uniform(-1.3, 1.2, size=(300, 3))
    j, t = _pair(phi)
    jp, tp = _pair(pts)
    _close(jinterp.trilinear(j, jg, jp), tinterp.trilinear(t, tg, tp))
    grad = np.random.default_rng(4).standard_normal(SHAPE + (3,))
    jgr, tgr = _pair(grad)
    _close(jinterp.trilinear(jgr, jg, jp), tinterp.trilinear(tgr, tg, tp))
    for a, b in zip(jinterp.sample_surface(j, jgr, jg, jp),
                    tinterp.sample_surface(t, tgr, tg, tp)):
        _close(a, b)


@pytest.mark.parametrize("quirk", [False, True])
def test_banded_gradient_and_advect(quirk):
    j, t = _pair(_field())
    _close(j_banded_gradient(j, DX, quirk_deriv8_y=quirk),
           tadvect.banded_gradient(t, DX, quirk_deriv8_y=quirk))
    jg = JGrid(SHAPE, (-0.95, -0.85, -0.75), DX)
    tg = TGrid(SHAPE, (-0.95, -0.85, -0.75), DX)
    pts = np.random.default_rng(5).uniform(-0.6, 0.6, size=(40, 3))
    jp, tp = _pair(pts)
    a = j_advect_nodes(j, jg, jp, DX, iters=7, quirk_deriv8_y=quirk)
    b = tadvect.advect_nodes(t, tg, tp, DX, iters=7, quirk_deriv8_y=quirk)
    _close(a.positions, b.positions)
    _close(a.phi_surf, b.phi_surf)


@pytest.mark.parametrize("quirk", [False, True])
def test_reinit_step_whole_grid_form(quirk):
    j, t = _pair(_field())
    js, ts = _pair(_field(6))
    _close(j_reinit_step(j, js, DX, 0.01, quirk_y_p5_zero=quirk),
           treinit.reinit_step(t, ts, DX, 0.01, quirk_y_p5_zero=quirk))


@pytest.mark.parametrize("halfwidth", [1, 2])
def test_minmax_step_whole_grid_form(halfwidth):
    j, t = _pair(_field())
    kw = dict(band_radius=4.1, threshold=0.0, avg_halfwidth=halfwidth)
    _close(j_minmax_step(j, DX, 1e-4, **kw),
           tmm.minmax_step(t, DX, 1e-4, **kw))
