"""The sphere-traced renderer, the trilinear sampler's gradients and the
init's vertex gradients against the JAX package, and the analytic checks
of ``tests/test_render.py``.

Tolerances: values and gradients in float64 at 1e-9 (the same expressions;
the march's masked steps and the argmin selections are discrete, so the
comparison runs where they agree, which they do on these inputs); float32
values at 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from levelsetfortran_tpu.grid.grid import Grid3D as JGrid
from levelsetfortran_tpu.ops import init_sign as jinit
from levelsetfortran_tpu.ops.interp import trilinear as jtrilinear
from levelsetfortran_tpu.render import sphere_trace as jst
from levelsetfortran_tpu_torch.grid.grid import Grid3D
from levelsetfortran_tpu_torch.models import analytic
from levelsetfortran_tpu_torch.ops import init_sign as tinit
from levelsetfortran_tpu_torch.ops.interp import trilinear
from levelsetfortran_tpu_torch.render import sphere_trace as st

torch.set_num_threads(1)
EYE, TARGET = (0.0, -3.0, 0.0), (0.0, 0.0, 0.0)


def _grids(n=32, half=1.2):
    dx = 2 * half / (n - 1)
    kw = dict(shape=(n, n, n), origin=(-half,) * 3, dx=dx)
    return Grid3D(**kw), JGrid(**kw)


def _sphere_phi(grid, r=0.6, dtype=torch.float64):
    pts = grid.coords(dtype)
    return torch.sqrt(torch.sum(pts * pts, dim=-1)) - r


def _octahedron(scale=0.7):
    v = scale * np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                          [0, 0, 1], [0, 0, -1]], np.float64)
    f = np.array([[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4],
                  [2, 0, 5], [1, 2, 5], [3, 1, 5], [0, 3, 5]], np.int32)
    return v, f


def _close(a, b, tol=1e-9):
    b = np.asarray(b)
    np.testing.assert_allclose(np.asarray(a), b, rtol=0,
                               atol=tol * max(1.0, np.abs(b).max()))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_camera_rays_match_jax(dtype):
    jt = jnp.float64 if dtype == torch.float64 else jnp.float32
    o, d = st.camera_rays(9, 12, eye=EYE, target=TARGET, dtype=dtype)
    jo, jd = jst.camera_rays(9, 12, eye=EYE, target=TARGET, dtype=jt)
    assert o.shape == d.shape == (9, 12, 3) and d.dtype == dtype
    tol = 1e-12 if dtype == torch.float64 else 1e-6
    _close(o, jo, tol)
    _close(d, jd, tol)


def test_trilinear_gradients_match_jax():
    """Field and point gradients, points inside and outside the box."""
    tg, jg = _grids(12)
    rng = np.random.default_rng(0)
    field = rng.standard_normal(tg.shape)
    pts = rng.uniform(-1.5, 1.5, (40, 3))
    w = rng.standard_normal(40)
    f = torch.from_numpy(field).requires_grad_(True)
    p = torch.from_numpy(pts).requires_grad_(True)
    (torch.from_numpy(w) * trilinear(f, tg, p)).sum().backward()
    gf, gp = jax.grad(lambda a, b: jnp.sum(jnp.asarray(w) * jtrilinear(
        a, jg, b)), argnums=(0, 1))(jnp.asarray(field), jnp.asarray(pts))
    _close(f.grad, gf)
    _close(p.grad, gp)


def test_trace_depth_values_and_gradients_match_jax():
    tg, jg = _grids(32)
    phi = _sphere_phi(tg)
    o, d = st.camera_rays(6, 6, eye=EYE, target=TARGET, dtype=torch.float64)
    w = np.random.default_rng(1).standard_normal((6, 6))
    args = (48, 1e-4, 10.0)
    p = phi.clone().requires_grad_(True)
    oo, dd = o.clone().requires_grad_(True), d.clone().requires_grad_(True)
    t = st.trace_depth(p, tg, oo, dd, *args)
    (torch.from_numpy(w) * t).sum().backward()

    def jloss(a, b, c):
        return jnp.sum(jnp.asarray(w) * jst.trace_depth(a, jg, b, c, *args))

    jp, jo, jd = (jnp.asarray(x.numpy()) for x in (phi, o, d))
    _close(t.detach(), jst.trace_depth(jp, jg, jo, jd, *args))
    for a, b in zip((p.grad, oo.grad, dd.grad),
                    jax.grad(jloss, argnums=(0, 1, 2))(jp, jo, jd)):
        _close(a, b)
    assert float(p.grad.abs().max()) > 0


def test_render_and_normals_match_jax():
    tg, jg = _grids(32)
    phi = _sphere_phi(tg)
    o, d = st.camera_rays(8, 8, eye=EYE, target=TARGET, dtype=torch.float64)
    w = np.random.default_rng(2).standard_normal((8, 8))
    p = phi.clone().requires_grad_(True)
    out = st.render(p, tg, o, d, n_steps=48, hit_tol=1e-3)
    (torch.from_numpy(w) * out.image).sum().backward()
    jp, jo, jd = (jnp.asarray(x.numpy()) for x in (phi, o, d))
    ref = jst.render(jp, jg, jo, jd, n_steps=48, hit_tol=1e-3)
    for a, b in zip(out, ref):
        _close(a.detach(), b)
    gref = jax.grad(lambda q: jnp.sum(jnp.asarray(w) * jst.render(
        q, jg, jo, jd, n_steps=48, hit_tol=1e-3).image))(jp)
    _close(p.grad, gref)
    # surface_normal alone, including its double-where at a flat sample
    pts = torch.tensor([[0.3, -0.4, 0.2], [5.0, 5.0, 5.0]], dtype=torch.float64)
    q = phi.clone().requires_grad_(True)
    n = st.surface_normal(q, tg, pts)
    n.sum().backward()
    jn, jgrad = jax.value_and_grad(lambda a: jnp.sum(jst.surface_normal(
        a, jg, jnp.asarray(pts.numpy()))))(jp)
    _close(n.sum().detach(), jn)
    _close(q.grad, jgrad)
    assert torch.isfinite(q.grad).all()


def test_depth_matches_analytic_sphere():
    tg, _ = _grids(48)
    phi = _sphere_phi(tg, dtype=torch.float32)
    o, d = st.camera_rays(9, 9, eye=EYE, target=TARGET)
    t = st.trace_depth(phi, tg, o, d, 96, 1e-4, 10.0)
    # the central ray hits the sphere at distance 3 - 0.6 = 2.4
    assert abs(float(t[4, 4]) - 2.4) < 5e-3


def test_render_image_shape_and_hit():
    tg, _ = _grids()
    phi = _sphere_phi(tg, dtype=torch.float32)
    o, d = st.camera_rays(16, 16, eye=EYE, target=TARGET)
    out = st.render(phi, tg, o, d, n_steps=64, hit_tol=1e-3)
    assert out.image.shape == (16, 16)
    assert bool(out.hit[8, 8]) and not bool(out.hit[0, 0])
    assert 0.0 < float(out.image[8, 8]) <= 1.0


def test_depth_gradient_matches_analytic():
    """For a sphere SDF seen head-on dt/dr = -1: lowering phi everywhere by
    eps grows the radius by eps and brings the hit eps closer."""
    tg, _ = _grids(48)
    p = _sphere_phi(tg, dtype=torch.float32).requires_grad_(True)
    o, d = st.camera_rays(3, 3, eye=EYE, target=TARGET)
    st.trace_depth(p, tg, o, d, 96, 1e-4, 10.0)[1, 1].backward()
    assert abs(float(torch.sum(-p.grad)) - (-1.0)) < 5e-2


@pytest.mark.parametrize("culled", [True, False])
def test_init_vertex_gradient_matches_jax(culled):
    v, f = _octahedron()
    tg, jg = _grids(20)
    w = np.random.default_rng(3).standard_normal(tg.shape)
    cull = tinit.build_init_culling(tg, v, f) if culled else None
    jcull = jinit.build_init_culling(jg, v, f) if culled else None
    vt = torch.from_numpy(v).requires_grad_(True)
    phi = tinit.signed_distance_init(tg, vt, f, dtype=torch.float64,
                                     culling=cull)
    (torch.from_numpy(w) * phi).sum().backward()
    jphi, jgrad = jax.value_and_grad(lambda a: jnp.sum(
        jnp.asarray(w) * jinit.signed_distance_init(
            jg, a, jnp.asarray(f), dtype=jnp.float64, culling=jcull)))(
        jnp.asarray(v))
    _close((torch.from_numpy(w) * phi).sum().detach(), jphi)
    _close(vt.grad, jgrad)
    assert float(vt.grad.abs().max()) > 0


def test_init_scan_records_no_graph():
    """Autograd keeps only per-point tensors of the argmin re-evaluation:
    nothing of the (G, P, T) selection scan, which at full size would not
    fit the card."""
    mesh = analytic.icosphere_mesh(subdivisions=2)       # 320 triangles
    tg = Grid3D(shape=(16, 16, 16), origin=(-1.2,) * 3, dx=2.4 / 15)
    saved = []

    def pack(t):
        saved.append(t.numel())
        return t

    vt = torch.from_numpy(mesh.vertices.astype(np.float32))
    vt.requires_grad_(True)
    for culling in ("auto", None):
        saved.clear()
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            phi = tinit.signed_distance_init(tg, vt, mesh.elements,
                                             culling=culling)
        npts = 16 ** 3
        assert saved and max(saved) <= 9 * npts, max(saved)
        phi.sum().backward()
        assert torch.isfinite(vt.grad).all() and vt.grad.abs().max() > 0
        vt.grad = None
    # numpy input keeps working, without a graph
    out = tinit.signed_distance_init(tg, mesh.vertices, mesh.elements)
    assert not out.requires_grad and out.shape == tg.shape
