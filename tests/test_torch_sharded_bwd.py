"""The sharded differentiable solvers and the block modes of the adjoint
kernels K5 (reinit step) and K6 (min/max step).  On the CPU the wrappers run
the plain versions, held here

* per step, one shard's block-mode VJP against the port's solo plain VJP on
  the whole grid: field cotangents BITWISE (gather form: every owned cell
  is gathered in the solo order), the owned-range scalar sums 1e-12
  relative (measured 1.7e-15: other summation order), float32 and
  float64, dense and banded;
* ``reinit_fixed_sharded`` / ``minmax_fixed_sharded`` against the solo
  ``reinit_fixed`` / ``minmax_flow_fixed``: forward and gradient BITWISE,
  the dx/h cotangents 1e-12 relative (measured 5.9e-16);
* against the JAX package's fused sharded solvers (Pallas in interpret
  mode) on virtual CPU devices: forward atol 2e-6, gradient atol 2e-4 /
  rtol 1e-3 (the JAX package's own sharded-vs-single gates,
  ``tests/test_parallel.py:384-459``; other reciprocals, ROADMAP H5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from levelsetfortran_tpu.parallel.mesh import make_mesh as jax_make_mesh
from levelsetfortran_tpu.parallel import sharded as jsh
from levelsetfortran_tpu_torch.grid.grid import Grid3D
from levelsetfortran_tpu_torch.ops import minmax_cuda as mc
from levelsetfortran_tpu_torch.ops import reverse
from levelsetfortran_tpu_torch.ops import weno_cuda as wc
from levelsetfortran_tpu_torch.ops.init_sign import (
    build_init_culling, signed_distance_init, signed_distance_init_sharded)
from levelsetfortran_tpu_torch.parallel import sharded as sh
from levelsetfortran_tpu_torch.parallel.halo import (halo_exchange,
                                                     local_offsets)
from levelsetfortran_tpu_torch.parallel.mesh import (gather_blocks,
                                                     make_mesh, split_blocks)
from levelsetfortran_tpu_torch.solvers.minmax_flow import minmax_flow_fixed
from levelsetfortran_tpu_torch.solvers.reinit import reinit_fixed

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


def fields(dtype, n=N, radius=0.6):
    """A distorted sphere, a sign source that differs from it, and a
    standard-normal cotangent."""
    return (torch.tensor(sphere(n, radius=radius, noise=0.01), dtype=dtype),
            torch.tensor(sphere(n, radius=1.1 * radius, noise=0.01, seed=1),
                         dtype=dtype),
            torch.tensor(np.random.default_rng(2).standard_normal(n),
                         dtype=dtype))


def rel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


def block_masks(solo_mask, m, shape):
    """The backward brick mask of every shard of ``m`` from a whole-grid
    mask: its owned bricks and one brick around them on the sharded axes,
    zeros past a global face (blocks multiples of 8)."""
    b = m.block_shape(shape)
    out = []
    for off in local_offsets(m, b):
        sl, pad = [], []
        for ax, (o, n, k) in enumerate(zip(off, b, m.shape)):
            lo, hi = o // 8, -(-(o + n) // 8)
            if k > 1:
                lo, hi = lo - 1, hi + 1
            sl.append(slice(max(lo, 0), min(hi, solo_mask.shape[ax])))
            pad.append((max(-lo, 0), max(hi - solo_mask.shape[ax], 0)))
        a = solo_mask[tuple(sl)]
        spec = [v for p in reversed(pad) for v in p]
        out.append(torch.nn.functional.pad(a, spec).contiguous())
    return out


@pytest.mark.parametrize("banded", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mesh_shape", MESHES)
def test_reinit_block_vjp_bitwise_equals_solo_plain(mesh_shape, dtype,
                                                    banded):
    n = (32, 32, 32) if banded else N
    phi, sgn, g = fields(dtype, n, 0.35 if banded else 0.6)
    m = make_mesh(mesh_shape, ["cpu"])
    active = masks = None
    if banded:
        active = wc.tile_activity(phi, DX, 2.1, 1.0, window="band4")
        assert 0 < int(active.sum()) < active.numel()
        masks = block_masks(active, m, n)
    solo = wc.reinit_step_vjp_plain(phi, sgn, g, DX, H, active=active)
    w = sh.sharded_widths(m, wc.VJP_HALO["reinit"])
    geoms = sh.reinit_geoms(m, n, w)
    res = [wc.reinit_step_block_vjp(p, s, q, DX, H, ge,
                                    active=None if masks is None else a)
           for p, s, q, ge, a in zip(
               *(halo_exchange(split_blocks(m, t), w, m)
                 for t in (phi, sgn, g)), geoms,
               masks or [None] * len(geoms))]
    assert torch.equal(gather_blocks(m, [r[0] for r in res]), solo[0])
    assert torch.equal(gather_blocks(m, [r[1] for r in res]), solo[1])
    assert rel(sum(float(r[2]) for r in res), solo[2]) <= 1e-12
    assert rel(sum(float(r[3]) for r in res), solo[3]) <= 1e-12


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mesh_shape", MESHES)
def test_minmax_block_vjp_bitwise_equals_solo_plain(mesh_shape, dtype):
    phi, sgn, g = fields(dtype)
    phi = wc.reinit_step_plain(0.5 * phi, sgn, DX, H)
    m = make_mesh(mesh_shape, ["cpu"])
    solo = mc.minmax_step_vjp_plain(phi, g, DX, H1)
    assert not torch.equal(solo[0], g)
    w = sh.sharded_widths(m, wc.VJP_HALO["minmax"])
    geoms = sh.minmax_geoms(m, N, w)
    res = [mc.minmax_step_block_vjp(p, q, DX, H1, ge) for p, q, ge in zip(
        halo_exchange(split_blocks(m, phi), w, m),
        halo_exchange(split_blocks(m, g), w, m), geoms)]
    assert torch.equal(gather_blocks(m, [r[0] for r in res]), solo[0])
    assert rel(sum(float(r[1]) for r in res), solo[1]) <= 1e-12
    assert rel(sum(float(r[2]) for r in res), solo[2]) <= 1e-12


def _grads(fn, x0, w, scalars):
    """Value and gradients of ``sum(w * fn(x, *scalars))``: the input's and
    the 0-d scalars'."""
    x = x0.clone().requires_grad_(True)
    s = [torch.tensor(v, dtype=x0.dtype, requires_grad=True)
         for v in scalars]
    out = fn(x, *s)
    torch.sum(w * out).backward()
    return out.detach(), x.grad, [float(t.grad) for t in s]


def _sharded(fn, m):
    def run(x, *s):
        return gather_blocks(m, fn(m, split_blocks(m, x), *s))
    return run


@pytest.mark.parametrize("flat", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mesh_shape", [(2, 2, 1), (1, 2, 2)])
def test_reinit_fixed_sharded_bitwise_equals_solo(mesh_shape, dtype, flat,
                                                  monkeypatch):
    """Forward and gradient bitwise the solo solver's on the flat stash and
    on the sqrt-N recompute; the branch is recorded."""
    phi, _, w = fields(dtype)
    m = make_mesh(mesh_shape, ["cpu"])
    if not flat:
        monkeypatch.setattr(reverse, "_FLAT_TRAJ_BYTES", 0)
    reverse.last_branch.clear()
    ref = _grads(lambda x, dx, h: reinit_fixed(x, dx, h, 4), phi, w,
                 (DX, H))
    got = _grads(_sharded(lambda mm, b, dx, h: sh.reinit_fixed_sharded(
        mm, b, dx, h, 4), m), phi, w, (DX, H))
    assert torch.equal(got[0], ref[0]) and not torch.equal(got[0], phi)
    assert torch.equal(got[1], ref[1])
    assert all(rel(a, b) <= 1e-12 for a, b in zip(got[2], ref[2]))
    want = "flat" if flat else "sqrtn"
    assert reverse.last_branch == {"reinit_fixed": want,
                                   "reinit_fixed_sharded": want}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mesh_shape", [(2, 2, 1), (2, 2, 2)])
def test_minmax_fixed_sharded_bitwise_equals_solo(mesh_shape, dtype):
    phi, _, w = fields(dtype)
    phi = 0.5 * phi
    m = make_mesh(mesh_shape, ["cpu"])
    ref = _grads(lambda x, dx, h1: minmax_flow_fixed(x, dx, h1, 5), phi, w,
                 (DX, H1))
    got = _grads(_sharded(lambda mm, b, dx, h1: sh.minmax_fixed_sharded(
        mm, b, dx, h1, 5), m), phi, w, (DX, H1))
    assert torch.equal(got[0], ref[0]) and not torch.equal(got[0], phi)
    assert torch.equal(got[1], ref[1])
    assert all(rel(a, b) <= 1e-12 for a, b in zip(got[2], ref[2]))


def test_unused_blocks_get_zero_cotangents():
    """A loss that reads one block: the solvers' backward treats the other
    outputs' missing cotangents as zeros, and the gradient still reaches
    every input block through the halos."""
    phi, _, w = fields(torch.float64)
    m = make_mesh((2, 2, 1), ["cpu"])
    blocks = [b.requires_grad_(True) for b in split_blocks(m, phi)]
    out = sh.minmax_fixed_sharded(m, sh.reinit_fixed_sharded(
        m, blocks, DX, H, 3), DX, H1, 2)
    torch.sum(split_blocks(m, w)[0] * out[0]).backward()
    x = phi.clone().requires_grad_(True)
    ref = minmax_flow_fixed(reinit_fixed(x, DX, H, 3), DX, H1, 2)
    mask = torch.zeros_like(w)
    mask[:16, :12] = 1.0
    torch.sum(mask * w * ref).backward()
    grads = [b.grad for b in blocks]
    assert all(float(gb.abs().max()) > 0 for gb in grads)
    assert torch.equal(gather_blocks(m, grads), x.grad)


def test_sharded_solvers_raise_on_what_they_do_not_take():
    phi, _, _ = fields(torch.float32, (16, 16, 16))
    m = make_mesh((2, 2, 1), ["cpu"])
    m4 = make_mesh((4, 1, 1), ["cpu"])
    with pytest.raises(ValueError, match=">= 6 cells"):
        sh.reinit_fixed_sharded(m4, split_blocks(m4, phi), DX, H, 2)
    with pytest.raises(ValueError, match=">= 5 cells"):   # the half-width
        sh.minmax_fixed_sharded(m4, split_blocks(m4, phi), DX, H1, 2,
                                avg_halfwidth=5)
    odd = make_mesh((2, 1, 1), ["cpu"])
    with pytest.raises(ValueError, match="multiples of 8"):
        sh.reinit_fixed_sharded(odd, split_blocks(odd, torch.tensor(
            sphere((20, 16, 16)), dtype=torch.float32)), DX, H, 2,
            band_radius=4.1)
    grid = Grid3D(shape=(16, 16, 16), origin=(-1.2,) * 3, dx=2.4 / 15)
    v, f = _octahedron()
    with pytest.raises(ValueError, match="'auto' or None"):
        signed_distance_init_sharded(grid, v, f, m, culling=(
            build_init_culling(grid, v, f, block=8)))


@pytest.mark.parametrize("case", ["shape", "dtype", "halo"])
def test_adjoint_block_modes_raise_off_the_cpu(case):
    """Off the CPU the block-mode adjoints launch their kernels or raise:
    float64, a grid with an axis of 2 points or a block without its halo
    raises before any launch and never runs the plain version.  Meta
    tensors stand in for the card's."""
    m = make_mesh((2, 1, 1), ["cpu"])
    gshape = {"shape": (16, 2, 16)}.get(case, (16, 16, 16))
    w = 2 if case == "halo" else 6
    geom = sh.reinit_geoms(m, gshape, sh.sharded_widths(m, w))[0]
    shape = (8 + 2 * w, gshape[1], 16)
    dtype = torch.float64 if case == "dtype" else torch.float32
    pad = torch.empty(shape, dtype=dtype, device="meta")
    err = {"dtype": TypeError}.get(case, ValueError)
    with pytest.raises(err, match="reinit_step_block_vjp"):
        wc.reinit_step_block_vjp(pad, pad, pad, DX, H, geom)
    mgeom = sh.minmax_geoms(m, gshape, sh.sharded_widths(m, w))[0]
    if case == "halo":
        pad = torch.empty((8 + 2, 16, 16), dtype=dtype, device="meta")
        mgeom = sh.minmax_geoms(m, gshape, sh.sharded_widths(m, 1))[0]
    with pytest.raises(err, match="minmax_step_block_vjp"):
        mc.minmax_step_block_vjp(pad, pad, DX, H1, mgeom)


def _octahedron(scale=0.7):
    v = scale * np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                          [0, 0, 1], [0, 0, -1]], np.float64)
    f = np.array([[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4],
                  [2, 0, 5], [1, 2, 5], [3, 1, 5], [0, 3, 5]], np.int32)
    return v, f


@pytest.mark.parametrize("culling", [None, "auto"])
def test_sharded_init_vertex_cotangent_reaches_every_shard(culling):
    """Each block takes ``vertices.to(device)``: autograd adds the shards'
    vertex cotangents, equal to the whole-grid init's (float64, 1e-9 of
    max |grad|: per-block culling may break a tie the other way)."""
    v, f = _octahedron()
    grid = Grid3D(shape=(16, 16, 16), origin=(-1.2,) * 3, dx=2.4 / 15)
    m = make_mesh((2, 2, 1), ["cpu"])
    w = torch.tensor(np.random.default_rng(3).standard_normal(grid.shape))
    grads = []
    for sharded in (True, False):
        vt = torch.tensor(v, requires_grad=True)
        phi = (gather_blocks(m, signed_distance_init_sharded(
            grid, vt, f, m, dtype=torch.float64, culling=culling))
            if sharded else signed_distance_init(
                grid, vt, f, dtype=torch.float64, culling=culling))
        torch.sum(w * phi).backward()
        grads.append(vt.grad)
    scale = float(grads[1].abs().max())
    assert scale > 0
    np.testing.assert_allclose(grads[0].numpy(), grads[1].numpy(), rtol=0,
                               atol=1e-9 * scale)


def _jax_case(scale):
    n = (32, 32, 16)
    xs = [np.linspace(-1.2, 1.2, k) for k in n]
    gx, gy, gz = np.meshgrid(*xs, indexing="ij")
    phi0 = (scale * (np.sqrt(gx ** 2 + gy ** 2 + gz ** 2) - 0.6)).astype(
        np.float32)
    return phi0, 2.4 / 31, np.random.default_rng(1).standard_normal(
        n).astype(np.float32)


@pytest.mark.parametrize("solver", ["minmax", "reinit"])
def test_fixed_sharded_match_jax_pallas(eight_devices, solver):
    """The JAX package's fused sharded solvers on a (4, 2, 1) mesh of
    virtual CPU devices (Pallas in interpret mode, ``test_parallel.py:
    424-459``): min/max 5 steps as the JAX test runs it, reinit 2 steps
    (its 4-step test is marked slow)."""
    phi0, dx, w = _jax_case(1.0 if solver == "minmax" else 2.0)
    jmesh = jax_make_mesh((4, 2, 1), eight_devices)
    if solver == "minmax":
        h, steps = 0.05 * dx * dx, 5

        def jfn(p):
            return jsh.minmax_fixed_sharded(jmesh, p, dx, h, steps,
                                            use_pallas=True)

        def tfn(mm, b):
            return sh.minmax_fixed_sharded(mm, b, dx, h, steps)
    else:
        h, steps = 0.1 * dx, 2

        def jfn(p):
            return jsh.reinit_fixed_sharded(jmesh, p, dx, h, steps,
                                            use_pallas=True)

        def tfn(mm, b):
            return sh.reinit_fixed_sharded(mm, b, dx, h, steps)
    jw = jnp.asarray(w)
    jout = np.asarray(jax.device_get(jfn(jnp.asarray(phi0))))
    jgrad = np.asarray(jax.device_get(jax.grad(
        lambda p: jnp.sum(jw * jfn(p)))(jnp.asarray(phi0))))
    m = make_mesh((4, 2, 1), ["cpu"])
    out, grad, _ = _grads(_sharded(lambda mm, b: tfn(mm, b), m),
                          torch.tensor(phi0), torch.tensor(w), ())
    assert np.abs(jgrad).max() > 0
    np.testing.assert_allclose(out.numpy(), jout, atol=2e-6)
    np.testing.assert_allclose(grad.numpy(), jgrad, atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("n", [32, 24])
def test_sharded_init_on_aligned_blocks_is_the_whole_grid_init(n):
    """Blocks that are multiples of the culling block (16) hold the same
    point groups as the whole grid, so the selection scan (a quadratic form
    about each group's mean) rounds alike and the sharded init is the whole
    grid's bitwise.  Blocks of 12 regroup the points: a near-tie may then
    fall to the neighbouring triangle, the exact re-evaluation keeps the
    value within 1e-5, but that point's vertex gradient goes to other
    vertices (ROADMAP H13)."""
    from levelsetfortran_tpu_torch.models import analytic
    ball = analytic.icosphere_mesh(subdivisions=2)
    lo, hi = ball.vertices.min(0), ball.vertices.max(0)
    span = float((hi - lo).max()) * 1.2
    grid = Grid3D(shape=(n,) * 3, dx=span / (n - 1), origin=tuple(
        float(c) for c in (lo + hi) / 2 - span / 2))
    m = make_mesh((2, 2, 1), ["cpu"])
    whole = signed_distance_init(grid, ball.vertices, ball.elements)
    sharded = gather_blocks(m, signed_distance_init_sharded(
        grid, ball.vertices, ball.elements, m))
    if n == 32:
        assert torch.equal(sharded, whole)
    else:
        assert not torch.equal(sharded, whole)
        np.testing.assert_allclose(sharded.numpy(), whole.numpy(), rtol=0,
                                   atol=1e-5)
