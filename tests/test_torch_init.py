"""The port's exact signed-distance init against the JAX package's, culled
and dense, on the twoCube10 twin and a subdivided icosphere at dx 0.1.

Tolerances: float64 atol 1e-10, float32 atol 1e-5 (distances up to ~4,
rounded in another order).  Points lying exactly ON the surface may take
either sign (the tie sum of the pseudonormals is rounding noise there), but
their |phi| is below the tolerance either way.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from levelsetfortran_tpu.grid import grid as jgrid
from levelsetfortran_tpu.ops import init_sign as jinit
from levelsetfortran_tpu_torch.grid import grid as tgrid
from levelsetfortran_tpu_torch.models.analytic import (icosphere_mesh,
                                                       two_cubes_mesh)
from levelsetfortran_tpu_torch.ops import init_sign as tinit

torch.set_num_threads(1)
MESHES = {"two_cubes": two_cubes_mesh,
          "icosphere2": lambda: icosphere_mesh(subdivisions=2)}
DTYPES = {"float64": (jnp.float64, torch.float64, 1e-10),
          "float32": (jnp.float32, torch.float32, 1e-5)}


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("culling", ["auto", None])
def test_init_matches_jax(mesh, dtype, culling):
    m = MESHES[mesh]()
    jdt, tdt, atol = DTYPES[dtype]
    grid = tgrid.from_surface(m.vertices, 0.1, 3)
    ref = jinit.signed_distance_init(
        jgrid.Grid3D(grid.shape, grid.origin, grid.dx),
        jnp.asarray(m.vertices, jdt), jnp.asarray(m.elements), dtype=jdt,
        culling=culling)
    out = tinit.signed_distance_init(grid, m.vertices, m.elements,
                                     dtype=tdt, culling=culling)
    assert out.dtype == tdt and tuple(out.shape) == grid.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=atol)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_culling_tables_match_jax(mesh):
    m = MESHES[mesh]()
    grid = tgrid.from_surface(m.vertices, 0.1, 3)
    a = jinit.build_init_culling(
        jgrid.Grid3D(grid.shape, grid.origin, grid.dx), m.vertices,
        m.elements, tile=512)
    b = tinit.build_init_culling(grid, m.vertices, m.elements, tile=512)
    assert (a.block, a.nblocks) == (b.block, b.nblocks)
    assert len(a.cands) == len(b.cands)
    for ca, cb, ia, ib in zip(a.cands, b.cands, a.bidxs, b.bidxs):
        np.testing.assert_array_equal(np.asarray(ca), cb)
        np.testing.assert_array_equal(np.asarray(ia), ib)


def test_point_triangle_closest_matches_jax():
    rng = np.random.default_rng(0)
    p = rng.uniform(-2, 2, (400, 1, 3))
    tri = rng.uniform(-1, 1, (1, 50, 3, 3))
    args = [p] + [tri[..., i, :] for i in range(3)]
    ref = jinit.point_triangle_closest(*map(jnp.asarray, args))
    out = tinit.point_triangle_closest(*map(torch.from_numpy, args))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-12)


def test_init_uses_no_matmul(monkeypatch):
    """TF32 guard: no matmul-class op may reach the init's dot products,
    so a process-wide allow_tf32 cannot change them on the card."""
    def refuse(*a, **k):
        raise AssertionError("matmul in the init")
    for name in ("matmul", "mm", "bmm", "einsum", "tensordot"):
        monkeypatch.setattr(torch, name, refuse)
    monkeypatch.setattr(torch.Tensor, "__matmul__", refuse)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    m = two_cubes_mesh()
    grid = tgrid.from_surface(m.vertices, 0.2, 2)
    out = tinit.signed_distance_init(grid, m.vertices, m.elements)
    assert torch.isfinite(out).all()
