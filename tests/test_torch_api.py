"""The public helpers of the port against the JAX package (float64 on the
CPU, inputs from numpy seeds):

* ``nearest_triangle``, ``nearest_sign_scan`` and ``pseudonormal_sign`` on
  seeded points around ``icosphere_mesh(2)`` and ``box_mesh()``: the
  squared distances at 1e-12, the argmin triangles and the signs equal on
  every point whose second-nearest triangle is more than ``rel_tie`` (1e-3)
  farther than the nearest (ROADMAP H11: ties are decided by rounding);
* ``Grid3D.upper`` / ``.n_points`` / ``.diag``, ``SurfaceMesh.centroids``
  / ``.bbox`` and ``common_shape_grids(multiple_of=(8, 8, 1))``: equal;
* every name of the JAX package's ``ops`` and of its top level (eager and
  lazy) resolves in the port;
* ``examples/render_stl_torch.py`` renders the icosphere on the CPU at a
  small grid.
"""

import importlib.util
import inspect
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import levelsetfortran_tpu
import levelsetfortran_tpu.ops as jax_ops
import levelsetfortran_tpu_torch
import levelsetfortran_tpu_torch.ops as ops
from levelsetfortran_tpu.grid.grid import from_surface as jax_from_surface
from levelsetfortran_tpu.io.stl import SurfaceMesh as JaxSurfaceMesh
from levelsetfortran_tpu.ops import init_sign as jax_init
from levelsetfortran_tpu.pipeline.batch import \
    common_shape_grids as jax_common_shape_grids
from levelsetfortran_tpu_torch.grid.grid import from_surface
from levelsetfortran_tpu_torch.models.analytic import box_mesh, icosphere_mesh
from levelsetfortran_tpu_torch.ops import init_sign
from levelsetfortran_tpu_torch.pipeline.batch import common_shape_grids

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL_TIE = 1e-3
MESHES = {"icosphere": lambda: icosphere_mesh(subdivisions=2),
          "box": lambda: box_mesh(half_extent=(0.8, 0.5, 0.3),
                                  subdivisions=2)}


def points_around(mesh, n=300, seed=0):
    lo, hi = mesh.bbox()
    c, h = (lo + hi) / 2, 0.65 * (hi - lo)
    return c + h * np.random.default_rng(seed).uniform(-1, 1, (n, 3))


def untied(points, tri):
    """Points whose second-nearest triangle is more than REL_TIE farther
    (brute force, numpy float64, the JAX package's host helper)."""
    E = tri.shape[0]
    d = np.stack([jax_init._np_point_tri_d2(
        points, np.broadcast_to(tri[e], (len(points), 3, 3)))
        for e in range(E)], axis=1)
    s = np.sort(d, axis=1)
    return s[:, 1] > s[:, 0] * (1.0 + REL_TIE) + 1e-12


@pytest.mark.parametrize("name", list(MESHES))
def test_nearest_triangle_and_signs_match_jax(name):
    mesh = MESHES[name]()
    tri = mesh.vertices[mesh.elements]
    pts = points_around(mesh)
    ok = untied(pts, tri)
    assert ok.sum() > 0.4 * len(pts)     # the rest: an edge or a vertex
    tp, tt = torch.tensor(pts), torch.tensor(tri)
    jp, jt = jnp.asarray(pts), jnp.asarray(tri)

    d2, idx = ops.nearest_triangle(tp, tt, tile=64)
    jd2, jidx = jax_ops.nearest_triangle(jp, jt, tile=64)
    assert np.abs(d2.numpy() - np.asarray(jd2)).max() <= 1e-12
    np.testing.assert_array_equal(idx.numpy()[ok], np.asarray(jidx)[ok])

    sd2, acc = init_sign.nearest_sign_scan(tp, tt, tile=64)
    jsd2, jacc = jax_init.nearest_sign_scan(jp, jt, tile=64)
    assert np.abs(sd2.numpy() - np.asarray(jsd2)).max() <= 1e-12
    np.testing.assert_array_equal(np.sign(acc.numpy())[ok],
                                  np.sign(np.asarray(jacc))[ok])

    pn = init_sign.pseudonormal_sign(tp, tt, d2, tile=64)
    jpn = jax_init.pseudonormal_sign(jp, jt, jd2, tile=64)
    np.testing.assert_array_equal(np.sign(pn.numpy())[ok],
                                  np.sign(np.asarray(jpn))[ok])
    inside = np.sign(pn.numpy()) < 0
    assert 0 < inside.sum() < len(pts)


def test_nearest_sign_scan_gradient_flows_through_the_distance():
    mesh = MESHES["icosphere"]()
    v = torch.tensor(mesh.vertices, requires_grad=True)
    tri = v[torch.as_tensor(mesh.elements, dtype=torch.long)]
    d2, _ = init_sign.nearest_sign_scan(torch.tensor(points_around(mesh)),
                                        tri)
    d2.sum().backward()
    assert float(v.grad.abs().max()) > 0


def test_grid_and_mesh_properties_match_jax():
    mesh = MESHES["box"]()
    jmesh = JaxSurfaceMesh(mesh.vertices, mesh.elements, mesh.elem_order,
                           mesh.elem_tag, mesh.bnd_normals, mesh.n_bnd_elem)
    np.testing.assert_array_equal(mesh.centroids(), jmesh.centroids())
    for a, b in zip(mesh.bbox(), jmesh.bbox()):
        np.testing.assert_array_equal(a, b)
    g = from_surface(mesh.vertices, 0.07, 5)
    j = jax_from_surface(mesh.vertices, 0.07, 5)
    assert (g.shape, g.origin, g.upper, g.n_points, g.diag) == \
        (j.shape, j.origin, j.upper, j.n_points, j.diag)


def test_common_shape_grids_multiple_of_matches_jax():
    meshes = [MESHES["box"](), MESHES["icosphere"]()]
    got = common_shape_grids(meshes, 0.05, 4, multiple_of=(8, 8, 1))
    want = jax_common_shape_grids(meshes, 0.05, 4, multiple_of=(8, 8, 1))
    assert [(g.shape, g.origin, g.dx) for g in got] == \
        [(g.shape, g.origin, g.dx) for g in want]
    assert got[0].shape[0] % 8 == 0 and got[0].shape[1] % 8 == 0
    assert got[0].shape != common_shape_grids(meshes, 0.05, 4)[0].shape


def _public(module):
    return {n for n, v in vars(module).items()
            if not n.startswith("_") and not inspect.ismodule(v)
            and n not in ("annotations",)}


def test_every_jax_ops_name_resolves_in_the_port():
    names = _public(jax_ops)
    assert len(names) >= 20
    assert sorted(n for n in names if not hasattr(ops, n)) == []


def test_every_jax_top_level_name_resolves_in_the_port():
    with open(inspect.getsourcefile(levelsetfortran_tpu)) as f:
        lazy = set(re.findall(r'if name == "(\w+)"', f.read()))
    assert {"reinit", "minmax_flow", "advect_nodes",
            "ShardedLevelSet"} <= lazy
    names = (_public(levelsetfortran_tpu) | lazy) - {"__version__"}
    assert sorted(n for n in names
                  if not hasattr(levelsetfortran_tpu_torch, n)) == []


def test_render_example_runs_on_the_cpu(tmp_path):
    spec = importlib.util.spec_from_file_location(
        "render_stl_torch", os.path.join(ROOT, "examples",
                                         "render_stl_torch.py"))
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    out = tmp_path / "r.ppm"
    hit = example.main(["--device", "cpu", "--dx", "0.15", "--size", "24",
                        "--out", str(out)])
    assert 0.02 < hit < 0.9
    assert out.read_bytes().startswith(b"P5\n24 24\n255\n")
    assert np.load(tmp_path / "r_depth.npy").shape == (24, 24)
