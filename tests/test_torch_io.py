"""The port's STL/VTI/S3D readers and writers, procedural meshes, analytic
SDFs and grid sizing against the JAX package's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from levelsetfortran_tpu.grid import grid as jgrid
from levelsetfortran_tpu.io import s3d as js3d
from levelsetfortran_tpu.io import stl as jstl
from levelsetfortran_tpu.io import vti as jvti
from levelsetfortran_tpu.models import analytic as jan
from levelsetfortran_tpu_torch.grid import grid as tgrid
from levelsetfortran_tpu_torch.io import s3d as ts3d
from levelsetfortran_tpu_torch.io import stl as tstl
from levelsetfortran_tpu_torch.io import vti as tvti
from levelsetfortran_tpu_torch.models import analytic as tan

torch.set_num_threads(1)

MESHES = {
    "two_cubes": (jan.two_cubes_mesh, tan.two_cubes_mesh, {}),
    "icosphere2": (jan.icosphere_mesh, tan.icosphere_mesh,
                   {"subdivisions": 2}),
    "box3": (jan.box_mesh, tan.box_mesh, {"subdivisions": 3}),
}


def _same_mesh(a, b):
    np.testing.assert_array_equal(a.vertices, b.vertices)
    np.testing.assert_array_equal(a.elements, b.elements)
    np.testing.assert_array_equal(a.elem_order, b.elem_order)
    np.testing.assert_array_equal(a.elem_tag, b.elem_tag)
    np.testing.assert_array_equal(a.bnd_normals, b.bnd_normals)
    assert a.n_bnd_elem == b.n_bnd_elem


@pytest.mark.parametrize("name", sorted(MESHES))
def test_procedural_meshes_match(name):
    jf, tf, kw = MESHES[name]
    _same_mesh(jf(**kw), tf(**kw))


@pytest.mark.parametrize("name", ["two_cubes", "icosphere2"])
def test_stl_round_trips_both_ways(name, tmp_path):
    jf, tf, kw = MESHES[name]
    mesh = tf(**kw)
    tstl.write_stl(str(tmp_path / "port.stl"), mesh)
    jstl.write_stl(str(tmp_path / "jax.stl"), jf(**kw))
    for f in ("port.stl", "jax.stl"):
        _same_mesh(jstl.read_stl(str(tmp_path / f)),
                   tstl.read_stl(str(tmp_path / f)))
    _same_mesh(tstl.read_stl(str(tmp_path / "port.stl")), mesh)


def _signed_zero_stl(path):
    """A binary STL of the octahedron whose odd triangles write their zero
    coordinates as -0.0, as CAD exporters often do."""
    v = 0.7 * np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                        [0, 0, 1], [0, 0, -1]], np.float32)
    f = np.array([[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4],
                  [2, 0, 5], [1, 2, 5], [3, 1, 5], [0, 3, 5]])
    tri = v[f]
    odd = tri[1::2]
    odd[odd == 0] = -0.0
    tri[1::2] = odd
    rec = np.zeros((len(f), 50), np.uint8)
    rec[:, 12:48] = tri.reshape(len(f), 9).astype("<f4").view(
        np.uint8).reshape(len(f), 36)
    path.write_bytes(b" " * 80 + np.int32(len(f)).astype("<i4").tobytes()
                     + rec.tobytes())


def _noisy_rows():
    """The triangle rows of an icosphere of 81,920 triangles (245,760 rows)
    with CAD-like noise: one zero coordinate set to 1e-8, and a chain of
    rows 1e-8 apart by an ulp or two (within the tolerance of their
    neighbours, not of each other) and rows beside 2^-19."""
    rows = tan.icosphere_mesh(subdivisions=6).vertices[
        tan.icosphere_mesh(subdivisions=6).elements].reshape(-1, 3).astype(
        np.float32)
    at = np.flatnonzero(rows[:, 0] == 0)[0]
    rows[at, 0] = 1e-8
    e = np.float32(1e-8)
    chain = [e, np.nextafter(e, np.float32(1)), e,
             np.float32(e + 120 * np.spacing(e)),
             np.float32(e + 60 * np.spacing(e))]
    edge = [np.float32(2.0 ** -19), np.float32(2.0 ** -19 - 2.0 ** -43),
            np.float32(-(2.0 ** -19)), np.float32(2.0 ** -19)]
    extra = np.array([[c, 0.5, 0.25] for c in chain + edge], np.float32)
    return np.concatenate([rows[:1000], extra, rows[1000:], extra])


@pytest.mark.parametrize("case", ["rows", "tiny", "stl", "noisy"])
def test_dedup_merges_signed_zeros_as_the_native_hash(case, tmp_path,
                                                      monkeypatch):
    """Vertices equal within the reference's 1e-13 per coordinate are one
    node, as in the JAX package's native hash (``stl_dedup.cpp:69-71``):
    -0.0 merges with +0.0, the first occurrence keeping its bits ("rows";
    ROADMAP H22), tiny nonzero coordinates merge too ("tiny", the hash's
    own loop), an STL with signed zeros reads to the same mesh in both
    packages ("stl"), and a large mesh with a few noisy coordinates
    ("noisy") sends only the rows beside them through the loop (at most
    32 of 245,778; measured 17)."""
    from levelsetfortran_tpu import native
    if native.get_lib() is None:
        pytest.skip("the JAX package's native library cannot be built")
    if case == "noisy":
        rows = _noisy_rows()
        looped = []
        real = tstl._dedup_tolerance
        monkeypatch.setattr(tstl, "_dedup_tolerance", lambda r: (
            looped.append(len(r)) or real(r)))
        verts, inverse = tstl._dedup_vertices(rows)
        jverts, jinverse = jstl._dedup_vertices(rows)
        np.testing.assert_array_equal(inverse, jinverse)
        np.testing.assert_array_equal(verts.view(np.uint32),
                                      jverts.view(np.uint32))
        assert 0 < sum(looped) <= 32, looped
        return
    if case == "stl":
        _signed_zero_stl(tmp_path / "z.stl")
        ours = tstl.read_stl(str(tmp_path / "z.stl"))
        _same_mesh(jstl.read_stl(str(tmp_path / "z.stl")), ours)
        assert ours.n_nodes == 6
        return
    rows = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [-0.0, 0, 0],
                     [0, -1, 0], [1, 0, 0]], np.float32)
    if case == "tiny":
        rows = np.concatenate([rows, np.array(
            [[1e-14, 0, 0], [-3e-14, 0, 1], [2e-14, 0, 1], [5e-6, 0, 0]],
            np.float32)])
    verts, inverse = tstl._dedup_vertices(rows)
    jverts, jinverse = jstl._dedup_vertices(rows)
    np.testing.assert_array_equal(inverse, jinverse)
    np.testing.assert_array_equal(verts.view(np.uint32),
                                  jverts.view(np.uint32))
    assert inverse[:6].tolist() == [0, 1, 2, 0, 3, 1]


def test_ascii_stl(tmp_path):
    mesh = tan.two_cubes_mesh()
    tri = mesh.vertices[mesh.elements]
    lines = ["solid cubes"]
    for t in tri:
        lines += ["facet normal 0 0 0", "outer loop"]
        lines += [f"vertex {x:.9g} {y:.9g} {z:.9g}" for x, y, z in t]
        lines += ["endloop", "endfacet"]
    lines.append("endsolid cubes")
    (tmp_path / "a.stl").write_text("\n".join(lines))
    _same_mesh(jstl.read_stl(str(tmp_path / "a.stl")),
               tstl.read_stl(str(tmp_path / "a.stl")))


@pytest.mark.parametrize("name", ["two_cubes", "icosphere2"])
@pytest.mark.parametrize("dx,pad", [(0.1, 6), (0.05, 10), (0.13, 3)])
def test_from_surface_matches(name, dx, pad):
    jf, tf, kw = MESHES[name]
    v = tf(**kw).vertices
    a = jgrid.from_surface(v, dx, pad)
    b = tgrid.from_surface(v, dx, pad)
    assert a.shape == b.shape and a.origin == b.origin and a.dx == b.dx
    assert jgrid.surface_diag(v) == tgrid.surface_diag(v)
    np.testing.assert_array_equal(
        np.asarray(a.coords(jnp.float64)),
        b.coords(torch.float64).numpy())


def test_vti_round_trips_both_ways(tmp_path):
    grid = tgrid.from_bbox((0.0, -1.0, 0.5), (1.2, 0.3, 1.1), 0.1, 2)
    phi = np.random.default_rng(0).standard_normal(grid.shape)
    jgrid_ = jgrid.Grid3D(grid.shape, grid.origin, grid.dx)
    tvti.write_vti(str(tmp_path / "p.vti"), phi, grid)
    jvti.write_vti(str(tmp_path / "j.vti"), phi, jgrid_)
    assert (tmp_path / "p.vti").read_bytes() == (tmp_path / "j.vti").read_bytes()
    # the reference's bogus byte count (set3d.f90:330) reads back too
    jvti.write_vti(str(tmp_path / "q.vti"), phi, jgrid_, ref_compat=True)
    for reader in (jvti.read_vti, tvti.read_vti):
        for f in ("p.vti", "q.vti"):
            back, g = reader(str(tmp_path / f))
            np.testing.assert_array_equal(back, phi)
            assert tuple(g.shape) == grid.shape
            assert g.dx == pytest.approx(0.1)


def test_s3d_round_trips_both_ways(tmp_path):
    mesh = tan.icosphere_mesh(subdivisions=1)
    coords = mesh.vertices * 1.01
    ts3d.write_s3d(str(tmp_path / "p.s3d"), mesh, coords)
    js3d.write_s3d(str(tmp_path / "j.s3d"), mesh, coords)
    assert (tmp_path / "p.s3d").read_text() == (tmp_path / "j.s3d").read_text()
    a = js3d.read_s3d(str(tmp_path / "p.s3d"))
    b = ts3d.read_s3d(str(tmp_path / "p.s3d"))
    _same_mesh(a, b)
    np.testing.assert_array_equal(b.vertices, coords)


def test_analytic_sdfs_match():
    p = np.random.default_rng(1).uniform(-2, 13, size=(500, 3))
    pairs = [
        (jan.sdf_sphere(jnp.asarray(p), (0.1, 0.2, 0.3), 1.1),
         tan.sdf_sphere(p, (0.1, 0.2, 0.3), 1.1)),
        (jan.sdf_box(jnp.asarray(p), (1, 0, 0), (0.5, 1, 2)),
         tan.sdf_box(p, (1, 0, 0), (0.5, 1, 2))),
        (jan.sdf_torus(jnp.asarray(p), (0, 0, 1), 2.0, 0.5),
         tan.sdf_torus(p, (0, 0, 1), 2.0, 0.5)),
        (jan.sdf_two_cubes(jnp.asarray(p)), tan.sdf_two_cubes(p)),
    ]
    for a, b in pairs:
        np.testing.assert_allclose(np.asarray(a), b, rtol=0, atol=1e-12)
