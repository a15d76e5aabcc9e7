"""The port's ``.s3d`` writer formats a block of rows per call: the bytes
equal the JAX package's writer (one formatted line per row) for every
mesh, coordinate dtype, special value and block size, and the writes and
blocks are counted."""

import dataclasses

import numpy as np
import pytest
import torch

from levelsetfortran_tpu.io import s3d as js3d
from levelsetfortran_tpu_torch.io import s3d as ts3d
from levelsetfortran_tpu_torch.io.stl import SurfaceMesh
from levelsetfortran_tpu_torch.models import analytic
from levelsetfortran_tpu_torch.utils import profiling

#: NaN, infinities, signed zeros, subnormals, huge values: per dtype.
SPECIAL = {
    np.float64: [np.nan, np.inf, -np.inf, -0.0, 0.0, 5e-324, -2.2e-310,
                 1e300, -1e300, 1.0, -0.1, 123456.789],
    np.float32: [np.nan, np.inf, -np.inf, -0.0, 0.0, 1e-45, -1e-40, 3e38,
                 -3e38, 1.0, -0.1, 123456.789],
}


def _jittered(mesh: SurfaceMesh, seed: int = 0) -> np.ndarray:
    """Advected-looking float64 nodes: the vertices moved a little."""
    rng = np.random.default_rng(seed)
    return mesh.vertices + rng.normal(scale=1e-3, size=mesh.vertices.shape)


def _rows_mesh(n: int) -> SurfaceMesh:
    """n elements, n nodes and n boundary rows, each section n rows."""
    rng = np.random.default_rng(n)
    return SurfaceMesh(
        vertices=rng.normal(size=(n, 3)),
        elements=rng.integers(0, n, size=(n, 3)).astype(np.int32),
        elem_order=np.ones(n, np.int32),
        elem_tag=np.arange(n, dtype=np.int32),
        bnd_normals=rng.normal(size=(n, 3)), n_bnd_elem=n)


def _special(dtype=np.float64) -> tuple:
    mesh = analytic.icosphere_mesh(subdivisions=1)
    coords = _jittered(mesh).astype(dtype)
    values = np.array(SPECIAL[dtype], dtype=dtype)
    coords.flat[:len(values)] = values
    coords.flat[-len(values):] = values[::-1]
    return mesh, coords


def _int64() -> tuple:
    mesh = analytic.icosphere_mesh(subdivisions=2)
    wide = SurfaceMesh(
        vertices=mesh.vertices, elements=mesh.elements.astype(np.int64),
        elem_order=mesh.elem_order.astype(np.int64),
        elem_tag=np.arange(mesh.n_elems, dtype=np.int64) - 7,
        bnd_normals=mesh.bnd_normals, n_bnd_elem=mesh.n_bnd_elem)
    return wide, _jittered(wide)


def _no_boundary() -> tuple:
    mesh = analytic.box_mesh(subdivisions=1)
    return dataclasses.replace(mesh, bnd_normals=np.zeros((0, 3))), None


def _with_coords(make, coords=_jittered):
    def case():
        mesh = make()
        return mesh, None if coords is None else coords(mesh)
    return case


CASES = {
    **{f"icosphere{s}": _with_coords(
        lambda s=s: analytic.icosphere_mesh(subdivisions=s))
       for s in range(6)},
    "box": _with_coords(lambda: analytic.box_mesh(subdivisions=3)),
    "two_cubes": _with_coords(analytic.two_cubes_mesh),
    "coords_none": _with_coords(
        lambda: analytic.icosphere_mesh(subdivisions=2), None),
    "float32": _with_coords(
        lambda: analytic.icosphere_mesh(subdivisions=2),
        lambda m: _jittered(m).astype(np.float32)),
    "special_values": _special,
    "special_values_float32": lambda: _special(np.float32),
    "int64_elements": _int64,
    "no_boundary_rows": _no_boundary,
}


def _bytes_of(writer, path, mesh, coords) -> bytes:
    writer(str(path), mesh, coords)
    return path.read_bytes()


@pytest.mark.parametrize("name", sorted(CASES))
def test_bytes_equal_the_jax_writer(name, tmp_path):
    mesh, coords = CASES[name]()
    want = _bytes_of(js3d.write_s3d, tmp_path / "j.s3d", mesh, coords)
    assert _bytes_of(ts3d.write_s3d, tmp_path / "p.s3d", mesh,
                     coords) == want


@pytest.mark.parametrize("rows", [6, 7, 8, 15])
def test_bytes_equal_the_jax_writer_at_seven_rows_a_block(rows, tmp_path,
                                                          monkeypatch):
    monkeypatch.setattr(ts3d, "_ROWS", 7)
    mesh = _rows_mesh(rows)
    coords = _jittered(mesh)
    want = _bytes_of(js3d.write_s3d, tmp_path / "j.s3d", mesh, coords)
    assert _bytes_of(ts3d.write_s3d, tmp_path / "p.s3d", mesh,
                     coords) == want


def _counted(mesh, path) -> dict:
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        profiling._counters.clear()
        ts3d.write_s3d(str(path), mesh)
        got = profiling.counters()
    profiling._counters.clear()
    return got


def test_writes_and_blocks_counted(tmp_path, monkeypatch):
    """One write; a block per section for the cells' mesh; at 7 rows a
    block, 15 elements, 10 nodes and one boundary row take 3 + 2 + 1."""
    ico = analytic.icosphere_mesh(subdivisions=5)
    assert _counted(ico, tmp_path / "a.s3d") == {"s3d.writes": 1,
                                                  "s3d.blocks": 3}
    rng = np.random.default_rng(3)
    small = SurfaceMesh(
        vertices=rng.normal(size=(10, 3)),
        elements=rng.integers(0, 10, size=(15, 3)).astype(np.int32),
        elem_order=np.ones(15, np.int32), elem_tag=np.zeros(15, np.int32),
        bnd_normals=np.zeros((1, 3)), n_bnd_elem=0)
    monkeypatch.setattr(ts3d, "_ROWS", 7)
    assert _counted(small, tmp_path / "b.s3d") == {"s3d.writes": 1,
                                                    "s3d.blocks": 6}
