"""Each kernel's count against a hand count at one small shape."""

import numpy as np
import pytest

from h100bench.reference import geometry
from h100bench.roofline import bound_s, k5, k7

FLOPS = 67e12


def test_bound_is_the_larger_of_the_two():
    assert bound_s(ops=67e9) == pytest.approx(1e-3)
    assert bound_s(nbytes=3.35e9) == pytest.approx(1e-3)
    assert bound_s(ops=67e9, nbytes=6.7e9) == pytest.approx(2e-3)


def test_k7_one_triangle_one_block():
    """One triangle in a grid of one 16^3 block: 4096 pairs, 70
    operations each."""
    soup = np.array([[[0.0, 0.0, 0.0], [0.5, 0.0, 0.0], [0.0, 0.5, 0.0]]],
                    np.float32)
    verts, elems = geometry.soup_mesh(soup)
    grid = geometry.Grid((16, 16, 16), (-0.2, -0.2, -0.2), 0.05)
    rows = geometry.culling_rows(grid, verts, elems)
    assert rows.pairs == 4096
    assert k7.bound_s(rows.pairs) == pytest.approx(70 * 4096 / FLOPS)


def test_k7_counts_every_block_of_the_grid():
    """Two blocks per axis of 8^3 blocks, every candidate kept."""
    soup = np.array([[[0.0, 0.0, 0.0], [0.5, 0.0, 0.0], [0.0, 0.5, 0.0]],
                     [[0.0, 0.0, 0.3], [0.5, 0.0, 0.3], [0.0, 0.5, 0.3]]],
                    np.float32)
    verts, elems = geometry.soup_mesh(soup)
    grid = geometry.Grid((16, 16, 16), (-0.2, -0.2, -0.2), 0.05)
    rows = geometry.culling_rows(grid, verts, elems, block=8)
    assert rows.counts.size == 8
    assert rows.pairs == int(rows.counts.sum()) * 512
    assert set(rows.counts.tolist()) <= {1, 2}


def test_k5_operations():
    assert k5.bound_s(2, 10 ** 6) == pytest.approx(2 * 1600e6 / FLOPS)


def test_culling_is_the_programs():
    """The frozen culling keeps, per block, the triangles the program's
    culling keeps."""
    from levelsetfortran_tpu_torch.grid.grid import Grid3D
    from levelsetfortran_tpu_torch.ops.init_sign import build_init_culling
    from h100bench import meshes
    verts, elems = geometry.soup_mesh(meshes.icosphere_soup(subdivisions=3))
    grid = geometry.from_surface(verts, 0.05, 4)
    rows = geometry.culling_rows(grid, verts, elems, margin=0.02)
    theirs = build_init_culling(Grid3D(grid.shape, grid.origin, grid.dx),
                                verts, elems, margin=0.02, bucketed=False)
    cand = theirs.cand_idx
    for r, b in enumerate(rows.bidx):
        mine = rows.flat[rows.offsets[r]:rows.offsets[r] + rows.counts[r]]
        want = cand[b][cand[b] < len(elems)]
        assert np.array_equal(mine, want)
