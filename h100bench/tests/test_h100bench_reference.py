"""The frozen plain reference against the program's plain CPU route on
tiny twins of the cells' bodies."""

import numpy as np
import pytest
import torch

import levelsetfortran_tpu_torch as lsf
from levelsetfortran_tpu_torch.io.stl import _finish
from levelsetfortran_tpu_torch.ops.init_sign import build_init_culling

from h100bench import meshes
from h100bench.reference import geometry, pipeline as ref
from h100bench.tests.tiny import CAPS

BODIES = {"sphere": (meshes.icosphere_soup(subdivisions=2), 0.1),
          "two_cubes": (meshes.two_cubes_soup(spacing=3.0), 0.15)}


def _cfg(dx, **kw):
    return lsf.LevelSetConfig(dx=dx, pad_cells=5, device="cpu", **CAPS, **kw)


@pytest.mark.parametrize("body", sorted(BODIES))
def test_run_mesh_matches(body):
    soup, dx = BODIES[body]
    soup = meshes.transform(soup, 1.01, (0.3, 0.2, 1.0), 0.4)
    got = lsf.run_mesh(_finish(soup.reshape(-1, 3)), _cfg(dx))
    want = ref.run_mesh(soup, dx, 5, CAPS, "cpu")
    assert got.grid.shape == want["shape"]
    assert (got.reinit_iters, got.minmax_iters) == (want["reinit_iters"],
                                                    want["minmax_iters"])
    for name in ("phi_init", "phi_smoothed", "phi_final"):
        assert np.max(np.abs(getattr(got, name) - want[name])) <= 1e-6 * dx
    assert np.max(np.abs(got.advected - want["advected"])) <= 1e-6 * dx


def test_run_batch_matches():
    soups = [meshes.transform(BODIES["two_cubes"][0], s, (0, 0, 1), 0.0)
             for s in (0.98, 1.02)]
    items = lsf.run_batch([_finish(s.reshape(-1, 3)) for s in soups],
                          _cfg(0.15))
    wants = ref.run_batch(soups, 0.15, 5, CAPS, "cpu")
    for it, want in zip(items, wants):
        assert (it.reinit_iters, it.minmax_iters) == (
            want["reinit_iters"], want["minmax_iters"])
        for name in ("phi_init", "phi_smoothed"):
            assert np.max(np.abs(getattr(it, name) - want[name])) <= 1.5e-7
        assert np.max(np.abs(it.advected - want["advected"])) <= 1.5e-7


def test_image_grad_matches():
    soup = meshes.icosphere_soup(subdivisions=1)
    verts, elems = geometry.soup_mesh(soup)
    grid = geometry.cube_grid(verts, 24)
    moved = meshes.transform(verts, 1.02, (1.0, 0.0, 0.0), 0.03)
    kw = dict(eye=(0.0, -3.0, 0.0), target=(0.0, 0.0, 0.0), reinit_steps=4,
              minmax_steps=3, height=12, width=12, n_march_steps=32)
    port_grid = lsf.Grid3D(grid.shape, grid.origin, grid.dx)
    cull = build_init_culling(port_grid, verts, elems, margin=0.06)
    loss, g = lsf.image_loss_and_vertex_grad(
        torch.as_tensor(moved), elems, port_grid, torch.zeros(12, 12),
        culling=cull, **kw)
    rows = geometry.culling_rows(grid, verts, elems, margin=0.06)
    want_loss, want_g = ref.image_grad(moved, elems, grid, rows,
                                       device="cpu", **kw)
    assert float(loss) > 0 and np.abs(want_g).max() > 0
    assert abs(float(loss) - want_loss) <= 1e-6 * want_loss
    assert np.abs(g.numpy() - want_g).max() <= 1e-4 * np.abs(want_g).max()
