"""The reference-mode init of the port (``init_mode="reference"``,
``ops/init_sign.py:initialize_sign_field``) against the JAX package's.

``subbox_ranges`` and ``orientation_sign`` are exact.  The nearest-centroid
search forms ``|c|^2 - 2 p.c`` elementwise where the JAX package uses a
HIGHEST-precision matmul, so where two centroids are (nearly) equidistant
the roundings may pick different ones (XLA itself does not pick alike
inside and outside jit).  Indices and fields are held equal except at such
near-ties, counted and capped; fields within 1e-12 in float64 and 1e-5 in
float32 (the triple product cancels at the far cube, |x| up to 12:
measured 3.4e-6).  A point is a near-tie when its two nearest centroids' float64
squared distances differ by at most
* float64: a relative 1e-6 (measured 5.5e-16 on the cubes, whose grid
  points sit exactly between coplanar centroids);
* float32: the formula's rounding scale, 16 eps32 (|c|^2 + 2 |p| |c|).
"""

import dataclasses
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import levelsetfortran_tpu.ops.init_sign as jax_init
import levelsetfortran_tpu.pipeline.run  # noqa: F401
from levelsetfortran_tpu.config import LevelSetConfig as JaxConfig
from levelsetfortran_tpu.grid import grid as jax_grid
from levelsetfortran_tpu.models.analytic import \
    icosphere_mesh as jax_icosphere
from levelsetfortran_tpu.pipeline.batch import run_batch as jax_run_batch
from levelsetfortran_tpu_torch.config import LevelSetConfig
from levelsetfortran_tpu_torch.grid import grid as gridmod
from levelsetfortran_tpu_torch.io.stl import write_stl
from levelsetfortran_tpu_torch.models.analytic import (icosphere_mesh,
                                                       two_cubes_mesh)
from levelsetfortran_tpu_torch.ops import init_sign
from levelsetfortran_tpu_torch.pipeline import cli
from levelsetfortran_tpu_torch.pipeline import run as port_run
from levelsetfortran_tpu_torch.pipeline.batch import run_batch

torch.set_num_threads(1)
jax_run = sys.modules["levelsetfortran_tpu.pipeline.run"]

MESHES = {"cubes": (two_cubes_mesh, 0.1), "icosphere": (
    lambda: icosphere_mesh(subdivisions=2), 0.05)}
#: Near-tie mismatches allowed per (mesh, dtype), of the sub-box's 36,414 /
#: 36,703 (cubes) and 97,336 / 110,592 (icosphere) points in float64 /
#: float32: nearest indices (measured 155, 121, 0, 224) and field values
#: (measured 133, 53, 0, 0).
CAPS_INDEX = {("cubes", "float64"): 250, ("cubes", "float32"): 250,
              ("icosphere", "float64"): 0, ("icosphere", "float32"): 350}
CAPS_FIELD = {("cubes", "float64"): 250, ("cubes", "float32"): 100,
              ("icosphere", "float64"): 0, ("icosphere", "float32"): 20}


def test_subbox_ranges_exact():
    mesh = two_cubes_mesh()
    for dx, pad, margin in ((0.1, 6, 3), (0.07, 2, 5), (0.25, 0, 3)):
        g = gridmod.from_surface(mesh.vertices, dx, pad)
        jg = jax_grid.from_surface(mesh.vertices, dx, pad)
        for dt in (np.float32, np.float64):
            v = mesh.vertices.astype(dt)
            lo, hi = v.min(0), v.max(0)
            assert init_sign.subbox_ranges(g, lo, hi, margin) == \
                jax_init.subbox_ranges(jg, lo, hi, margin)


def test_orientation_sign_exact():
    rng = np.random.default_rng(0)
    pts = rng.standard_normal((500, 3))
    tri = rng.standard_normal((500, 3, 3))
    ours = init_sign.orientation_sign(torch.tensor(pts), torch.tensor(tri))
    ref = jax_init.orientation_sign(jnp.asarray(pts), jnp.asarray(tri))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    # the sign of a CCW-outward triangle: + outside, - inside
    t = torch.tensor([[[0.0, 0, 0], [1, 0, 0], [0, 1, 0]]])
    s = init_sign.orientation_sign(torch.tensor([[0.2, 0.2, 1.0],
                                                 [0.2, 0.2, -1.0]]), t)
    assert s[0] > 0 > s[1]


def _subbox_points(grid, vertices, dtype):
    """The sub-box and its grid points as the init forms them (JAX
    ``init_sign.py:1110-1114``)."""
    v = vertices.astype(dtype)
    rng = init_sign.subbox_ranges(grid, v.min(0), v.max(0))
    axes = [grid.origin[a] + grid.dx * (i0 + torch.arange(
        i1 - i0 + 1, dtype=getattr(torch, dtype)))
        for a, (i0, i1) in enumerate(rng)]
    pts = torch.stack(torch.meshgrid(*axes, indexing="ij"), -1)
    return rng, pts.reshape(-1, 3)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("name", ["cubes", "icosphere"])
def test_nearest_centroid_and_sign_field_against_jax(name, dtype):
    make, dx = MESHES[name]
    mesh = make()
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    g = gridmod.from_surface(mesh.vertices, dx, 6)
    jg = jax_grid.from_surface(mesh.vertices, dx, 6)
    v = torch.tensor(mesh.vertices, dtype=tdt)
    cen = v[torch.as_tensor(mesh.elements, dtype=torch.long)].mean(dim=1)
    rng, pts = _subbox_points(g, mesh.vertices, dtype)
    ours = init_sign.nearest_centroid(pts, cen).numpy()
    ref = np.asarray(jax_init.nearest_centroid(jnp.asarray(pts.numpy()),
                                               jnp.asarray(cen.numpy())))
    diff = ours != ref
    assert diff.sum() <= CAPS_INDEX[name, dtype], diff.sum()
    assert _near_ties(pts[diff], cen, dtype).all()

    field = init_sign.initialize_sign_field(g, mesh.vertices,
                                            mesh.elements, dtype=tdt)
    jfield = np.asarray(jax_init.initialize_sign_field(
        jg, jnp.asarray(mesh.vertices, jdt), jnp.asarray(mesh.elements),
        dtype=jdt))
    assert field.dtype == tdt and tuple(field.shape) == g.shape
    # the fields differ only where the nearest centroid is a near-tie
    (i0, i1), (j0, j1), (k0, k1) = rng
    box = (slice(i0, i1 + 1), slice(j0, j1 + 1), slice(k0, k1 + 1))
    tol = 1e-12 if dtype == "float64" else 1e-5
    off = (np.abs(field.numpy()[box] - jfield[box]) > tol).reshape(-1)
    assert off.sum() <= CAPS_FIELD[name, dtype], off.sum()
    assert _near_ties(pts[off], cen, dtype).all()
    outside = np.ones(g.shape, bool)
    outside[box] = False
    assert outside.any()
    assert np.all(field.numpy()[outside] == 1.0) and \
        np.all(jfield[outside] == 1.0)
    assert np.abs(field.numpy()).max() <= 1.0


def _near_ties(pts, cen, dtype):
    """Whether each point's two nearest centroids are within the rounding
    of the distance formula (float64 squared distances; see the module
    docstring)."""
    p, c = pts.double().numpy(), cen.double().numpy()
    d2 = np.sort(np.sum((p[:, None] - c[None]) ** 2, -1), axis=1)
    gap = d2[:, 1] - d2[:, 0]
    if dtype == "float64":
        return gap <= 1e-6 * d2[:, 1]
    cn = np.max(np.sum(c * c, -1))
    scale = cn + 2 * np.sqrt(np.sum(p * p, -1) * cn)
    return gap <= 16 * np.finfo(np.float32).eps * scale


def _cfg_pair(**kw):
    base = dict(dx=0.1, pad_cells=6, reinit_iters=60, reinit_tol=0.0,
                minmax_iters=12, minmax_tol=0.0, advect_iters=10,
                final_reinit_iters=4, init_mode="reference",
                dtype=jnp.float64)
    base.update(kw)
    jcfg = JaxConfig(**base)
    return jcfg, LevelSetConfig.from_reference_fields(
        dataclasses.asdict(jcfg), device="cpu")


def test_run_mesh_reference_init_matches_jax_float64():
    """Default routing, float64: both packages run every stage dense (the
    reference init's dense initial reinit; float64, H14); every output
    within 1e-9 (measured 5.6e-16)."""
    jcfg, cfg = _cfg_pair()
    assert cfg.init_mode == "reference"
    ours = port_run.run_mesh(icosphere_mesh(subdivisions=2), cfg)
    ref = jax_run.run_mesh(jax_icosphere(subdiv=2), jcfg)
    assert (ours.reinit_iters, ours.minmax_iters) == (
        ref.reinit_iters, ref.minmax_iters) == (60, 12)
    for f in ("phi_init", "phi_smoothed", "phi_final", "advected"):
        np.testing.assert_allclose(getattr(ours, f), getattr(ref, f),
                                   rtol=0, atol=1e-9, err_msg=f)
    assert ours.asymptotic_error == pytest.approx(ref.asymptotic_error,
                                                  abs=1e-9)


@pytest.mark.parametrize("narrow_band", ["auto", "on", "off"])
@pytest.mark.parametrize("init_mode", ["distance", "reference"])
def test_banded_table(narrow_band, init_mode):
    """float32 follows the JAX package's ``_banded`` (``run.py:42-57``);
    float64 is always dense (H14)."""
    for initial in (True, False):
        j = JaxConfig(narrow_band=narrow_band, init_mode=init_mode)
        ours = LevelSetConfig(narrow_band=narrow_band, init_mode=init_mode)
        assert port_run._banded(ours, initial=initial) == \
            jax_run._banded(j, initial=initial)
        assert not port_run._banded(ours.replace(dtype=torch.float64),
                                    initial=initial)
    assert port_run._banded(LevelSetConfig(init_mode="reference"),
                            initial=True) is False


def test_reference_init_routes_the_initial_reinit_dense(monkeypatch):
    """float32, default narrow band: the initial reinit is dense, the
    min/max flow and the final reinit banded (JAX ``run.py:229-330``)."""
    calls = []
    for name in ("reinit", "reinit_narrowband", "minmax_flow",
                 "minmax_flow_narrowband"):
        real = getattr(port_run, name)

        def spy(*a, _real=real, _name=name, **k):
            calls.append(_name)
            return _real(*a, **k)
        monkeypatch.setattr(port_run, name, spy)
    cfg = LevelSetConfig(device="cpu", dx=0.1, pad_cells=6, reinit_iters=20,
                         minmax_iters=16, advect_iters=2,
                         final_reinit_iters=9, init_mode="reference")
    port_run.run_mesh(icosphere_mesh(subdivisions=1), cfg)
    assert calls == ["reinit", "minmax_flow_narrowband", "reinit_narrowband"]


def test_run_batch_reference_init_matches_jax():
    """Two icospheres on a common grid, float64, the reference init: each
    geometry's fields and counts as the JAX package's batch (within 1e-9,
    measured 2.2e-15)."""
    jcfg, cfg = _cfg_pair(reinit_iters=30, minmax_iters=8)
    meshes = [icosphere_mesh(radius=0.5, subdivisions=1),
              icosphere_mesh(radius=0.7, subdivisions=2)]
    jmeshes = [jax_icosphere(radius=0.5, subdiv=1),
               jax_icosphere(radius=0.7, subdiv=2)]
    ours = run_batch(meshes, cfg)
    ref = jax_run_batch(jmeshes, jcfg)
    for a, b in zip(ours, ref):
        assert (a.reinit_iters, a.minmax_iters) == (b.reinit_iters,
                                                    b.minmax_iters)
        for f in ("phi_init", "phi_smoothed", "advected"):
            np.testing.assert_allclose(getattr(a, f), getattr(b, f),
                                       rtol=0, atol=1e-9, err_msg=f)
    # the batch's init is the solo reference init on each geometry's grid
    g = ours[0].grid
    solo = init_sign.initialize_sign_field(g, meshes[0].vertices,
                                           meshes[0].elements,
                                           dtype=torch.float64)
    assert np.all(np.sign(ours[0].phi_init) == np.sign(solo.numpy()))


def test_cli_init_mode(tmp_path):
    stl = str(tmp_path / "ball.stl")
    write_stl(stl, icosphere_mesh(subdivisions=1))
    parse = cli.build_parser().parse_args
    assert cli.config_from_args(parse([stl])).init_mode == "distance"
    args = [stl, "--init-mode", "reference", "--device", "cpu", "--dx",
            "0.1", "--pad-cells", "6", "--reinit-iters", "20",
            "--minmax-iters", "4", "--advect-iters", "2",
            "--final-reinit-iters", "2", "--out-dir", str(tmp_path / "o")]
    assert cli.config_from_args(parse(args)).init_mode == "reference"
    with pytest.raises(SystemExit):
        parse([stl, "--init-mode", "nearest"])
    assert cli.main(args) == 0
    assert (tmp_path / "o" / "signedDistanceFunction.vti").exists()
