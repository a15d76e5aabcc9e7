"""Batched serving (``run_batch``) in the port against the JAX package's, its
strategies against each other, its command line, and the device rule:
the port runs where it is told, and a CUDA request on a host without a card
raises instead of falling back to the CPU.

Both packages start from the SAME init (the port's, handed to the JAX
pipeline), as in test_torch_pipeline.py: at dx 0.12 the box's faces lie on
grid points, whose init signs are rounding noise that differs between the
frameworks (H8).  Each geometry's h is formed as the JAX package forms it,
``cfl * dxx`` in float32 with ``dxx`` a float32 array.

Tolerances (float32, measured on a CPU): the port's packed strategy against
the JAX package's, equal counts, phi_init and phi_smoothed within 1e-6
(measured 2.4e-7: the plain steps against the Pallas pack mode in interpret
mode), advected nodes within 2e-6 (measured 3.0e-7), the asymptotic error
rel 1e-5 (measured 2.1e-7); packed (and auto, which means it) against
sequential bitwise.  Data parallel (the batch cut into shares, each its own
pack launch) against the undivided packed batch bitwise, and against the
JAX package's data-parallel run_batch (its vmap strategy, sharded over 2
virtual devices) at the same tolerances as the packed comparison.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from levelsetfortran_tpu.config import LevelSetConfig as JaxConfig
from levelsetfortran_tpu.io.s3d import read_s3d as jax_read_s3d
from levelsetfortran_tpu.io.vti import read_vti as jax_read_vti
from levelsetfortran_tpu.models import analytic as jax_analytic
from levelsetfortran_tpu.pipeline import batch as jax_batch
from levelsetfortran_tpu_torch import BatchItem, run_batch
from levelsetfortran_tpu_torch.config import LevelSetConfig
from levelsetfortran_tpu_torch.io.stl import write_stl
from levelsetfortran_tpu_torch.models import analytic
from levelsetfortran_tpu_torch.ops import minmax_cuda, weno_cuda
from levelsetfortran_tpu_torch.pipeline import batch, cli
from levelsetfortran_tpu_torch.pipeline.run import run_mesh

torch.set_num_threads(1)
BASE = dict(dx=0.12, pad_cells=10, reinit_iters=15, minmax_iters=5,
            advect_iters=3)
FIELDS = ("phi_init", "phi_smoothed", "advected")


def _meshes(pkg):
    return [pkg.box_mesh(half_extent=(0.5, 0.5, 0.5)),
            pkg.icosphere_mesh(radius=0.5, subdivisions=1)]


def _config(**kw):
    return LevelSetConfig(**BASE, device="cpu", **kw)


@pytest.fixture(scope="module")
def packed():
    """The port's packed strategy on the CPU, with the inits it made."""
    inits = []
    real = batch.signed_distance_init

    def keep(*a, **k):
        inits.append(real(*a, **k))
        return inits[-1]

    batch.signed_distance_init = keep
    try:
        items = run_batch(_meshes(analytic), _config(), strategy="packed")
    finally:
        batch.signed_distance_init = real
    return items, inits


def test_packed_matches_jax_run_batch(packed, monkeypatch):
    ours, inits = packed
    jcfg = JaxConfig(**BASE, dtype=jnp.float32)
    cfg = LevelSetConfig.from_reference_fields(dataclasses.asdict(jcfg),
                                               device="cpu")
    assert cfg == _config()
    given = iter(inits)
    monkeypatch.setattr(jax_batch, "signed_distance_init",
                        lambda *a, **k: jnp.asarray(next(given).numpy()))
    ref = jax_batch.run_batch(_meshes(jax_analytic), jcfg, strategy="packed")
    assert len(ours) == len(ref) == 2
    for a, b in zip(ours, ref):
        assert a.grid.shape == tuple(b.grid.shape) == (31, 31, 31)
        assert (a.reinit_iters, a.minmax_iters) == (b.reinit_iters,
                                                    b.minmax_iters)
        np.testing.assert_allclose(a.phi_init, b.phi_init, rtol=0, atol=1e-6)
        np.testing.assert_allclose(a.phi_smoothed, b.phi_smoothed, rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(a.advected, b.advected, rtol=0, atol=2e-6)
        assert a.asymptotic_error == pytest.approx(b.asymptotic_error,
                                                   rel=1e-5)
        assert a.name == b.name


@pytest.mark.parametrize("strategy", ["sequential", "auto"])
def test_strategies_agree_with_packed(packed, strategy):
    """Sequential (the solo dense solvers) and auto (packed) equal packed
    bitwise, counts included."""
    items = run_batch(_meshes(analytic), _config(), strategy=strategy)
    for a, b in zip(packed[0], items):
        assert (a.reinit_iters, a.minmax_iters) == (b.reinit_iters,
                                                    b.minmax_iters)
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_packed_wider_average_runs_solo_min_max(dtype):
    """A min/max average half-width of 2, which no kernel takes, runs the
    solo min/max flow per geometry after the packed reinit: the batch
    equals the sequential strategy bitwise, in either dtype (the CPU runs
    the pack modes' plain versions in any dtype)."""
    cfg = _config(minmax_avg_halfwidth=2, dtype=dtype)
    items = run_batch(_meshes(analytic), cfg, strategy="packed")
    seq = run_batch(_meshes(analytic), cfg, strategy="sequential")
    for a, b in zip(items, seq):
        assert (a.reinit_iters, a.minmax_iters) == (b.reinit_iters,
                                                    b.minmax_iters)
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_each_geometry_keeps_its_own_h_and_stop():
    """A geometry that converges early freezes: its count stops below the
    others' and its field equals a solo run's."""
    cfg = _config().replace(reinit_iters=60, reinit_tol=1.5e-4)
    items = run_batch(_meshes(analytic), cfg, strategy="packed")
    seq = run_batch(_meshes(analytic), cfg, strategy="sequential")
    assert items[1].reinit_iters < items[0].reinit_iters < 60
    for a, b in zip(items, seq):
        assert (a.reinit_iters, a.minmax_iters) == (b.reinit_iters,
                                                    b.minmax_iters)
        np.testing.assert_array_equal(a.phi_smoothed, b.phi_smoothed)


def test_cli_serves_several_inputs(tmp_path, capsys):
    """Two inputs go through run_batch: one output directory and one
    printed line per geometry; the JAX readers read what it wrote."""
    paths = []
    for name, mesh in zip(("box", "ball"), _meshes(analytic)):
        paths.append(str(tmp_path / f"{name}.stl"))
        write_stl(paths[-1], mesh)
    out = tmp_path / "out"
    args = [*paths, "--out-dir", str(out), "--device", "cpu"]
    for k, v in BASE.items():
        args += ["--" + k.replace("_", "-"), str(v)]
    assert cli.main(args) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split("]")[0] for ln in lines] == ["[box", "[ball"]
    items = run_batch(paths, cli.config_from_args(
        cli.build_parser().parse_args(args)))
    for it, line in zip(items, lines):
        d = out / it.name
        phi, grid = jax_read_vti(str(d / "signedDistanceFunction.vti"))
        np.testing.assert_array_equal(phi, it.phi_init)
        assert tuple(grid.shape) == it.grid.shape
        smooth, _ = jax_read_vti(str(d / "smoothedDistanceFunction.vti"))
        np.testing.assert_array_equal(smooth, it.phi_smoothed)
        mesh = jax_read_s3d(str(d / f"{it.name}.s3d"))
        np.testing.assert_allclose(mesh.vertices, it.advected, rtol=1e-15)
        assert f"reinit_iters={it.reinit_iters} " in line
    assert sorted(os.listdir(out)) == ["ball", "box"]


def test_batch_item_fields():
    names = [f.name for f in dataclasses.fields(BatchItem)]
    assert names == [f.name for f in dataclasses.fields(jax_batch.BatchItem)]


@pytest.mark.parametrize("strategy", ["fastest", "vmap"])
def test_unknown_strategy_raises(strategy):
    """The JAX package's "vmap" exists for jax.vmap; the port has none."""
    with pytest.raises(ValueError, match="unknown strategy"):
        run_batch(_meshes(analytic), _config(), strategy=strategy)


def _three_meshes(pkg):
    return _meshes(pkg) + [pkg.icosphere_mesh(radius=0.4, subdivisions=1)]


@pytest.fixture(scope="module")
def packed3():
    return run_batch(_three_meshes(analytic), _config(), strategy="packed")


def _assert_same_items(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a.name, a.reinit_iters, a.minmax_iters) == (
            b.name, b.reinit_iters, b.minmax_iters)
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert a.asymptotic_error == b.asymptotic_error


@pytest.mark.parametrize("dp,n_meshes", [(True, 2), (2, 2), (3, 3), (4, 2)])
def test_data_parallel_equals_packed(packed, packed3, dp, n_meshes):
    """Cut into shares (True: one per visible device, here the CPU; 3
    shares of 3 geometries; 4 shares of 2, two of them empty), each share
    stepped by its own pack launch: fields, advected nodes and counts
    bitwise the undivided packed batch's."""
    meshes = _three_meshes(analytic)[:n_meshes]
    want = packed3 if n_meshes == 3 else packed[0]
    _assert_same_items(run_batch(meshes, _config(), data_parallel=dp), want)


def test_data_parallel_sequential_equals_packed(packed3):
    """The solo solvers on each geometry's share, bitwise."""
    items = run_batch(_three_meshes(analytic), _config(), data_parallel=2,
                      strategy="sequential")
    _assert_same_items(items, packed3)


def test_data_parallel_matches_jax_data_parallel(monkeypatch):
    """Against the JAX package's data-parallel run_batch (its batch axis
    sharded over 2 of the virtual CPU devices, its vmap strategy) from the
    same inits: equal counts, fields within the packed comparison's
    tolerances (test_packed_matches_jax_run_batch)."""
    inits = []
    real = batch.signed_distance_init

    def keep(*a, **k):
        inits.append(real(*a, **k))
        return inits[-1]

    monkeypatch.setattr(batch, "signed_distance_init", keep)
    ours = run_batch(_three_meshes(analytic), _config(), data_parallel=2)
    jcfg = JaxConfig(**BASE, dtype=jnp.float32)
    given = iter(inits)
    monkeypatch.setattr(jax_batch, "signed_distance_init",
                        lambda *a, **k: jnp.asarray(next(given).numpy()))
    ref = jax_batch.run_batch(_three_meshes(jax_analytic), jcfg,
                              data_parallel=2)
    assert len(ours) == len(ref) == 3
    for a, b in zip(ours, ref):
        assert (a.reinit_iters, a.minmax_iters) == (b.reinit_iters,
                                                    b.minmax_iters)
        np.testing.assert_allclose(a.phi_init, b.phi_init, rtol=0, atol=1e-6)
        np.testing.assert_allclose(a.phi_smoothed, b.phi_smoothed, rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(a.advected, b.advected, rtol=0, atol=2e-6)
        assert a.asymptotic_error == pytest.approx(b.asymptotic_error,
                                                   rel=1e-5)


@pytest.mark.parametrize("n", [0, 2])
def test_cli_data_parallel(tmp_path, capsys, packed3, n):
    """``--data-parallel N`` (0: one share per visible device): the files
    it writes hold the packed batch's fields bitwise."""
    paths = []
    for name, mesh in zip(("box", "ball", "small"),
                          _three_meshes(analytic)):
        paths.append(str(tmp_path / f"{name}.stl"))
        write_stl(paths[-1], mesh)
    out = tmp_path / "out"
    args = [*paths, "--out-dir", str(out), "--device", "cpu",
            "--data-parallel", str(n)]
    for k, v in BASE.items():
        args += ["--" + k.replace("_", "-"), str(v)]
    assert cli.build_parser().parse_args(args).data_parallel == n
    assert cli.main(args) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split("]")[0] for ln in lines] == ["[box", "[ball", "[small"]
    for it, name, line in zip(packed3, ("box", "ball", "small"), lines):
        phi, _ = jax_read_vti(str(out / name / "signedDistanceFunction.vti"))
        np.testing.assert_array_equal(phi, it.phi_init)
        smooth, _ = jax_read_vti(str(out / name /
                                     "smoothedDistanceFunction.vti"))
        np.testing.assert_array_equal(smooth, it.phi_smoothed)
        mesh = jax_read_s3d(str(out / name / f"{name}.s3d"))
        np.testing.assert_array_equal(mesh.vertices, it.advected)
        assert f"reinit_iters={it.reinit_iters} " in line


@pytest.mark.parametrize("case", ["shape", "dtype"])
def test_pack_modes_raise_off_the_cpu(case):
    """Off the CPU the pack modes launch their kernels or raise: a grid
    the kernels do not take (an axis of 2 points, or float64) raises before
    any launch and never runs the plain version.  Meta tensors stand in for
    the card's."""
    shape, dtype = (((2, 31, 2, 31), torch.float32) if case == "shape"
                    else ((2, 31, 31, 31), torch.float64))
    phi = torch.empty(shape, dtype=dtype, device="meta")
    live = torch.ones(2, dtype=torch.int32, device="meta")
    err = ValueError if case == "shape" else TypeError
    with pytest.raises(err, match="reinit_step_packed"):
        weno_cuda.reinit_step_packed(phi, torch.empty_like(phi), 0.1,
                                     [0.01, 0.01], live)
    with pytest.raises(err, match="minmax_step_packed"):
        minmax_cuda.minmax_step_packed(phi, 0.1, [1e-3, 1e-3], live, 4.1, 0.0)


def test_default_device_is_cuda_with_no_fallback():
    """The default asks for the card, in every dtype; without one, every
    entry point raises instead of running on the CPU, for float64 and
    bfloat16 as for float32."""
    cfg = LevelSetConfig(**BASE)
    assert cfg.device == "cuda" == cli.build_parser().parse_args(
        ["a.stl"]).device
    assert cfg.replace(device="cpu").torch_device() == torch.device("cpu")
    if torch.cuda.is_available():
        for dtype in (torch.float64, torch.bfloat16):
            assert cfg.replace(dtype=dtype).torch_device().type == "cuda"
        pytest.skip("a CUDA device is present: nothing falls back here")
    for c in (cfg, cfg.replace(dtype=torch.float64),
              cfg.replace(dtype=torch.bfloat16)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            c.torch_device()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_mesh(_meshes(analytic)[0], c)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_batch(_meshes(analytic), c)
