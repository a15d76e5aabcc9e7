"""The domain-decomposed pipeline of the port (``run_mesh`` with
``mesh_shape``): sharded init -> ``ShardedLevelSet`` reinit and min/max ->
sharded advection -> final reinit -> streamed ``.vti`` and ``.s3d``.

Held against the port's own unsharded dense run on the same init (every
field bitwise: the block steps are the solo steps cell for cell) and
against the JAX package's ``run_mesh`` with the same mesh shape on virtual
CPU devices, float64, the same init handed to both (ROADMAP H8): 1e-9
(measured 2.8e-16).  The sharded init against the whole-grid init:
measured 1.2e-7 on an icosphere (a tie between two triangles falls the
other way when the candidates arrive in another order), 0 on the cubes.
"""

import dataclasses
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import levelsetfortran_tpu.ops.init_sign as jax_init
import levelsetfortran_tpu.pipeline.run  # noqa: F401
from levelsetfortran_tpu.config import LevelSetConfig as JaxConfig
from levelsetfortran_tpu.io.vti import read_vti as jax_read_vti
from levelsetfortran_tpu.models.analytic import \
    icosphere_mesh as jax_icosphere
from levelsetfortran_tpu_torch.config import LevelSetConfig
from levelsetfortran_tpu_torch.grid import grid as gridmod
from levelsetfortran_tpu_torch.io.stl import write_stl
from levelsetfortran_tpu_torch.io.vti import (read_vti, write_vti,
                                              write_vti_streaming)
from levelsetfortran_tpu_torch.models.analytic import (icosphere_mesh,
                                                       two_cubes_mesh)
from levelsetfortran_tpu_torch.ops.init_sign import (
    signed_distance_init, signed_distance_init_sharded)
from levelsetfortran_tpu_torch.parallel.mesh import (gather_blocks,
                                                     make_mesh, split_blocks)
from levelsetfortran_tpu_torch.pipeline import cli
from levelsetfortran_tpu_torch.pipeline import run as port_run

torch.set_num_threads(1)
jax_run = sys.modules["levelsetfortran_tpu.pipeline.run"]

BASE = dict(dx=0.1, pad_cells=6, reinit_iters=12, reinit_tol=0.0,
            minmax_iters=8, minmax_tol=0.0, advect_iters=10,
            final_reinit_iters=4, narrow_band="off")
FIELDS = ("phi_init", "phi_smoothed", "phi_final", "advected")


def _keep_sharded_init(monkeypatch):
    """Record the blocks the sharded init returns."""
    inits = []
    real = port_run.signed_distance_init_sharded

    def keep(*a, **k):
        inits.append(real(*a, **k))
        return inits[-1]

    monkeypatch.setattr(port_run, "signed_distance_init_sharded", keep)
    return inits


@pytest.mark.parametrize("mesh_shape,extra", [
    ((2, 2, 1), {}), ((2, 2, 2), {}),
    ((2, 2, 1), {"steps_per_exchange": 2}),
    ((2, 2, 1), {"overlap": True, "pad_cells": 8})])
def test_sharded_run_bitwise_equals_unsharded_dense_run(monkeypatch,
                                                        mesh_shape, extra):
    """Float32, dense solvers, fixed counts, the sharded run's init handed
    to the unsharded run: every output bit for bit.  The overlapped run
    takes blocks of 19 cells, the least with an interior brick box."""
    mesh = icosphere_mesh(subdivisions=1)
    cfg = LevelSetConfig(device="cpu", mesh_shape=mesh_shape,
                         **{**BASE, **extra})
    inits = _keep_sharded_init(monkeypatch)
    ours = port_run.run_mesh(mesh, cfg)
    whole = gather_blocks(make_mesh(mesh_shape, ["cpu"]), inits[0])
    monkeypatch.setattr(port_run, "signed_distance_init",
                        lambda *a, **k: whole)
    ref = port_run.run_mesh(mesh, cfg.replace(
        mesh_shape=None, steps_per_exchange=1, overlap=False))
    n = 22 + 2 * cfg.pad_cells
    assert ours.grid == ref.grid and ours.grid.shape == (n, n, n)
    assert (ours.reinit_iters, ours.minmax_iters) == (12, 8)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(ours, f), getattr(ref, f), f)
    # float32 sums of squares, per block here and over the grid there
    assert ours.asymptotic_error == pytest.approx(ref.asymptotic_error,
                                                  rel=1e-6)


def test_sharded_run_default_routing_close_to_unsharded(monkeypatch):
    """Default config (narrow band, stop tests on): the sharded band is
    refreshed every exchange and the RMS read every step, the solo band
    every chunk of 9, so counts and far cells differ; in the band the
    fields agree within one pseudo-time step h per step of difference
    (measured at equal counts: 0 on phi_init and phi_smoothed, 4.2e-5 on
    phi_final)."""
    mesh = icosphere_mesh(subdivisions=2)
    kw = dict(BASE, narrow_band="auto", reinit_iters=18, reinit_tol=1e-5)
    cfg = LevelSetConfig(device="cpu", mesh_shape=(2, 2, 1), **kw)
    inits = _keep_sharded_init(monkeypatch)
    ours = port_run.run_mesh(mesh, cfg)
    whole = gather_blocks(make_mesh((2, 2, 1), ["cpu"]), inits[0])
    monkeypatch.setattr(port_run, "signed_distance_init",
                        lambda *a, **k: whole)
    ref = port_run.run_mesh(mesh, cfg.replace(mesh_shape=None))
    h = 0.1 * 0.1 / gridmod.surface_diag(mesh.vertices)
    steps = max(1, abs(ours.reinit_iters - ref.reinit_iters))
    band = np.abs(ref.phi_init) < 8.1 * 0.1
    for f in FIELDS[:3]:
        d = np.abs(getattr(ours, f) - getattr(ref, f))[band].max()
        assert d <= 1.05 * h * steps, (f, d)
    np.testing.assert_allclose(ours.advected, ref.advected, rtol=0,
                               atol=1.05 * h * steps)


def test_sharded_run_matches_jax_sharded_run(monkeypatch, eight_devices):
    """Both packages' ``run_mesh`` with mesh_shape (2,2,2), float64, dense
    (the JAX package takes every visible device, so eight shards)."""
    jcfg = JaxConfig(dx=0.1, pad_cells=4, reinit_iters=12, reinit_tol=0.0,
                     minmax_iters=6, minmax_tol=0.0, advect_iters=20,
                     final_reinit_iters=4, narrow_band="off",
                     dtype=jnp.float64, mesh_shape=(2, 2, 2))
    cfg = LevelSetConfig.from_reference_fields(dataclasses.asdict(jcfg),
                                               device="cpu")
    assert cfg.mesh_shape == (2, 2, 2)
    inits = _keep_sharded_init(monkeypatch)
    ours = port_run.run_mesh(icosphere_mesh(radius=0.5, subdivisions=1),
                             cfg)
    whole = gather_blocks(make_mesh((2, 2, 2), ["cpu"]), inits[0])
    monkeypatch.setattr(jax_init, "signed_distance_init_sharded",
                        lambda *a, **k: jnp.asarray(whole.numpy()))
    ref = jax_run.run_mesh(jax_icosphere(radius=0.5, subdiv=1), jcfg)
    assert ours.grid.shape == tuple(ref.grid.shape) == (20, 20, 20)
    assert (ours.reinit_iters, ours.minmax_iters) == \
        (ref.reinit_iters, ref.minmax_iters) == (12, 6)
    for f in FIELDS:
        np.testing.assert_allclose(getattr(ours, f), getattr(ref, f),
                                   rtol=0, atol=1e-9, err_msg=f)
    assert ours.asymptotic_error == pytest.approx(ref.asymptotic_error,
                                                  abs=1e-9)


@pytest.mark.parametrize("name,culling,tol", [
    ("icosphere", "auto", 2e-7), ("cubes", None, 0.0),
    ("cubes", "auto", 0.0)])
def test_sharded_init_against_whole_grid_init(name, culling, tol):
    mesh = (icosphere_mesh(subdivisions=2) if name == "icosphere"
            else two_cubes_mesh())
    dx = 0.1 if name == "icosphere" else 0.25
    m = make_mesh((2, 2, 1), ["cpu"])
    grid = gridmod.from_surface(mesh.vertices, dx, 6, m.shape)
    whole = signed_distance_init(grid, mesh.vertices, mesh.elements,
                                 culling=culling)
    blocks = signed_distance_init_sharded(grid, mesh.vertices,
                                          mesh.elements, m, culling=culling)
    assert all(tuple(b.shape) == m.block_shape(grid.shape) for b in blocks)
    got = gather_blocks(m, blocks)
    assert float((got - whole).abs().max()) <= tol
    assert torch.equal(torch.sign(got), torch.sign(whole))


def test_write_vti_streaming_bytes_equal_write_vti(tmp_path):
    shape = (12, 10, 38)
    phi = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    grid = gridmod.Grid3D(shape=shape, origin=(-0.3, 0.1, 2.0), dx=0.05)
    write_vti(str(tmp_path / "a.vti"), phi, grid)
    for i, mesh_shape in enumerate([(2, 2, 1), (2, 1, 2), (1, 1, 1)]):
        m = make_mesh(mesh_shape, ["cpu"])
        path = str(tmp_path / f"b{i}.vti")
        write_vti_streaming(path, split_blocks(m, torch.tensor(phi)), grid,
                            m, chunk_z=16)
        assert open(path, "rb").read() == open(tmp_path / "a.vti",
                                               "rb").read()
    back, g = jax_read_vti(path)
    np.testing.assert_array_equal(back, phi.astype(np.float64))
    with pytest.raises(ValueError):
        write_vti_streaming(path, [torch.zeros(3, 3, 3)], grid, m)


def test_cli_mesh_flags_outputs_and_no_gather(tmp_path):
    """--mesh-shape / --steps-per-exchange / --overlap /
    --no-gather-results with the JAX CLI's spellings; the streamed .vti
    holds the gathered field; without gathering the fields stay blocks."""
    stl = str(tmp_path / "ball.stl")
    write_stl(stl, icosphere_mesh(subdivisions=1))
    args = [stl, "--out-dir", str(tmp_path / "out"), "--device", "cpu",
            "--mesh-shape", "2,2,1", "--steps-per-exchange", "2"]
    for k, v in BASE.items():
        args += ["--" + k.replace("_", "-"), str(v)]
    parse = cli.build_parser().parse_args
    cfg = cli.config_from_args(parse(args))
    assert cfg.mesh_shape == (2, 2, 1) and cfg.steps_per_exchange == 2
    assert not cfg.overlap and cfg.gather_results
    flags = cli.config_from_args(parse([stl, "--mesh-shape", "auto",
                                        "--overlap", "--no-gather-results"]))
    assert (flags.mesh_shape, flags.overlap, flags.gather_results) == \
        ("auto", True, False)
    assert cli.config_from_args(parse([stl])).mesh_shape is None
    assert cli.main(args) == 0
    res = port_run.run(stl, cfg, write_outputs=False)
    phi, grid = read_vti(str(tmp_path / "out" /
                             "signedDistanceFunction.vti"))
    np.testing.assert_array_equal(phi, res.phi_init)
    assert (tmp_path / "out" / "ball.s3d").exists()
    kept = port_run.run(stl, cfg.replace(gather_results=False),
                        write_outputs=False)
    assert isinstance(kept.phi_final, list) and len(kept.phi_final) == 4
    assert all(isinstance(b, torch.Tensor) for b in kept.phi_init)
    m = make_mesh((2, 2, 1), ["cpu"])
    np.testing.assert_array_equal(
        gather_blocks(m, kept.phi_smoothed).double().numpy(),
        res.phi_smoothed)
    np.testing.assert_array_equal(kept.advected, res.advected)


def test_auto_mesh_on_the_cpu_is_one_shard(monkeypatch):
    mesh = icosphere_mesh(subdivisions=1)
    cfg = LevelSetConfig(device="cpu", mesh_shape="auto", **BASE)
    inits = _keep_sharded_init(monkeypatch)
    ours = port_run.run_mesh(mesh, cfg)
    assert len(inits[0]) == 1
    ref = port_run.run_mesh(mesh, cfg.replace(mesh_shape=None))
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(ours, f), getattr(ref, f), f)


def test_mesh_run_raises_without_a_card_and_with_checkpoints(tmp_path):
    """Without a card the default device raises, with or without a mesh and
    with checkpoints too, before anything is written (checkpointed runs
    themselves: tests/test_torch_pipeline_ops.py)."""
    mesh = icosphere_mesh(subdivisions=1)
    with pytest.raises(ValueError):
        LevelSetConfig(mesh_shape=(2, 2))
    if not torch.cuda.is_available():
        ck = str(tmp_path / "ckpt")
        for extra in (dict(mesh_shape=(2, 2, 1)),
                      dict(mesh_shape=(2, 2, 1), checkpoint_dir=ck),
                      dict(checkpoint_dir=ck)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                port_run.run_mesh(mesh, LevelSetConfig(**extra))
        assert not os.path.exists(ck)


@pytest.mark.parametrize("extra,exc,match", [
    (dict(overlap=True), ValueError, "narrow_band='off'"),
    (dict(overlap=True, narrow_band="off", steps_per_exchange=2),
     ValueError, "steps_per_exchange=1"),
    (dict(minmax_avg_halfwidth=2), NotImplementedError, "3x3x3")])
def test_mesh_run_raises_on_options_it_would_drop(extra, exc, match):
    """``overlap`` with the narrow band or k > 1, and a wider min/max
    average, have no sharded form: the run says so instead of dropping
    them."""
    cfg = LevelSetConfig(device="cpu", mesh_shape=(2, 2, 1),
                         **{**BASE, "narrow_band": "auto", **extra})
    with pytest.raises(exc, match=match):
        port_run.run_mesh(icosphere_mesh(subdivisions=1), cfg)


@pytest.mark.parametrize("extra,overlap", [
    ({}, False), ({"overlap": True, "pad_cells": 8}, True),
    ({"overlap": True}, False)])
def test_mesh_run_logs_where_and_how_it_runs(caplog, extra, overlap):
    """The "grid" event names the shards' devices and whether the overlap
    is in effect: it is not in blocks of 17 cells, which have no interior
    brick box."""
    import json
    import logging
    cfg = LevelSetConfig(device="cpu", mesh_shape=(2, 2, 1),
                         **{**BASE, **extra})
    with caplog.at_level(logging.INFO, logger="levelsetfortran_tpu_torch"):
        port_run.run_mesh(icosphere_mesh(subdivisions=1), cfg)
    grid = [e for e in map(json.loads, caplog.messages)
            if e["stage"] == "grid"]
    assert len(grid) == 1
    assert grid[0]["mesh"] == [2, 2, 1] and grid[0]["devices"] == ["cpu"]
    assert grid[0]["overlap"] is overlap and not grid[0]["narrow_band"]
    assert grid[0]["steps_per_exchange"] == 1


def test_unsharded_run_always_returns_host_arrays():
    res = port_run.run_mesh(icosphere_mesh(subdivisions=1), LevelSetConfig(
        device="cpu", gather_results=False, **BASE))
    for f in FIELDS:
        assert isinstance(getattr(res, f), np.ndarray)
        assert getattr(res, f).dtype == np.float64
