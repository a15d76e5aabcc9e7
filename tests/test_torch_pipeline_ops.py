"""The operations path of the port's pipeline: ``run_mesh`` with
``checkpoint_dir`` (with and without a mesh), preempted and resumed runs,
the metrics stream and checkpoint flags of the CLI, and the profiling
helpers.

On ``two_cubes_mesh()`` at the size of ``tests/test_pipeline_strategies.py``
(dx 0.1, pad 6: 134 x 24 x 24), stop tests off so counts are fixed.  The
checkpointed stages are the dense solvers in chunks, so a checkpointed run
is held bitwise to the port's plain dense run (float32), and within 1e-9 of
the JAX package's checkpointed run in float64 on the same init (ROADMAP
H8; measured 3.3e-13, with and without a mesh).
"""

import dataclasses
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import levelsetfortran_tpu.pipeline.run  # noqa: F401
from levelsetfortran_tpu.config import LevelSetConfig as JaxConfig
from levelsetfortran_tpu.models.analytic import two_cubes_mesh as jax_cubes
from levelsetfortran_tpu_torch.config import LevelSetConfig
from levelsetfortran_tpu_torch.io.stl import write_stl
from levelsetfortran_tpu_torch.models.analytic import two_cubes_mesh
from levelsetfortran_tpu_torch.parallel.mesh import gather_blocks, make_mesh
from levelsetfortran_tpu_torch.pipeline import cli
from levelsetfortran_tpu_torch.pipeline import run as port_run
from levelsetfortran_tpu_torch.solvers.reinit import reinit
from levelsetfortran_tpu_torch.utils import metrics, profiling

torch.set_num_threads(1)
jax_run = sys.modules["levelsetfortran_tpu.pipeline.run"]

BASE = dict(dx=0.1, pad_cells=6, reinit_iters=40, reinit_tol=0.0,
            minmax_iters=10, minmax_tol=0.0, advect_iters=10,
            final_reinit_iters=3)
FIELDS = ("phi_init", "phi_smoothed", "phi_final", "advected")


def _steps(ck):
    return {stage: sorted(int(n) for n in os.listdir(os.path.join(ck, stage))
                          if n.isdigit()) for stage in ("reinit", "minmax")}


def _same(a, b, fields=("phi_init", "phi_smoothed")):
    for f in fields:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
    assert (a.reinit_iters, a.minmax_iters) == (b.reinit_iters,
                                                b.minmax_iters)


@pytest.fixture
def stream():
    old = metrics.get_stream()
    yield metrics.set_stream(metrics.MetricsStream(log=False))
    metrics.set_stream(old)


def test_checkpointed_run_is_bitwise_the_plain_dense_run(tmp_path, stream):
    """``tests/test_pipeline_strategies.py:47-53``, float32: chunks of 15
    (40 = 15 + 15 + 10), three steps kept per stage; the chunked stages
    emit no metrics, the final reinit (banded, the default) does."""
    ck = str(tmp_path / "ck")
    cfg = LevelSetConfig(device="cpu", checkpoint_dir=ck,
                         checkpoint_chunk=15, metrics_every=1, **BASE)
    res = port_run.run_mesh(two_cubes_mesh(), cfg)
    plain = port_run.run_mesh(two_cubes_mesh(), cfg.replace(
        checkpoint_dir=None, narrow_band="off", metrics_every=0))
    _same(res, plain)
    assert (res.reinit_iters, res.minmax_iters) == (40, 10)
    assert not (res.reinit_diverged or res.minmax_diverged)
    assert _steps(ck) == {"reinit": [15, 30, 40], "minmax": [10]}
    stages = {e["stage_name"] for e in stream.events}
    assert stages == {"reinit_narrowband"}
    assert [e["iteration"] for e in stream.events] == [9]


def test_checkpointed_run_matches_jax_float64(tmp_path, monkeypatch):
    jcfg = JaxConfig(**BASE, dtype=jnp.float64, checkpoint_chunk=20,
                     checkpoint_dir=str(tmp_path / "jax"))
    cfg = LevelSetConfig.from_reference_fields(
        dataclasses.asdict(jcfg), device="cpu",
        checkpoint_dir=str(tmp_path / "port"))
    assert (cfg.checkpoint_chunk, cfg.dtype) == (20, torch.float64)
    inits = []
    real = port_run.signed_distance_init
    monkeypatch.setattr(port_run, "signed_distance_init",
                        lambda *a, **k: inits.append(real(*a, **k))
                        or inits[-1])
    ours = port_run.run_mesh(two_cubes_mesh(), cfg)
    monkeypatch.setattr(jax_run, "signed_distance_init",
                        lambda *a, **k: jnp.asarray(inits[0].numpy()))
    ref = jax_run.run_mesh(jax_cubes(), jcfg)
    assert (ours.reinit_iters, ours.minmax_iters) == (
        ref.reinit_iters, ref.minmax_iters) == (40, 10)
    for f in FIELDS:
        np.testing.assert_allclose(getattr(ours, f), getattr(ref, f),
                                   rtol=0, atol=1e-9, err_msg=f)


def _keep_sharded_init(monkeypatch):
    inits = []
    real = port_run.signed_distance_init_sharded
    monkeypatch.setattr(port_run, "signed_distance_init_sharded",
                        lambda *a, **k: inits.append(real(*a, **k))
                        or inits[-1])
    return inits


def test_sharded_checkpointed_run_is_bitwise_the_solo_run(tmp_path,
                                                          monkeypatch,
                                                          stream):
    """(2,2,1) blocks on the CPU, float32, dense: the checkpointed sharded
    run saves four block files per step and equals the solo dense run on
    the same init in every output, bit for bit; the solver's metrics fire
    per chunk (its count restarts with each chunk, as in the JAX
    package)."""
    ck = str(tmp_path / "ck")
    cfg = LevelSetConfig(device="cpu", mesh_shape=(2, 2, 1),
                         narrow_band="off", checkpoint_dir=ck,
                         checkpoint_chunk=15, metrics_every=10, **BASE)
    inits = _keep_sharded_init(monkeypatch)
    ours = port_run.run_mesh(two_cubes_mesh(), cfg)
    whole = gather_blocks(make_mesh((2, 2, 1), ["cpu"]), inits[0])
    monkeypatch.setattr(port_run, "signed_distance_init",
                        lambda *a, **k: whole)
    solo = port_run.run_mesh(two_cubes_mesh(), cfg.replace(
        mesh_shape=None, checkpoint_dir=None, metrics_every=0))
    _same(ours, solo, FIELDS)
    assert _steps(ck) == {"reinit": [15, 30, 40], "minmax": [10]}
    assert sorted(os.listdir(os.path.join(ck, "reinit", "40"))) == [
        "meta.json", "phi.0.pt", "phi.1.pt", "phi.2.pt", "phi.3.pt"]
    it = [(e["stage_name"], e["iteration"]) for e in stream.events]
    assert it == [("reinit", 10), ("reinit", 10), ("reinit", 10),
                  ("minmax", 10)]


def test_sharded_checkpointed_run_matches_jax_float64(tmp_path, monkeypatch,
                                                      eight_devices):
    """The JAX package's run takes every visible device: both on
    (2,2,2)."""
    jcfg = JaxConfig(**BASE, dtype=jnp.float64, mesh_shape=(2, 2, 2),
                     checkpoint_chunk=20,
                     checkpoint_dir=str(tmp_path / "jax"))
    cfg = LevelSetConfig.from_reference_fields(
        dataclasses.asdict(jcfg), device="cpu",
        checkpoint_dir=str(tmp_path / "port"))
    inits = _keep_sharded_init(monkeypatch)
    ours = port_run.run_mesh(two_cubes_mesh(), cfg)
    whole = gather_blocks(make_mesh((2, 2, 2), ["cpu"]), inits[0])
    import levelsetfortran_tpu.ops.init_sign as jax_init
    monkeypatch.setattr(jax_init, "signed_distance_init_sharded",
                        lambda *a, **k: jnp.asarray(whole.numpy()))
    ref = jax_run.run_mesh(jax_cubes(), jcfg)
    assert (ours.reinit_iters, ours.minmax_iters) == (
        ref.reinit_iters, ref.minmax_iters)
    for f in FIELDS:
        np.testing.assert_allclose(getattr(ours, f), getattr(ref, f),
                                   rtol=0, atol=1e-9, err_msg=f)


@pytest.mark.parametrize("mesh_shape", [None, (2, 2, 1)])
def test_preempted_then_resumed_run_is_the_uninterrupted_one(tmp_path,
                                                             mesh_shape):
    """A first call stopped after 4 min/max steps, then the full call on
    the same directory: the reinit stage is restored whole (40 of 40) and
    the min/max stage resumes from 4; every field bit for bit the
    uninterrupted run's."""
    ck = str(tmp_path / "ck")
    cfg = LevelSetConfig(device="cpu", mesh_shape=mesh_shape,
                         narrow_band="off", checkpoint_dir=ck,
                         checkpoint_chunk=3, **BASE)
    cut = port_run.run_mesh(two_cubes_mesh(), cfg.replace(minmax_iters=4))
    assert cut.minmax_iters == 4
    assert _steps(ck)["minmax"] == [3, 4]
    resumed = port_run.run_mesh(two_cubes_mesh(), cfg)
    assert _steps(ck) == {"reinit": [36, 39, 40], "minmax": [4, 7, 10]}
    whole = port_run.run_mesh(two_cubes_mesh(), cfg.replace(
        checkpoint_dir=str(tmp_path / "fresh")))
    _same(resumed, whole, FIELDS)
    np.testing.assert_array_equal(cut.phi_init, whole.phi_init)


def test_cli_operations_flags(tmp_path, stream):
    stl = str(tmp_path / "cubes.stl")
    write_stl(stl, two_cubes_mesh())
    parse = cli.build_parser().parse_args
    d = cli.config_from_args(parse([stl]))
    assert (d.checkpoint_dir, d.checkpoint_chunk, d.metrics_every) == (
        None, 500, 0)
    ck = str(tmp_path / "ck")
    args = [stl, "--device", "cpu", "--out-dir", str(tmp_path / "o"),
            "--checkpoint-dir", ck, "--checkpoint-chunk", "7",
            "--metrics-every", "3", "--narrow-band", "off"]
    for k, v in BASE.items():
        args += ["--" + k.replace("_", "-"), str(v)]
    cfg = cli.config_from_args(parse(args))
    assert (cfg.checkpoint_dir, cfg.checkpoint_chunk, cfg.metrics_every) == (
        ck, 7, 3)
    assert cli.main(args) == 0
    assert _steps(ck) == {"reinit": [28, 35, 40], "minmax": [7, 10]}
    assert [(e["stage_name"], e["iteration"]) for e in stream.events] == [
        ("reinit", 3)]
    assert (tmp_path / "o" / "smoothedDistanceFunction.vti").exists()


def test_profiling_trace_and_throughput(tmp_path):
    phi0 = torch.tensor(np.random.default_rng(0).standard_normal(
        (12, 12, 12)).astype(np.float32))

    def scan(n):
        return lambda p: reinit(p, 0.1, 0.005, n, 0.0).phi

    with profiling.trace(str(tmp_path / "tr")) as prof:
        profiling.fetch_scalar(scan(2)(phi0))
    files = os.listdir(tmp_path / "tr")
    assert len(files) == 1 and files[0].endswith(".json")
    assert os.path.getsize(tmp_path / "tr" / files[0]) > 0
    assert prof.key_averages()
    out = profiling.measure_cell_updates_per_sec(scan, phi0,
                                                 warmup_steps=1,
                                                 bench_steps=4)
    assert out["cells"] == 12 ** 3
    assert out["cell_updates_per_sec"] > 0 and out["seconds_per_step"] > 0
    secs, s = profiling.time_to_completion(scan(1), phi0)
    assert secs > 0 and s == float(scan(1)(phi0).sum())
