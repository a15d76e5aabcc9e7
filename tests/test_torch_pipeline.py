"""The ported slice as a whole: ``run_mesh`` on the twoCube10 twin in both
packages, (134, 24, 24) grid.

Both pipelines start from the SAME init field (the port's, handed to the
JAX pipeline): the twin's cube faces lie exactly on grid points, where the
init's sign is the sign of a rounding-noise pseudonormal sum (measured: 121
points at |phi| = 1e-15 flip between the XLA and PyTorch summation orders,
float64), and a cube-corner cell whose sign flips relaxes at +-h per step.
The init itself is held against the JAX package in test_torch_init.py.
"""

import dataclasses
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import levelsetfortran_tpu.pipeline.run  # noqa: F401
from levelsetfortran_tpu.config import LevelSetConfig as JaxConfig
from levelsetfortran_tpu.io.s3d import read_s3d as jax_read_s3d
from levelsetfortran_tpu.io.vti import read_vti as jax_read_vti
from levelsetfortran_tpu.models.analytic import two_cubes_mesh as jax_mesh
from levelsetfortran_tpu_torch.config import LevelSetConfig
from levelsetfortran_tpu_torch.models.analytic import two_cubes_mesh
from levelsetfortran_tpu_torch.pipeline import cli
from levelsetfortran_tpu_torch.pipeline import run as port_run

torch.set_num_threads(1)
jax_run = sys.modules["levelsetfortran_tpu.pipeline.run"]

BASE = dict(dx=0.1, pad_cells=6, reinit_iters=45, reinit_tol=0.0,
            minmax_iters=25, minmax_tol=0.0, advect_iters=10,
            final_reinit_iters=9)
FIELDS = ("phi_init", "phi_smoothed", "phi_final", "advected")


def _both(monkeypatch, **kw):
    jcfg = JaxConfig(**BASE, **kw)
    cfg = LevelSetConfig.from_reference_fields(dataclasses.asdict(jcfg),
                                               device="cpu")
    inits = []
    real_init = port_run.signed_distance_init

    def keep(*a, **k):
        inits.append(real_init(*a, **k))
        return inits[-1]

    monkeypatch.setattr(port_run, "signed_distance_init", keep)
    ours = port_run.run_mesh(two_cubes_mesh(), cfg)
    monkeypatch.setattr(jax_run, "signed_distance_init",
                        lambda *a, **k: jnp.asarray(inits[0].numpy()))
    ref = jax_run.run_mesh(jax_mesh(), jcfg)
    return ours, ref


def test_float64_dense_slice_matches(monkeypatch):
    """(a) float64, narrow_band off: every output within 1e-9 (measured
    3.3e-13)."""
    ours, ref = _both(monkeypatch, dtype=jnp.float64, narrow_band="off")
    assert ours.grid.shape == ref.grid.shape == (134, 24, 24)
    assert (ours.reinit_iters, ours.minmax_iters) == (45, 25)
    assert (ref.reinit_iters, ref.minmax_iters) == (45, 25)
    for f in FIELDS:
        np.testing.assert_allclose(getattr(ours, f), getattr(ref, f),
                                   rtol=0, atol=1e-9, err_msg=f)
    assert ours.asymptotic_error == pytest.approx(ref.asymptotic_error,
                                                  abs=1e-9)


def test_float32_default_routing_slice_matches(monkeypatch):
    """(b) float32, default routing: banded in the port (five 9-step
    reinit chunks; one 20-step fused min/max chunk plus a 5-step tail),
    dense in JAX on the CPU.

    Measured maxima: everywhere 1.12e-3 (frozen far-field bricks keep
    their init values where the dense solve relaxes them), in band 8.28e-4
    on phi_init and 4.03e-4 on phi_smoothed.  The in-band maximum is one
    pseudo-time step h = 8.28e-4 at a handful of cube-corner cells, where
    the Godunov upwind choice is degenerate and 1-ulp differences pick
    the other branch: the JAX package's own jnp and Pallas-interpret
    solvers differ by the same 8.28e-4 there after 45 steps, so in-band
    agreement below h is out of reach in float32.  Gates: 1.5e-3
    everywhere (the h-scale gate of test_pipeline_strategies.py), h + 5%
    in band."""
    ours, ref = _both(monkeypatch, dtype=jnp.float32)
    assert (ours.reinit_iters, ours.minmax_iters) == (45, 25)
    h = 0.1 * 0.1 / float(np.sqrt(12.0 ** 2 + 2.0))
    band = np.abs(ref.phi_init) < 8.1 * 0.1
    for f in FIELDS[:3]:
        d = np.abs(getattr(ours, f) - getattr(ref, f))
        assert d.max() <= 1.5e-3, (f, d.max())
        assert d[band].max() <= 1.05 * h, (f, d[band].max())
    np.testing.assert_allclose(ours.advected, ref.advected, rtol=0,
                               atol=1.5e-3)
    assert ours.asymptotic_error == pytest.approx(ref.asymptotic_error,
                                                  rel=1e-2)


def test_outputs_written_and_read_by_jax(tmp_path):
    """(c) the CLI writes the three artifacts; the JAX readers read them."""
    args = [str(tmp_path / "cubes.stl"), "--out-dir", str(tmp_path / "out"),
            "--device", "cpu"]
    for k, v in BASE.items():
        args += ["--" + k.replace("_", "-"), str(v)]
    from levelsetfortran_tpu_torch.io.stl import write_stl
    write_stl(args[0], two_cubes_mesh())
    assert cli.main(args) == 0
    cfg = cli.config_from_args(cli.build_parser().parse_args(args))
    res = port_run.run(args[0], cfg, write_outputs=False)
    out = tmp_path / "out"
    phi, grid = jax_read_vti(str(out / "signedDistanceFunction.vti"))
    np.testing.assert_array_equal(phi, res.phi_init)
    assert tuple(grid.shape) == res.grid.shape
    smooth, _ = jax_read_vti(str(out / "smoothedDistanceFunction.vti"))
    np.testing.assert_array_equal(smooth, res.phi_smoothed)
    mesh = jax_read_s3d(str(out / "cubes.s3d"))
    np.testing.assert_allclose(mesh.vertices, res.advected, rtol=1e-15)
    np.testing.assert_array_equal(mesh.elements, res.mesh.elements)
