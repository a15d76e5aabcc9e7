"""bfloat16 through the port's entry points, held against the JAX package
on the CPU, and the dtype routing that sends it (and float64) to the
kernels' plain versions.

The JAX package sends bfloat16 and float64 to its jnp path
(``pallas_supported``, ``minmax_pallas_applicable``,
``packed_applicable``); the port sends them to the kernels' plain
versions on the configured device, which on the CPU here is what a card
would run.  Two sources of difference, both measured and capped below:

* rounding: PyTorch rounds every elementwise op to bfloat16, and the
  plain versions evaluate the TPU kernel's algebra (raw differences)
  where the JAX package's jnp path scales by 1/dx first, so single steps
  differ by one bfloat16 ulp in a few percent of the cells;
* the init: the point-triangle quadratic form cancels in bfloat16 (its
  terms are |p|^2 ~ 1 against an ulp of 2^-8), so both packages' inits
  carry errors of O(0.1) and wrong signs (on the twoCube10 twin at dx 0.1
  against the analytic SDF, 1,595 far-field cells in the JAX package),
  and where the two pick different triangles their values differ.  The
  pipeline comparisons therefore hand the port's init to the JAX
  package, as ``tests/test_torch_pipeline.py`` does.

Iteration counts under a tolerance differ: on the 48^3 sphere the JAX
package stops its reinit at 42 steps and its min/max flow at 71, the port
at 39 and 67.  The port's float64 sum of bfloat16 changes is not the
cause (the JAX package's bfloat16 RMS, formed in PyTorch from the port's
steps, stops at the same 39 and 67); the trajectories themselves part by
an ulp here and there, and the stop tests fall where the bfloat16 RMS
floor lies.  The same JAX-form step in PyTorch stops at 49.
"""

import dataclasses
import functools
import importlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import levelsetfortran_tpu.pipeline.run  # noqa: F401
from levelsetfortran_tpu.config import LevelSetConfig as JaxConfig
from levelsetfortran_tpu.grid import grid as jax_grid
from levelsetfortran_tpu.grid.grid import Grid3D as JGrid
from levelsetfortran_tpu.models import analytic as jax_analytic
from levelsetfortran_tpu.pipeline import batch as jax_batch
from levelsetfortran_tpu.pipeline import cli as jax_cli
from levelsetfortran_tpu.pipeline import differentiable as jax_diff
from levelsetfortran_tpu_torch import image_loss_and_vertex_grad, run_batch
from levelsetfortran_tpu_torch.config import LevelSetConfig
from levelsetfortran_tpu_torch.grid import grid as gridmod
from levelsetfortran_tpu_torch.grid.grid import Grid3D
from levelsetfortran_tpu_torch.io.stl import write_stl
from levelsetfortran_tpu_torch.models import analytic
from levelsetfortran_tpu_torch.ops import init_sign
from levelsetfortran_tpu_torch.ops import minmax_cuda as mc
from levelsetfortran_tpu_torch.ops import weno_cuda as wc
from levelsetfortran_tpu_torch.parallel import sharded as sh
from levelsetfortran_tpu_torch.parallel.mesh import (gather_blocks,
                                                     make_mesh, split_blocks)
from levelsetfortran_tpu_torch.pipeline import batch, cli
from levelsetfortran_tpu_torch.pipeline import run as port_run
from levelsetfortran_tpu_torch.solvers import checkpointed as ck
from levelsetfortran_tpu_torch.solvers import minmax_flow as mf
from levelsetfortran_tpu_torch.solvers import reinit as re
from levelsetfortran_tpu_torch.utils.checkpoint import (FieldCheckpointer,
                                                        as_tensor)

torch.set_num_threads(1)
BF = torch.bfloat16
jax_run = sys.modules["levelsetfortran_tpu.pipeline.run"]
jax_reinit = importlib.import_module("levelsetfortran_tpu.solvers.reinit")
jax_minmax = importlib.import_module("levelsetfortran_tpu.solvers.minmax_flow")
jax_advect = importlib.import_module("levelsetfortran_tpu.solvers.advect")
jax_ckpt = importlib.import_module("levelsetfortran_tpu.solvers.checkpointed")
jax_init = importlib.import_module("levelsetfortran_tpu.ops.init_sign")
port_advect = importlib.import_module(
    "levelsetfortran_tpu_torch.solvers.advect")

#: One bfloat16 ulp at |phi| in [0.5, 1).
ONE = 2.0 ** -8
N = 48
DX = 2.4 / (N - 1)
H, H1 = 0.1 * DX, 0.01 * DX * DX


def ulps(a, b, floor=2.0 ** -126):
    """Per cell |a - b| in bfloat16 ulps of the larger magnitude, or of
    ``floor`` where that is larger (8 significant bits: the spacing at |x|
    in [2^e, 2^(e+1)) is 2^(e-7))."""
    a, b = (np.asarray(x, np.float64) for x in (a, b))
    m = np.maximum(np.maximum(np.abs(a), np.abs(b)), floor)
    ulp = np.exp2(np.floor(np.log2(np.maximum(m, 2.0 ** -126))) - 7)
    return np.abs(a - b) / ulp


def host(x):
    """A bfloat16 array of either package as float64 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float64).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float64))


def ellipsoid(n=N):
    ax = np.linspace(-1.2, 1.2, n)
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    return (np.sqrt(x ** 2 + 1.3 * y ** 2 + 0.8 * z ** 2) - 0.7).astype(
        np.float32)


def pair(a):
    return jnp.asarray(a, jnp.bfloat16), torch.tensor(a).to(BF)


# ------------------------------- routing -------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
def test_kernel_route_is_chosen_by_dtype(dtype):
    """The predicate (``pallas_supported``'s port): float32 3-D grids take
    the kernels, bfloat16 and float64 their plain versions, on any
    device; meta tensors stand in for the card's."""
    f32 = dtype == torch.float32
    assert wc.kernel_supported((31, 31, 31), dtype) is f32
    assert not wc.kernel_supported((31, 31), dtype)
    for dev in ("cpu", "meta"):
        phi = torch.empty((2, 19, 19, 19), dtype=dtype, device=dev)
        assert (wc.route(phi[0], wc.reinit_step, wc.reinit_step_plain)
                is (wc.reinit_step if f32 else wc.reinit_step_plain))
        assert (wc.route(phi, mc.minmax_step_packed,
                         mc.minmax_step_packed_plain)
                is (mc.minmax_step_packed if f32
                    else mc.minmax_step_packed_plain))
        assert (wc.route(phi[0], mc.minmax_step, mc.minmax_step_plain)
                is (mc.minmax_step if f32 else mc.minmax_step_plain))
        assert wc.solve_buffers(phi[0]) is None     # no card here
    # the options' term: only the default options have a kernel form
    assert mf.kernel_form()
    assert not mf.kernel_form(use_true_curvature=True)
    assert not mf.kernel_form(avg_halfwidth=2)


class _Calls:
    """Count the calls of every kernel wrapper (the only launch sites)."""

    def __init__(self, monkeypatch):
        self.n = {}
        for mod in (wc, mc):
            for name in (
                    "reinit_step", "reinit_step_vjp", "reinit_step_vjp_banded",
                    "reinit_step_block", "reinit_step_block_vjp",
                    "reinit_step_packed", "minmax_step", "minmax_fusedk",
                    "minmax_step_vjp", "minmax_step_vjp_banded",
                    "minmax_step_block", "minmax_step_block_vjp",
                    "minmax_step_packed", "minmax_fusedk_block"):
                if not hasattr(mod, name):
                    continue
                self.n[name] = 0
                real = getattr(mod, name)

                def wrapped(*a, _real=real, _name=name, **kw):
                    self.n[_name] += 1
                    return _real(*a, **kw)
                monkeypatch.setattr(mod, name, wrapped)


def _every_solver(dtype):
    """Each solver of the slice once, forward and backward: dense, banded,
    fixed-step, packed and sharded."""
    phi = torch.tensor(ellipsoid(24)).to(dtype)
    dx = 2.4 / 23
    re.reinit(phi, dx, 0.1 * dx, 2, 0.0)
    re.reinit_narrowband(phi, dx, 0.1 * dx, 2, 0.0, refresh_every=2)
    mf.minmax_flow(phi, dx, 0.01 * dx * dx, 2, 0.0)
    mf.minmax_flow_narrowband(phi, dx, 0.01 * dx * dx, 20, 0.0)
    q = phi.clone().requires_grad_(True)
    (re.reinit_fixed(q, dx, 0.1 * dx, 2).sum()
     + mf.minmax_flow_fixed(q, dx, 0.01 * dx * dx, 2).sum()
     + wc.reinit_scan_banded(q, dx, 0.1 * dx, 2).sum()
     + mc.minmax_scan(q, dx, 0.01 * dx * dx, 2, banded=True).sum()
     ).backward()
    b2 = torch.stack([phi, phi])
    batch.reinit_batched_packed(b2, dx, [0.1 * dx] * 2, 2, 0.0)
    batch.minmax_batched_packed(b2, dx, [0.01 * dx * dx] * 2, 2, 0.0)
    mesh = make_mesh((2, 1, 1), ["cpu"])
    s = sh.ShardedLevelSet(mesh, phi.shape, dx)
    blocks = s.device_put(phi)
    s.reinit(blocks, 0.1 * dx, 2, 0.0)
    s.minmax_flow(blocks, 0.01 * dx * dx, 2, 0.0)
    qb = [b.clone().requires_grad_(True) for b in blocks]
    out = (sh.reinit_fixed_sharded(mesh, qb, dx, 0.1 * dx, 2)
           + sh.minmax_fixed_sharded(mesh, qb, dx, 0.01 * dx * dx, 2))
    sum(o.sum() for o in out).backward()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
def test_float32_takes_the_kernel_route_others_the_plain_one(monkeypatch,
                                                             dtype):
    """Every solver of the slice: a float32 field calls the kernel
    wrappers (on the CPU they run their plain versions, on the card the
    kernels), a bfloat16 or float64 field calls none of them, so on the
    card it launches no kernel."""
    calls = _Calls(monkeypatch)
    _every_solver(dtype)
    if dtype == torch.float32:
        for name in ("reinit_step", "reinit_step_vjp",
                     "reinit_step_vjp_banded", "reinit_step_block",
                     "reinit_step_block_vjp", "reinit_step_packed",
                     "minmax_step", "minmax_fusedk", "minmax_step_vjp",
                     "minmax_step_vjp_banded", "minmax_step_block",
                     "minmax_step_block_vjp", "minmax_step_packed"):
            assert calls.n[name] > 0, name
    else:
        assert set(calls.n.values()) == {0}, calls.n


# ------------------------------ one step -------------------------------

#: Cells off by one bfloat16 ulp in one step of the 48^3 ellipsoid (of
#: 110,592; measured 943 and 142); none off by more.  The min/max step's
#: Laplacian, a difference of six neighbours, cancels to an absolute
#: error, so there the ulp is taken of max(|phi|, 2^-6): at most 2^-13
#: (measured 2^-13 beside the surface).
STEP_CAPS = {"reinit": 1500, "minmax": 300}
ULP_FLOOR = {"reinit": 2.0 ** -126, "minmax": 2.0 ** -6}


@pytest.mark.parametrize("step", ["reinit", "minmax"])
def test_one_bf16_step_matches_jax(step):
    pj, pt = pair(ellipsoid())
    if step == "reinit":
        ref = jax_reinit.reinit_step(pj, pj, DX, H)
        ours = wc.reinit_step_plain(pt, pt, DX, H)
    else:
        ref = jax_minmax.minmax_step(pj, DX, H1)
        ours = mc.minmax_step_plain(pt, DX, H1)
    assert ours.dtype == BF
    u = ulps(host(ours), host(ref), ULP_FLOOR[step])
    assert u.max() <= 1.0
    assert 0 < int((u > 0).sum()) <= STEP_CAPS[step], int((u > 0).sum())


# ---------------------------- dense solvers ----------------------------

#: (JAX, port) iterations of the dense solvers to tol on the ellipsoid:
#: reinit at 1e-5, min/max at 1e-7 (see the module docstring).
COUNTS = {"reinit": (42, 39), "minmax": (71, 67)}
#: Fields after 30 fixed steps (tol 0) of each dense solver, max abs
#: difference (measured 0.0098, 2.5 ulps of |phi| in [0.5, 1), and
#: 2.4e-4): the one-ulp steps add up where the field moves.
FIXED_ATOL = {"reinit": 0.015, "minmax": 5e-4}


@pytest.mark.parametrize("solver", ["reinit", "minmax"])
def test_bf16_dense_solvers_and_their_counts(solver):
    pj, pt = pair(ellipsoid())
    if solver == "reinit":
        rj, rt = (jax_reinit.reinit(pj, DX, H, 200, 1e-5),
                  re.reinit(pt, DX, H, 200, 1e-5))
        fj, ft = (jax_reinit.reinit(pj, DX, H, 30, 0.0),
                  re.reinit(pt, DX, H, 30, 0.0))
    else:
        rj, rt = (jax_minmax.minmax_flow(pj, DX, H1, 200, 1e-7),
                  mf.minmax_flow(pt, DX, H1, 200, 1e-7))
        fj, ft = (jax_minmax.minmax_flow(pj, DX, H1, 30, 0.0),
                  mf.minmax_flow(pt, DX, H1, 30, 0.0))
    assert (int(rj.iterations), rt.iterations) == COUNTS[solver]
    assert not rt.diverged and np.isfinite(host(rt.phi)).all()
    assert (int(fj.iterations), ft.iterations) == (30, 30)
    d = np.abs(host(ft.phi) - host(fj.phi))
    assert d.max() <= FIXED_ATOL[solver]


# -------------------------------- init ---------------------------------

#: Culled init, bfloat16, icosphere of 320 triangles at dx 0.08 (39^3 =
#: 59,319 points): cells off by more than one ulp (measured 7,460) and
#: sign disagreements (measured 69, all within 0.06 of the surface).
INIT_CAPS = {"off": 9000, "signs": 120, "sign_band": 0.1}


def test_bf16_culled_init_matches_jax_up_to_its_near_ties():
    """Where the bfloat16 quadratic form ties two triangles the packages
    may pick either; those cells are counted and capped.  Both inits are
    held to the same accuracy against the float64 init: the port's
    median and maximum error are at most 1.25 times the JAX package's."""
    mesh = analytic.icosphere_mesh(subdivisions=2)
    g = gridmod.from_surface(mesh.vertices, 0.08, 6)
    jg = jax_grid.from_surface(mesh.vertices, 0.08, 6)
    ours = host(init_sign.signed_distance_init(g, mesh.vertices,
                                               mesh.elements, dtype=BF))
    ref = host(jax_init.signed_distance_init(
        jg, jnp.asarray(mesh.vertices, jnp.bfloat16),
        jnp.asarray(mesh.elements), dtype=jnp.bfloat16,
        culling=jax_init.build_init_culling(jg, mesh.vertices,
                                            mesh.elements)))
    exact = init_sign.signed_distance_init(g, mesh.vertices, mesh.elements,
                                           dtype=torch.float64).numpy()
    assert ours.shape == ref.shape == (39, 39, 39)
    off = int((ulps(ours, ref) > 1).sum())
    flips = np.sign(ours) != np.sign(ref)
    assert off <= INIT_CAPS["off"], off
    assert int(flips.sum()) <= INIT_CAPS["signs"], int(flips.sum())
    assert np.abs(ref[flips]).max() <= INIT_CAPS["sign_band"]
    eo, er = np.abs(ours - exact), np.abs(ref - exact)
    assert np.median(eo) <= 1.25 * np.median(er)
    assert eo.max() <= 1.25 * er.max()


# ------------------------------ advection ------------------------------

def test_bf16_advection_matches_jax():
    """Seeded nodes advected 7 iterations on a sphere SDF: within 2^-8 of
    the JAX package's, one bfloat16 ulp at |x| in [0.5, 1) (measured 30 of
    120 coordinates off by that much)."""
    shape, dx, origin = (20, 20, 20), 0.1, (-0.95, -0.85, -0.75)
    axes = [o + dx * np.arange(n) for o, n in zip(origin, shape)]
    x, y, z = np.meshgrid(*axes, indexing="ij")
    phi = np.sqrt(x ** 2 + y ** 2 + z ** 2) - 0.5
    pts = np.random.default_rng(5).uniform(-0.6, 0.6, size=(40, 3))
    a = jax_advect.advect_nodes(jnp.asarray(phi, jnp.bfloat16),
                                JGrid(shape, origin, dx),
                                jnp.asarray(pts, jnp.bfloat16), dx, iters=7)
    b = port_advect.advect_nodes(torch.tensor(phi).to(BF),
                                 Grid3D(shape, origin, dx),
                                 torch.tensor(pts).to(BF), dx, iters=7)
    assert b.positions.dtype == BF
    d = np.abs(host(b.positions) - host(a.positions))
    assert d.max() <= ONE and int((d > 0).sum()) <= 40


# ------------------------------ pipelines ------------------------------

BASE = dict(dx=0.1, pad_cells=6, reinit_iters=45, reinit_tol=0.0,
            minmax_iters=25, minmax_tol=0.0, advect_iters=10,
            final_reinit_iters=9)
FIELDS = ("phi_init", "phi_smoothed", "phi_final", "advected")


def _configs(**kw):
    jcfg = JaxConfig(**{**BASE, **kw}, dtype=jnp.bfloat16)
    cfg = LevelSetConfig.from_reference_fields(dataclasses.asdict(jcfg),
                                               device="cpu")
    assert cfg.dtype == BF
    return jcfg, cfg


@pytest.fixture(scope="module")
def bf16_runs():
    """The port's bfloat16 run_mesh of an icosphere (1,280 triangles) and
    the JAX package's from the port's init; then the port's run with
    ``mesh_shape=(2, 2, 1)`` and the solo run from that run's init."""
    mesh = analytic.icosphere_mesh(subdivisions=3)
    jmesh = jax_analytic.icosphere_mesh(subdivisions=3)
    jcfg, cfg = _configs()
    inits = []
    real = port_run.signed_distance_init
    port_run.signed_distance_init = lambda *a, **k: inits.append(
        real(*a, **k)) or inits[-1]
    real_sh = port_run.signed_distance_init_sharded
    port_run.signed_distance_init_sharded = lambda *a, **k: inits.append(
        real_sh(*a, **k)) or inits[-1]
    real_j = jax_run.signed_distance_init
    try:
        ours = port_run.run_mesh(mesh, cfg)
        jax_run.signed_distance_init = lambda *a, **k: jnp.asarray(
            inits[0].float().numpy(), jnp.bfloat16)
        ref = jax_run.run_mesh(jmesh, jcfg)
        sharded = port_run.run_mesh(mesh, cfg.replace(mesh_shape=(2, 2, 1)))
        whole = gather_blocks(make_mesh((2, 2, 1), ["cpu"]), inits[1])
        port_run.signed_distance_init = lambda *a, **k: whole
        solo = port_run.run_mesh(mesh, cfg)
        jax_run.signed_distance_init = lambda *a, **k: jnp.asarray(
            whole.float().numpy(), jnp.bfloat16)
        ref_sharded = jax_run.run_mesh(jmesh, jcfg)
    finally:
        port_run.signed_distance_init = real
        port_run.signed_distance_init_sharded = real_sh
        jax_run.signed_distance_init = real_j
    return dict(ours=ours, ref=ref, sharded=sharded, solo=solo,
                ref_sharded=ref_sharded)


#: run_mesh, bfloat16, 45 / 25 fixed steps, 9 final reinit steps, 10
#: advection iterations, on the port's init (an icosphere's 42^3 grid):
#: each field's max abs difference from the JAX package's (measured
#: 0.0100, 0.0153, 0.0153), its cells off by more than 2^-8 (measured 9)
#: and the advected nodes' (measured 0.0156, two ulps at |x| in [1, 2)).
#: run_batch's vmap reference (two 31^3 geometries, 15 / 5 steps):
#: measured 0.0195 and 0.0332, 761 and 703 cells, nodes 0.0273.
RUN_CAPS = {"atol": 0.03, "cells": 50, "advected": 0.04}
BATCH_CAPS = {"atol": 0.05, "cells": 1200, "advected": 0.04}


def _hold_run(ours, ref, caps=RUN_CAPS):
    assert ours.grid.shape == tuple(ref.grid.shape)
    assert (ours.reinit_iters, ours.minmax_iters) == (
        int(ref.reinit_iters), int(ref.minmax_iters)) == (45, 25)
    for f in FIELDS[:3]:
        a, b = getattr(ours, f), np.asarray(getattr(ref, f), np.float64)
        assert a.dtype == np.float64 and np.isfinite(a).all()
        d = np.abs(a - b)
        assert d.max() <= caps["atol"], f
        assert int((d > ONE).sum()) <= caps["cells"], f
    d = np.abs(ours.advected - np.asarray(ref.advected)).max()
    assert d <= caps["advected"], d
    # a bfloat16 sum of squared differences in both packages, the JAX
    # package's also rounded to bfloat16 (measured 11% apart)
    assert ours.asymptotic_error == pytest.approx(
        float(ref.asymptotic_error), rel=0.25)


def test_bf16_run_mesh_matches_jax(bf16_runs):
    _hold_run(bf16_runs["ours"], bf16_runs["ref"])


def _sphere_errors(res):
    """Against the unit sphere: the near-surface (|truth| < 0.2) errors of
    the signed-distance field (median, 90th percentile, max), the
    smoothed field's median, and the advected nodes' |truth| (90th
    percentile, max)."""
    g = res.grid
    axes = [np.asarray(o, np.float64) + g.dx * np.arange(n)
            for o, n in zip(g.origin, g.shape)]
    truth = np.linalg.norm(np.stack(np.meshgrid(*axes, indexing="ij"), -1),
                           axis=-1) - 1.0
    near = np.abs(truth) < 0.2
    sdf, smooth = (np.abs(np.asarray(getattr(res, f), np.float64)
                          - truth)[near]
                   for f in ("phi_init", "phi_smoothed"))
    adv = np.abs(np.linalg.norm(np.asarray(res.advected, np.float64),
                                axis=-1) - 1.0)
    return dict(sdf_median=np.median(sdf), sdf_p90=np.percentile(sdf, 90),
                sdf_max=sdf.max(), smoothed_median=np.median(smooth),
                advected_p90=np.percentile(adv, 90), advected_max=adv.max())


#: The port's bfloat16 errors against the sphere over the JAX package's,
#: each package from its own init (the icosphere of 1,280 triangles at
#: dx 0.1, the run caps above): measured sdf median 1.084, 90th
#: percentile 1.182, max 1.446, smoothed median 0.944, advected 90th
#: percentile 1.108, max 2.037.  The maxima are single cells, where the
#: bfloat16 inits' near-ties pick other triangles, so they get the wider
#: cap.
SPHERE_VS_JAX = dict(sdf_median=1.25, sdf_p90=1.25, sdf_max=2.5,
                     smoothed_median=1.25, advected_p90=1.25,
                     advected_max=2.5)


def test_bf16_errors_against_the_sphere_match_jax(bf16_runs):
    """The JAX package's own bfloat16 run (its own init) against the unit
    sphere, beside the port's: the accuracy of bfloat16, not only the
    agreement of the two packages from one init."""
    jcfg = _configs()[0]
    own = jax_run.run_mesh(jax_analytic.icosphere_mesh(subdivisions=3),
                           jcfg)
    ours, ref = _sphere_errors(bf16_runs["ours"]), _sphere_errors(own)
    for k, cap in SPHERE_VS_JAX.items():
        assert np.isfinite(ours[k]) and ours[k] <= cap * ref[k], (k, ours,
                                                                  ref)


def test_bf16_sharded_run_is_the_solo_run(bf16_runs):
    """``run(mesh_shape=(2, 2, 1))`` in bfloat16: bitwise the solo run on
    the sharded run's init (its block-wise init may pick another triangle
    where the quadratic form ties), and held to the solo run's gates
    against the JAX package's run from that init."""
    sharded, solo = bf16_runs["sharded"], bf16_runs["solo"]
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(sharded, f), getattr(solo, f))
    assert (sharded.reinit_iters, sharded.minmax_iters) == (45, 25)
    _hold_run(sharded, bf16_runs["ref_sharded"])


def test_bf16_run_batch_matches_jax(monkeypatch):
    """``run_batch`` of two geometries in bfloat16 (auto: sequential here,
    vmap in the JAX package), on the port's inits, fixed counts: the
    fields within the run's caps; with ``data_parallel=2`` bitwise the
    undivided batch."""
    kw = dict(dx=0.12, pad_cells=10, reinit_iters=15, reinit_tol=0.0,
              minmax_iters=5, minmax_tol=0.0, advect_iters=3)
    jcfg = JaxConfig(**kw, dtype=jnp.bfloat16)
    cfg = LevelSetConfig.from_reference_fields(dataclasses.asdict(jcfg),
                                               device="cpu")
    meshes = [analytic.box_mesh(half_extent=(0.5, 0.5, 0.5)),
              analytic.icosphere_mesh(radius=0.5, subdivisions=1)]
    inits = []
    real = batch.signed_distance_init
    monkeypatch.setattr(batch, "signed_distance_init", lambda *a, **k: (
        inits.append(real(*a, **k)) or inits[-1]))
    ours = run_batch(meshes, cfg)
    halves = run_batch(meshes, cfg, data_parallel=2)
    given = iter(inits)
    monkeypatch.setattr(jax_batch, "signed_distance_init", lambda *a, **k: (
        jnp.asarray(next(given).float().numpy(), jnp.bfloat16)))
    ref = jax_batch.run_batch(
        [jax_analytic.box_mesh(half_extent=(0.5, 0.5, 0.5)),
         jax_analytic.icosphere_mesh(radius=0.5, subdivisions=1)], jcfg)
    for a, b, c in zip(ours, ref, halves):
        assert (a.reinit_iters, a.minmax_iters) == (
            b.reinit_iters, b.minmax_iters) == (15, 5)
        for f in ("phi_init", "phi_smoothed", "advected"):
            np.testing.assert_array_equal(getattr(a, f), getattr(c, f))
        for f in ("phi_init", "phi_smoothed"):
            d = np.abs(getattr(a, f) - getattr(b, f))
            assert d.max() <= BATCH_CAPS["atol"]
            assert int((d > ONE).sum()) <= BATCH_CAPS["cells"]
        assert np.abs(a.advected - np.asarray(b.advected)).max() <= (
            BATCH_CAPS["advected"])


# --------------------------- differentiable ----------------------------

#: Gradients of ``sum(w * solve(phi0, dx, h))``, 4 fixed steps of the 48^3
#: ellipsoid (and of 1.5 times it, where |grad phi| is far from 1) in
#: bfloat16, weights uniform in [0.5, 1.5).  The phi gradient is held to
#: ``jax.grad`` of the JAX package's jnp route on the same bfloat16 inputs:
#: per cell in bfloat16 ulps (the median and the 90th percentile), and as a
#: direction (cosine, relative L2 distance).  Both packages' bfloat16
#: gradients lie ~0.3 (reinit) / ~0.007 (min/max) in relative L2 from the
#: float64 gradient of the same inputs, and the port's may be at most
#: ``vs_f64`` times as far from it as the JAX package's.  Measured (scale
#: 1 / 1.5): reinit median 2 / 2 ulps, 90th 20 / 23, cosine 0.9971 /
#: 0.9969, distance 0.076 / 0.079, 0.96 / 0.99 times as far; min/max 0 / 0,
#: 1 / 0, 0.99992 / 0.99999, 0.0126 / 0.0053, 1.63 / 1.03 times as far.
GRAD_CAPS = {"reinit": dict(p50=4, p90=40, cos=0.99, rel=0.12, vs_f64=1.25),
             "minmax": dict(p50=1, p90=2, cos=0.9995, rel=0.025, vs_f64=2.0)}
#: The dx and h / h1 cotangents, held to the JAX package's float64 ones on
#: the same (bfloat16-valued) inputs, relative: the port adds the cells'
#: terms in float64, the JAX package in bfloat16, whose sums land 33-90%
#: under the float64 value (reinit dx 13,696 against 49,308).  Measured
#: (dx, h at scale 1 / 1.5): reinit 0.2%, 3.4% / 0.09%, 0.9% (h at scale
#: 1: (1 - |grad phi|) is mostly rounding there); min/max 1.2%, 1.2% /
#: 0.8%, 0.7%.
SCALAR_RTOL = 0.05
GRAD_STEPS = 4


@functools.lru_cache(maxsize=None)
def _jax_grad_fn(solver, dtype):
    fixed = {"reinit": jax_reinit.reinit_fixed,
             "minmax": jax_minmax.minmax_flow_fixed}[solver]

    def loss(p, dx, h, w):
        out = fixed(p, dx, h, GRAD_STEPS, use_pallas=False)
        return jnp.sum((w * out).astype(jnp.float64))
    return jax.jit(jax.grad(loss, argnums=(0, 1, 2)))


@functools.lru_cache(maxsize=None)
def _grad_inputs(scale):
    """The field, the scalars and the weights, all bfloat16-valued, as
    float64 numpy."""
    phi = host(torch.tensor(scale * ellipsoid()).to(BF))
    w = host(torch.tensor(np.random.default_rng(3).uniform(
        0.5, 1.5, phi.shape)).to(BF))
    return phi, w


@functools.lru_cache(maxsize=None)
def _jax_grads(solver, scale, dtype):
    phi, w = _grad_inputs(scale)
    h = H if solver == "reinit" else H1
    dt = jnp.dtype(dtype)
    g = _jax_grad_fn(solver, dtype)(
        jnp.asarray(phi, dt), jnp.asarray(host(torch.tensor(DX).to(BF)), dt),
        jnp.asarray(host(torch.tensor(h).to(BF)), dt), jnp.asarray(w, dt))
    return tuple(host(x) for x in g)


def _port_grads(solver, variant, scale):
    phi, w = _grad_inputs(scale)
    x = torch.tensor(phi).to(BF).requires_grad_(True)
    dx, h = (torch.tensor(v).to(BF).requires_grad_(True)
             for v in (DX, H if solver == "reinit" else H1))
    if variant == "sharded":
        m = make_mesh((2, 1, 1), ["cpu"])
        fixed = {"reinit": sh.reinit_fixed_sharded,
                 "minmax": sh.minmax_fixed_sharded}[solver]
        out = gather_blocks(m, fixed(m, split_blocks(m, x), dx, h,
                                     GRAD_STEPS))
    elif solver == "reinit":
        out = (re.reinit_fixed(x, dx, h, GRAD_STEPS) if variant == "dense"
               else wc.reinit_scan_banded(x, dx, h, GRAD_STEPS,
                                          band_radius=1e3))
    else:
        out = (mf.minmax_flow_fixed(x, dx, h, GRAD_STEPS)
               if variant == "dense"
               else mc.minmax_scan(x, dx, h, GRAD_STEPS, banded=True))
    assert out.dtype == BF
    (torch.tensor(w).to(BF) * out).double().sum().backward()
    return tuple(host(t.grad) for t in (x, dx, h))


def _cosine(a, b):
    return float((a * b).sum() / np.sqrt((a * a).sum() * (b * b).sum()))


def _distance(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("scale", [1.0, 1.5])
@pytest.mark.parametrize("variant", ["dense", "banded", "sharded"])
@pytest.mark.parametrize("solver", ["reinit", "minmax"])
def test_bf16_gradients_match_jax(solver, variant, scale):
    """The bfloat16 VJPs of the fixed-step solvers, dense, banded
    (``reinit_scan_banded`` with every brick active, as its float32 test
    against the JAX package; ``minmax_scan(banded=True)`` on its real mask,
    which is the dense function) and sharded on a (2, 1, 1) mesh (the phi
    gradient bitwise the dense one), against ``jax.grad`` of the JAX
    package's jnp route on the same inputs (see ``GRAD_CAPS``)."""
    ours = _port_grads(solver, variant, scale)
    ref = _jax_grads(solver, scale, "bfloat16")
    exact = _jax_grads(solver, scale, "float64")
    caps = GRAD_CAPS[solver]
    u = ulps(ours[0], ref[0])
    assert np.isfinite(ours[0]).all()
    assert np.percentile(u, 50) <= caps["p50"]
    assert np.percentile(u, 90) <= caps["p90"]
    assert _cosine(ours[0], ref[0]) >= caps["cos"]
    assert _distance(ours[0], ref[0]) <= caps["rel"]
    assert (_distance(ours[0], exact[0])
            <= caps["vs_f64"] * _distance(ref[0], exact[0]))
    for got, want in zip(ours[1:], exact[1:]):
        assert abs(float(got) - float(want)) <= SCALAR_RTOL * abs(float(want))
    if variant == "sharded":
        assert np.array_equal(ours[0], _port_grads(solver, "dense", scale)[0])
    if variant == "banded" and solver == "minmax":
        act = wc.tile_activity(torch.tensor(_grad_inputs(scale)[0]).to(BF),
                               DX, 4.1, window="band4")
        assert 0 < int(act.sum()) < act.numel()



def _octahedron(scale=0.7):
    v = scale * np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                          [0, 0, 1], [0, 0, -1]], np.float64)
    f = np.array([[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4],
                  [2, 0, 5], [1, 2, 5], [3, 1, 5], [0, 3, 5]], np.int32)
    return v, f


def test_bf16_render_loss_and_vertex_grad_against_jax():
    """``image_loss_and_vertex_grad`` of the 24^3 octahedron in bfloat16
    on the plain route (the JAX package: its jnp route).  The bfloat16
    init is noise-dominated in both packages (a 12x12 image of the
    octahedron is no diamond in either), so only the scale is held: the
    loss within 15% of the JAX package's (measured 6.2%) and both
    gradients finite, nonzero and of one order of magnitude.  The
    solvers' bfloat16 VJPs on one field are held to the JAX package's in
    :func:`test_bf16_gradients_match_jax`."""
    v, f = _octahedron()
    n, half = 24, 1.2
    kw = dict(shape=(n, n, n), origin=(-half,) * 3, dx=2 * half / (n - 1))
    args = dict(eye=(0.0, -3.0, 0.0), target=(0.0, 0.0, 0.0),
                reinit_steps=5, minmax_steps=3, height=12, width=12,
                n_march_steps=48)
    lj, gj = jax_diff.image_loss_and_vertex_grad(
        jnp.asarray(v, jnp.bfloat16), jnp.asarray(f), JGrid(**kw),
        jnp.zeros((12, 12), jnp.bfloat16), use_pallas=False, **args)
    lt, gt = image_loss_and_vertex_grad(
        torch.tensor(v).to(BF), torch.from_numpy(f), Grid3D(**kw),
        torch.zeros((12, 12), dtype=BF), **args)
    assert lt.dtype == gt.dtype == BF and gt.shape == (6, 3)
    gt, gj = host(gt), host(gj)
    assert abs(float(lt) - float(lj)) <= 0.15 * abs(float(lj))
    assert np.isfinite(gt).all() and np.abs(gt).max() > 0
    assert 0.1 <= np.abs(gt).max() / np.abs(gj).max() <= 10.0


# ----------------------------- checkpoints -----------------------------

def test_bf16_checkpoint_round_trip_and_a_jax_state(tmp_path):
    """bfloat16 blocks round-trip through ``torch.save`` bitwise; a JAX
    bfloat16 state (``np.asarray`` of it is an ``ml_dtypes`` array) goes
    in through its 16-bit pattern, and the port resumes the solve from it
    to within the dense solver's caps of the JAX uninterrupted result."""
    phi = torch.tensor(ellipsoid(24)).to(BF)
    blocks = list(torch.chunk(phi, 2, dim=0))
    with FieldCheckpointer(str(tmp_path / "rt")) as c:
        c.save(1, phi)
        c.save(2, blocks)
        one = c.restore(1, like=phi)["phi"]
        two = c.restore(2, like=blocks)["phi"]
    assert one.dtype == BF and torch.equal(one.view(torch.int16),
                                           phi.view(torch.int16))
    assert all(torch.equal(a, b) for a, b in zip(two, blocks))

    dx = 2.4 / 23
    args = (dx, 0.1 * dx, 50, 0.0)
    pj = jnp.asarray(ellipsoid(24), jnp.bfloat16)
    stopped = jax_ckpt.reinit_resumable(pj, *args[:2], 20, 0.0, chunk=20)
    full = jax_ckpt.reinit_resumable(pj, *args, chunk=10)
    state = np.asarray(stopped.phi)
    assert state.dtype.name == "bfloat16"
    carried = as_tensor(state)
    assert carried.dtype == BF and np.array_equal(
        carried.float().numpy(), np.asarray(stopped.phi, np.float32))
    with FieldCheckpointer(str(tmp_path / "jax")) as c:
        c.save(20, state, extra={"iterations": 20, "stage": "reinit"})
        ours = ck.reinit_resumable(torch.tensor(ellipsoid(24)).to(BF),
                                   *args, ckpt=c, chunk=10)
    assert ours.resumed_from == 20 and ours.iterations == 50
    d = np.abs(host(ours.phi) - host(full.phi))
    assert d.max() <= FIXED_ATOL["reinit"]      # measured 0.0078


# --------------------------------- CLI ---------------------------------

def test_cli_dtype_bfloat16(tmp_path, capsys):
    """``--dtype bfloat16``: the same config as the JAX CLI's, and a run
    on the CPU that writes its outputs."""
    stl = str(tmp_path / "ball.stl")
    write_stl(stl, analytic.icosphere_mesh(subdivisions=1))
    argv = [stl, "--dtype", "bfloat16", "--dx", "0.15",
            "--reinit-iters", "6", "--minmax-iters", "4",
            "--advect-iters", "3", "--final-reinit-iters", "2"]
    cfg = cli.config_from_args(cli.build_parser().parse_args(argv))
    jcfg = jax_cli.config_from_args(jax_cli.build_parser().parse_args(argv))
    assert cfg.dtype == BF and jcfg.dtype == jnp.bfloat16
    assert cfg == LevelSetConfig.from_reference_fields(
        dataclasses.asdict(jcfg), device="cuda")
    out = tmp_path / "out"
    assert cli.main(argv + ["--device", "cpu", "--out-dir", str(out)]) == 0
    assert "reinit_iters=6 minmax_iters=4" in capsys.readouterr().out
    assert {p.name for p in out.iterdir()} == {
        "signedDistanceFunction.vti", "smoothedDistanceFunction.vti",
        "ball.s3d"}
