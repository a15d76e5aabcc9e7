"""How far the serving path rounds a box's edges: the advected nodes of
``run_batch`` on 192-triangle boxes (4 quads per edge), the port against
the JAX package.

Min/max flow rounds a box's edges and corners, so the nodes there settle
off the original box by more than the 1.5 dx that face and sphere nodes
keep; chip_smoke.py's run E caps edge and corner nodes at 2 dx.  The JAX
package's own run_batch is the second witness for that cap.

The test (CPU, ~20 s): box (0.8, 0.5, 0.3) alone at dx 0.07 (no face on
a grid point), both packages from the port's init, 100 reinit and 100
min/max steps and 250 advection iterations as in run E.  The solver
stages are capped: run to their tolerances on this coarse grid they take
~1000 and ~300 steps, creeping along an RMS plateau where the last-bit
differences between the port's plain steps and the JAX package's
whole-grid jnp steps (its strategy off the TPU) move the stop by up to 2%
of the steps.  Equal counts; the advected nodes within 5e-4 (measured
1.5e-4: 100 steps of last-bit differences) and the largest face, edge and
corner |sdf| within 0.01 dx (measured 5e-4 dx).

Run as a script for run E's own size, each package from its own init
(at dx 0.015 no face lies on a grid point):

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_box_edges.py

It prints, per package and box, the largest advected |sdf| in units of
dx on face, edge and corner nodes (~90 s and 1.4 GiB on a CPU).
"""

import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from levelsetfortran_tpu.config import LevelSetConfig as JaxConfig
from levelsetfortran_tpu.models import analytic as jax_analytic
from levelsetfortran_tpu.pipeline import batch as jax_batch
from levelsetfortran_tpu_torch import run_batch
from levelsetfortran_tpu_torch.config import LevelSetConfig
from levelsetfortran_tpu_torch.models import analytic
from levelsetfortran_tpu_torch.pipeline import batch

BOXES = ((0.8, 0.5, 0.3), (0.8, 0.8, 0.8))
ADVECT_ITERS = 250


def _meshes(pkg, boxes):
    return [pkg.box_mesh(half_extent=e, subdivisions=4) for e in boxes]


def edge_maxima(items, dx, boxes):
    """Per box, the largest advected |sdf| / dx on its face, edge and
    corner nodes (a node on 1, 2 or 3 of the box's planes)."""
    out = []
    for it, e in zip(items, boxes):
        v = np.asarray(it.mesh.vertices)
        on = np.isclose(np.abs(v), np.float32(e)).sum(1)
        adv = np.abs(analytic.sdf_box(np.asarray(it.advected), (0, 0, 0), e))
        out.append({kind: float(adv[on == n].max() / dx)
                    for kind, n in (("face", 1), ("edge", 2), ("corner", 3))})
    return out


def run_both(dx, boxes, *, same_init, **kw):
    """Both packages' run_batch on ``boxes`` on the CPU in float32, with
    the config fields ``kw``; with ``same_init`` the JAX package starts
    from the port's init."""
    kw.update(dx=dx, advect_iters=ADVECT_ITERS)
    cfg = LevelSetConfig(**kw, device="cpu")
    jcfg = JaxConfig(**kw, dtype=jnp.float32)
    assert cfg == LevelSetConfig.from_reference_fields(
        dataclasses.asdict(jcfg), device="cpu")
    inits = []
    real = batch.signed_distance_init

    def keep(*a, **k):
        inits.append(real(*a, **k))
        return inits[-1]

    batch.signed_distance_init = keep
    try:
        ours = run_batch(_meshes(analytic, boxes), cfg)
    finally:
        batch.signed_distance_init = real
    jreal = jax_batch.signed_distance_init
    if same_init:
        given = iter(inits)
        jax_batch.signed_distance_init = (
            lambda *a, **k: jnp.asarray(next(given).numpy()))
    try:
        ref = jax_batch.run_batch(_meshes(jax_analytic, boxes), jcfg)
    finally:
        jax_batch.signed_distance_init = jreal
    return ours, ref


def test_box_edges_round_as_in_jax():
    torch.set_num_threads(1)
    dx, boxes = 0.07, BOXES[:1]
    ours, ref = run_both(dx, boxes, same_init=True, reinit_iters=100,
                         minmax_iters=100)
    for a, b in zip(ours, ref):
        assert (a.reinit_iters, a.minmax_iters) == (b.reinit_iters,
                                                    b.minmax_iters)
        np.testing.assert_allclose(a.advected, b.advected, rtol=0,
                                   atol=5e-4)
    for mine, theirs in zip(edge_maxima(ours, dx, boxes),
                            edge_maxima(ref, dx, boxes)):
        for kind in ("face", "edge", "corner"):
            assert abs(mine[kind] - theirs[kind]) < 0.01, (kind, mine, theirs)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dx", type=float, default=0.015)
    dx = ap.parse_args().dx
    jax.config.update("jax_enable_x64", True)   # as tests/conftest.py
    ours, ref = run_both(dx, BOXES, same_init=False)
    print(f"dx {dx}, common grid {ours[0].grid.shape}, {ADVECT_ITERS} "
          f"advection iterations; largest advected |sdf| / dx")
    for pkg, items in (("port", ours), ("jax", ref)):
        for it, e, m in zip(items, BOXES, edge_maxima(items, dx, BOXES)):
            print(f"{pkg:4s} box {e}: reinit_iters {it.reinit_iters}, "
                  f"minmax_iters {it.minmax_iters}, face {m['face']:.4f}, "
                  f"edge {m['edge']:.4f}, corner {m['corner']:.4f}")


if __name__ == "__main__":
    main()
