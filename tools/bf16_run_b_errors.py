"""bfloat16 errors of run B's configuration (an icosphere of 20,480
triangles, radius 1, every other setting the config's default) against the
analytic sphere, on the CPU, at spacings coarser than run B's 0.01.

Run B itself (222^3 at dx 0.01) is a full-size run: the JAX package does not
run on the H100's machine, and on a CPU it is too large to run beside other
work, so the bound that ``chip_smoke.py`` puts on the port's bfloat16 run B
comes from this scan.  For each spacing it prints one JSON line with the
three errors ``chip_smoke.py`` reads off run B:

* ``sdf``: the largest |phi - truth| of the signed-distance field (after
  the init and the reinit) where |truth| < 0.2;
* ``smoothed``: the median of the same over the min/max-smoothed field;
* ``advected``: the largest |truth| at the advected surface nodes;

with the iteration counts and the wall.  ``--package torch`` runs the port
instead (``device="cpu"``), for the comparison at equal spacings.

Usage:
    python tools/bf16_run_b_errors.py [--package jax|torch] [--dx 0.04 0.02]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def sphere_sdf(p):
    return np.linalg.norm(np.asarray(p, np.float64), axis=-1) - 1.0


def errors(res):
    """The three errors of a run's result (either package's)."""
    grid = res.grid
    axes = [np.asarray(o, np.float64) + grid.dx * np.arange(n)
            for o, n in zip(grid.origin, grid.shape)]
    truth = sphere_sdf(np.stack(np.meshgrid(*axes, indexing="ij"), -1))
    near = np.abs(truth) < 0.2
    sdf = np.abs(np.asarray(res.phi_init, np.float64) - truth)[near]
    smooth = np.abs(np.asarray(res.phi_smoothed, np.float64) - truth)[near]
    adv = np.abs(sphere_sdf(np.asarray(res.advected, np.float64)))
    return dict(sdf=float(sdf.max()), smoothed=float(np.median(smooth)),
                advected=float(adv.max()))


def run_jax(dx):
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from levelsetfortran_tpu.config import LevelSetConfig
    from levelsetfortran_tpu.models.analytic import icosphere_mesh
    from levelsetfortran_tpu.pipeline.run import run_mesh
    return run_mesh(icosphere_mesh(subdivisions=5),
                    LevelSetConfig(dx=dx, dtype=jnp.bfloat16))


def run_torch(dx):
    import torch
    from levelsetfortran_tpu_torch.config import LevelSetConfig
    from levelsetfortran_tpu_torch.models.analytic import icosphere_mesh
    from levelsetfortran_tpu_torch.pipeline.run import run_mesh
    return run_mesh(icosphere_mesh(subdivisions=5),
                    LevelSetConfig(dx=dx, dtype=torch.bfloat16,
                                   device="cpu"))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", choices=("jax", "torch"), default="jax")
    ap.add_argument("--dx", type=float, nargs="+", default=[0.04, 0.02])
    args = ap.parse_args(argv)
    for dx in args.dx:
        t0 = time.perf_counter()
        res = (run_jax if args.package == "jax" else run_torch)(dx)
        wall = time.perf_counter() - t0
        print(json.dumps(dict(
            package=args.package, dtype="bfloat16", dx=dx,
            shape=list(res.grid.shape), **errors(res),
            reinit_iters=int(res.reinit_iters),
            minmax_iters=int(res.minmax_iters), wall_s=round(wall, 1))),
            flush=True)


if __name__ == "__main__":
    main()
