"""The one generator of jobs: a cell's inputs from its configuration, its
traffic's parameters and the seed.

A traffic file (``traffic/<name>.json``) names the entry that drives the
program and sets ``pool`` (distinct jobs, cycled in order), ``scale`` (the
range of the bodies' scales), ``shuffle_block`` (the seed orders the pool
within blocks of this many jobs; default 4), ``rotate_deg`` (the largest
rotation about a seeded axis; default 0, the body never turns) and what
its entry reads besides.
"""

from __future__ import annotations

import os

from h100bench import meshes


def levelset_config(ctx):
    """The program's configuration: the file's ``dx``, ``pad_cells`` and
    ``levelset`` fields, on the run's device (and in the control's
    dtype)."""
    import torch
    from levelsetfortran_tpu_torch import LevelSetConfig
    c = ctx.config
    kw = dict(c.get("levelset", {}))
    if ctx.dtype:
        kw["dtype"] = getattr(torch, ctx.dtype)
    return LevelSetConfig(dx=c["dx"], pad_cells=c["pad_cells"],
                          device=ctx.device, **kw)


def soups(ctx) -> tuple:
    """(the pool's float32 triangle soups, the warm-up's)."""
    t = ctx.traffic
    base = meshes.base_soup(ctx.config["body"])
    made = [meshes.transform(base, s, axis, angle) for s, axis, angle in
            meshes.variants(ctx.seed, int(t["pool"]), t["scale"],
                            t.get("rotate_deg", 0.0),
                            int(t.get("shuffle_block", 4)))]
    return made[:-1], made[-1]


def stl_files(soups, directory: str, stem: str = "job") -> list:
    paths = []
    for k, soup in enumerate(soups):
        path = os.path.join(directory, f"{stem}{k:02d}.stl")
        meshes.write_stl(path, soup)
        paths.append(path)
    return paths
