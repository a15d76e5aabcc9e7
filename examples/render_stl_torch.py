"""Demo: run the PyTorch port's pipeline on an STL and sphere-trace the
smoothed SDF (the twin of ``render_stl.py``).

    python examples/render_stl_torch.py mesh.stl --out out.ppm --size 256
    python examples/render_stl_torch.py --device cpu --dx 0.1 --size 32

Without an STL it renders ``models.analytic``'s icosphere.  It runs on the
card unless ``--device cpu`` is given.  Writes a shaded PGM image (no
imaging dependencies) and the depth as ``<out>_depth.npy``.  Everything
upstream of the pixels is differentiable — see
``levelsetfortran_tpu_torch/pipeline/differentiable.py`` for the
vertex-gradient entry point.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from levelsetfortran_tpu_torch.config import LevelSetConfig  # noqa: E402
from levelsetfortran_tpu_torch.models.analytic import \
    icosphere_mesh  # noqa: E402
from levelsetfortran_tpu_torch.pipeline.run import run, run_mesh  # noqa
from levelsetfortran_tpu_torch.render.sphere_trace import (  # noqa: E402
    camera_rays, render)


def write_ppm(path, img):
    """img in [0, 1], shape (H, W)."""
    u8 = np.clip(np.asarray(img) * 255.0, 0, 255).astype(np.uint8)
    h, w = u8.shape
    with open(path, "wb") as f:
        f.write(f"P5\n{w} {h}\n255\n".encode())
        f.write(u8.tobytes())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("stl", nargs="?", default=None,
                    help="input STL (default: an icosphere)")
    ap.add_argument("--out", default="render.ppm", help="image path")
    ap.add_argument("--size", type=int, default=256, help="image side")
    ap.add_argument("--dx", type=float, default=None,
                    help="grid spacing (default: the config's)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    size = args.size

    kw = {} if args.dx is None else {"dx": args.dx}
    cfg = LevelSetConfig(device=args.device, **kw)
    if args.stl is None:
        res = run_mesh(icosphere_mesh(subdivisions=3), cfg)
    else:
        res = run(args.stl, cfg, write_outputs=False)
    grid = res.grid
    phi = torch.as_tensor(res.phi_smoothed, dtype=torch.float32,
                          device=args.device)

    center = tuple((o + u) / 2 for o, u in zip(grid.origin, grid.upper))
    extent = max(u - o for o, u in zip(grid.origin, grid.upper))
    eye = (center[0] - 1.2 * extent, center[1] - 0.9 * extent,
           center[2] + 0.8 * extent)
    origins, dirs = camera_rays(size, size, eye=eye, target=center,
                                device=args.device)
    with torch.no_grad():
        img = render(phi, grid, origins, dirs, n_steps=256,
                     hit_tol=0.25 * grid.dx, t_max=6.0 * extent)
    write_ppm(args.out, img.image.cpu())
    np.save(os.path.splitext(args.out)[0] + "_depth.npy",
            img.depth.cpu().numpy())
    hit = float(img.hit.float().mean())
    print(f"wrote {args.out} ({size}x{size}); hit fraction {hit:.2f}")
    return hit


if __name__ == "__main__":
    main()
