"""Command line: ``python -m levelsetfortran_tpu_torch <mesh.stl>``.

Flags for every field of the port's config (the JAX package's CLI, less
the sharding, checkpoint, batch and init-mode flags the port lacks).
"""

from __future__ import annotations

import argparse

import torch

from ..config import LevelSetConfig, QuirkConfig
from ..utils.logging import configure
from .run import run


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="levelsetfortran_tpu_torch",
        description="Level-set pipeline on PyTorch/CUDA: STL -> SDF -> "
                    "smoothing -> advected surface (.vti/.s3d outputs)")
    d = LevelSetConfig()
    p.add_argument("mesh", help="input .stl (binary or ascii) or .s3d file")
    p.add_argument("--dx", type=float, default=d.dx)
    p.add_argument("--pad-cells", type=int, default=d.pad_cells)
    p.add_argument("--init-culling", choices=["auto", "off"],
                   default=d.init_culling,
                   help="per-block candidate triangle culling of the init")
    p.add_argument("--init-cull-block", type=int, default=d.init_cull_block,
                   help="grid points per side of a culling block")
    p.add_argument("--reinit-iters", type=int, default=d.reinit_iters)
    p.add_argument("--reinit-cfl", type=float, default=d.reinit_cfl)
    p.add_argument("--reinit-tol", type=float, default=d.reinit_tol,
                   help="RMS convergence tolerance (subs.f90:915)")
    p.add_argument("--minmax-iters", type=int, default=d.minmax_iters,
                   help="set 0 to run only the signed-distance part")
    p.add_argument("--minmax-cfl", type=float, default=d.minmax_cfl)
    p.add_argument("--minmax-tol", type=float, default=d.minmax_tol,
                   help="RMS steady-state tolerance (set3d.f90:448)")
    p.add_argument("--minmax-threshold", type=float,
                   default=d.minmax_threshold,
                   help="min/max switch threshold (subs.f90:471)")
    p.add_argument("--minmax-avg-halfwidth", type=int,
                   default=d.minmax_avg_halfwidth,
                   help="halfwidth of the min/max switch average")
    p.add_argument("--band-radius", type=float, default=d.band_radius,
                   help="active narrow band, units of dx (subs.f90:194)")
    p.add_argument("--stencil-band-radius", type=float,
                   default=d.stencil_band_radius,
                   help="stencil band, units of dx (subs.f90:199)")
    p.add_argument("--advect-iters", type=int, default=d.advect_iters)
    p.add_argument("--advect-grad-order", type=int,
                   default=d.advect_grad_order, choices=[1, 2, 4, 6, 8])
    p.add_argument("--advect-eps", type=float, default=d.advect_eps)
    p.add_argument("--final-reinit-iters", type=int,
                   default=d.final_reinit_iters)
    p.add_argument("--final-reinit-cfl", type=float,
                   default=d.final_reinit_cfl)
    p.add_argument("--weno-eps-scale", type=float, default=d.weno_eps_scale)
    p.add_argument("--weno-eps-floor", type=float, default=d.weno_eps_floor)
    p.add_argument("--narrow-band", choices=["auto", "on", "off"],
                   default=d.narrow_band,
                   help="narrow-band solvers (brick skipping): auto/on, or "
                        "off for the dense solvers")
    p.add_argument("--nb-refresh-every", type=int, default=d.nb_refresh_every)
    p.add_argument("--minmax-nb-refresh-every", type=int,
                   default=d.minmax_nb_refresh_every)
    p.add_argument("--quirks", default="",
                   help="comma-separated reference-as-written quirk flags "
                        "(weno_y_p5_zero,deriv8_y_jp1,deriv1_plus_sign) "
                        "or 'all'")
    p.add_argument("--dtype", choices=["float32", "float64"],
                   default="float32",
                   help="float64 runs on the CPU only (no kernel takes it)")
    p.add_argument("--device", default=d.device,
                   help="'auto' (CUDA when present), 'cuda', 'cpu', ...")
    p.add_argument("--out-dir", default=None)
    p.add_argument("--no-outputs", action="store_true")
    return p


def config_from_args(args) -> LevelSetConfig:
    qnames = [q for q in args.quirks.split(",") if q]
    if qnames == ["all"]:
        qnames = list(QuirkConfig.__dataclass_fields__)
    for q in qnames:
        if q not in QuirkConfig.__dataclass_fields__:
            raise SystemExit(f"unknown quirk {q!r}; known: "
                             f"{', '.join(QuirkConfig.__dataclass_fields__)}")
    return LevelSetConfig(
        dx=args.dx, pad_cells=args.pad_cells,
        init_culling=args.init_culling, init_cull_block=args.init_cull_block,
        reinit_iters=args.reinit_iters, reinit_cfl=args.reinit_cfl,
        reinit_tol=args.reinit_tol, minmax_iters=args.minmax_iters,
        minmax_cfl=args.minmax_cfl, minmax_tol=args.minmax_tol,
        minmax_threshold=args.minmax_threshold,
        minmax_avg_halfwidth=args.minmax_avg_halfwidth,
        band_radius=args.band_radius,
        stencil_band_radius=args.stencil_band_radius,
        advect_iters=args.advect_iters,
        advect_grad_order=args.advect_grad_order, advect_eps=args.advect_eps,
        final_reinit_iters=args.final_reinit_iters,
        final_reinit_cfl=args.final_reinit_cfl,
        weno_eps_scale=args.weno_eps_scale,
        weno_eps_floor=args.weno_eps_floor, narrow_band=args.narrow_band,
        nb_refresh_every=args.nb_refresh_every,
        minmax_nb_refresh_every=args.minmax_nb_refresh_every,
        dtype={"float32": torch.float32, "float64": torch.float64}[args.dtype],
        device=args.device,
        quirks=QuirkConfig(**{q: True for q in qnames}))


def main(argv=None) -> int:
    configure()
    args = build_parser().parse_args(argv)
    result = run(args.mesh, config_from_args(args), out_dir=args.out_dir,
                 write_outputs=not args.no_outputs)
    print(f"grid={result.grid.shape} reinit_iters={result.reinit_iters} "
          f"minmax_iters={result.minmax_iters} "
          f"asymptotic_error={result.asymptotic_error:.3e}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
