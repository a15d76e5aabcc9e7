#!/usr/bin/env python3
"""Runs B and F of ``chip_smoke.py`` alone: the PyTorch port's
domain-decomposed pipeline (``--mesh-shape 2,2,1``) on every visible NVIDIA
card, held against the unsharded run of the same mesh.  Then the
differentiable sharded solvers of run G (forward and backward, the block
modes of K1/K3/K5/K6) with one block on each card, bitwise against the
solo solvers on the last card, and the fused min/max steps (K4) on every
card, bitwise against the first card's.

A development helper, not the smoke check: it prints no result line.  With
one card all four blocks lie on it; with four cards each takes one block
and the halo copies go card to card.  Run from the repository root:

    python3 tools/torch_run_f.py

With ``--processes`` it runs instead the several-card paths, with one
process per visible card (NCCL; two processes sharing the card over gloo
when there is one card): ``chip_smoke.py``'s runs B and F, then run L
(run F through ``run()`` across the processes, one block per rank on four
cards, also with checkpoints, and the resumable solvers) bitwise run F,
then run G's render in this process (one block per card) and run G-ranks
(the same across the processes) against it; then run F's solver stages on
run F's init (``(2, 2, 1)``, 50 reinit steps dense, with k = 2 and
overlapped, and 50 min/max steps, at run F's h and tol 0) held bitwise
against the same solves in this one process on the same cards, with the
wall per step of each; then run J (two ranks), runs E and K
(``--data-parallel 2``) and ``dryrun(4)``:

    python3 tools/torch_run_f.py --processes
"""

import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def fusedk_every_card(n=222):
    """K4 at 1..4 steps on each visible card, bitwise the first card's."""
    import torch
    from levelsetfortran_tpu_torch.ops import minmax_cuda as mc
    dx = 2.4 / (n - 1)
    phi = cs.sphere((n,) * 3, dx, 1.0)
    ref = [mc.minmax_fusedk(phi, dx, 0.01 * dx * dx, ksteps=k)
           for k in range(1, 5)]
    cards = [f"cuda:{d}" for d in range(torch.cuda.device_count())]
    for dev in cards[1:]:
        p = phi.to(dev)
        for k, r in enumerate(ref, 1):
            got = mc.minmax_fusedk(p, dx, 0.01 * dx * dx, ksteps=k)
            cs.check(torch.equal(got.to(r.device), r),
                     f"K4 ({k} steps) on {dev} differs from {cards[0]}")
    cs.phase("K4", f"1..4 fused steps at {(n,) * 3} on {cards}: bitwise "
             f"equal on every card")


#: The solver stages of run F at fixed counts, one process per card.
PROCESS_STEPS = 50


def ball_sdf(p):
    from levelsetfortran_tpu_torch.models import analytic
    return analytic.sdf_sphere(p, (0.0, 0.0, 0.0), 1.0)


def pipeline_processes(card):
    """Runs B, F and L, then run G (one process) and G-ranks, with one
    rank per visible card (at least two)."""
    import torch
    from levelsetfortran_tpu_torch.models import analytic
    from levelsetfortran_tpu_torch.parallel.mesh import make_mesh
    world = max(2, torch.cuda.device_count())
    ball = analytic.icosphere_mesh(subdivisions=5)
    with tempfile.TemporaryDirectory() as tmp:
        _, res_b = cs.run_phase("B", ball, ball_sdf, 0.01, [], tmp)
        _, run_f = cs.run_f_phase(ball, ball_sdf, res_b, card, tmp)
        cs.run_l_phase(card, tmp, run_f, world=world)
    run_g = cs.render_run(ball, cs.cube_grid(ball.vertices, 256),
                          cs.RUN_D_KW, make_mesh((2, 2, 1)))
    cs.phase("run G", f"one process, (2, 2, 1) over "
             f"{torch.cuda.device_count()} card(s): loss {run_g['loss']!r},"
             f" wall {run_g['wall']:.3f} s, peak {run_g['peak']:.2f} GiB "
             f"(the current card); card {card}")
    with tempfile.TemporaryDirectory() as tmp:
        cs.run_g_ranks_phase(card, tmp, dict(run_g, kw=cs.RUN_D_KW),
                             world=world)


def processes(card, device="cuda", dx=0.01, subdivisions=5, world=None):
    """Run F's solver stages across processes (``world``: one per visible
    card, at least 2) against one process."""
    import torch
    from levelsetfortran_tpu_torch import LevelSetConfig
    from levelsetfortran_tpu_torch.grid import grid as gridmod
    from levelsetfortran_tpu_torch.models import analytic
    from levelsetfortran_tpu_torch.ops.init_sign import \
        signed_distance_init_sharded
    from levelsetfortran_tpu_torch.parallel.mesh import (gather_blocks,
                                                         make_mesh)
    ball = analytic.icosphere_mesh(subdivisions=subdivisions)
    cfg = LevelSetConfig(dx=dx, device=device)
    mesh = make_mesh((2, 2, 1), None if device == "cuda" else [device])
    grid = gridmod.from_surface(ball.vertices, dx, cfg.pad_cells, mesh.shape)
    phi = gather_blocks(mesh, signed_distance_init_sharded(
        grid, ball.vertices, ball.elements, mesh, dtype=cfg.dtype,
        cull_block=cfg.init_cull_block), "cpu")
    diag = gridmod.surface_diag(ball.vertices)
    h, h1 = cfg.reinit_cfl * dx / diag, cfg.minmax_cfl * dx / diag
    n = PROCESS_STEPS
    cards = torch.cuda.device_count() if device == "cuda" else 0
    world = world or max(2, cards)
    backend = cs.rank_backend(world, device)
    with tempfile.TemporaryDirectory() as tmp:
        field = os.path.join(tmp, "F_field.pt")
        torch.save(phi, field)
        spec = {"device": device, "field": field, "dx": dx,
                "meshes": [[2, 2, 1]],
                "cases": [["reinit dense", "reinit", {}, n, h],
                          ["reinit k=2", "reinit",
                           {"steps_per_exchange": 2}, n, h],
                          ["reinit overlap", "reinit", {"overlap": True}, n,
                           h],
                          ["minmax dense", "minmax", {}, n, h1]]}
        cs.phase("run F processes", f"{world} ranks over {backend} on "
                 f"{grid.shape}, {cards} card(s) visible")
        ranks = cs.run_ranks(spec, world, backend, tmp, "F")
        launches = cs.ranks_against_one("run F processes", spec,
                                        phi.to(device), ranks, card)
    print(f"run F's solver stages on {world} processes passed, launches "
          f"{launches}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_run_f: no CUDA device", file=sys.stderr)
        return 2
    card = cs.start()
    if sys.argv[1:] == ["--processes"]:
        pipeline_processes(card)
        processes(card)
        with tempfile.TemporaryDirectory() as tmp:
            cs.run_j_phase(card, tmp)
            _, items, walls = cs.run_e_phase(card, tmp)
            cs.run_k_phase(card, tmp, (items, walls))
        cs.dryrun_phase(card)
        print(f"the several-card paths passed on "
              f"{torch.cuda.device_count()} card(s)")
        return 0
    from levelsetfortran_tpu_torch.models import analytic
    from levelsetfortran_tpu_torch.parallel.mesh import make_mesh
    ball = analytic.icosphere_mesh(subdivisions=5)
    with tempfile.TemporaryDirectory() as tmp:
        _, res_b = cs.run_phase("B", ball, ball_sdf, 0.01, [], tmp)
        cs.run_f_phase(ball, ball_sdf, res_b, card, tmp)
    # run D's grid and steps, a sphere for its init
    n = 256
    dx = 2.4 / (n - 1)
    last = f"cuda:{torch.cuda.device_count() - 1}"
    cs.sharded_solvers_holds(make_mesh((2, 2, 1)),
                             cs.sphere((n,) * 3, dx, 1.0).to(last), dx,
                             (50, 20), "a sphere", card)
    fusedk_every_card()
    print(f"runs B, F and the sharded solvers passed on "
          f"{torch.cuda.device_count()} card(s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
