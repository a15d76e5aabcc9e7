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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_run_f: no CUDA device", file=sys.stderr)
        return 2
    card = cs.start()
    from levelsetfortran_tpu_torch.models import analytic
    from levelsetfortran_tpu_torch.parallel.mesh import make_mesh
    ball = analytic.icosphere_mesh(subdivisions=5)

    def ball_sdf(p):
        return analytic.sdf_sphere(p, (0.0, 0.0, 0.0), 1.0)

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
