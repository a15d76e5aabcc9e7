#!/usr/bin/env python3
"""Runs B and F of ``chip_smoke.py`` alone: the PyTorch port's
domain-decomposed pipeline (``--mesh-shape 2,2,1``) on every visible NVIDIA
card, held against the unsharded run of the same mesh.

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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_run_f: no CUDA device", file=sys.stderr)
        return 2
    card = cs.start()
    from levelsetfortran_tpu_torch.models import analytic
    ball = analytic.icosphere_mesh(subdivisions=5)

    def ball_sdf(p):
        return analytic.sdf_sphere(p, (0.0, 0.0, 0.0), 1.0)

    with tempfile.TemporaryDirectory() as tmp:
        _, res_b = cs.run_phase("B", ball, ball_sdf, 0.01, [], tmp)
        cs.run_f_phase(ball, ball_sdf, res_b, card, tmp)
    print(f"runs B and F passed on {torch.cuda.device_count()} card(s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
