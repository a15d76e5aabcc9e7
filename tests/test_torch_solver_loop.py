"""The accounting of every solver loop of the port: how many steps a solve
runs, where it stops, and what it returns.

The six loops (dense and banded reinit, dense and banded min/max flow, the
sharded reinit and min/max on (2,1,1) blocks) advance in units: one step
dense, a chunk banded (9 reinit steps, 20 min/max steps here), k steps for
the sharded reinit, one step for the sharded min/max.  Three cases each:

* a NaN at an in-band cell stops the solve at its first check, with
  ``diverged`` set and one unit of steps counted;
* an ``iters`` that is not a multiple of the unit: the banded reinit
  rounds up to whole chunks, the banded min/max ends exactly at ``iters``
  through its single-step tail (its field the dense solve's, bitwise),
  the sharded reinit rounds up to a multiple of k;
* ``iters = 0``: no step, the input field, RMS inf, not diverged.
"""

import math

import numpy as np
import pytest
import torch

from levelsetfortran_tpu_torch.parallel import sharded as sh
from levelsetfortran_tpu_torch.parallel.mesh import make_mesh
from levelsetfortran_tpu_torch.solvers.minmax_flow import (
    minmax_flow, minmax_flow_narrowband)
from levelsetfortran_tpu_torch.solvers.reinit import (reinit,
                                                      reinit_narrowband)

torch.set_num_threads(1)
SHAPE, DX = (32, 32, 16), 2.4 / 31
H, H1 = 0.1 * DX, 0.05 * DX * DX
K = 2      # the sharded reinit's steps per exchange


def _sphere():
    xs = [np.linspace(-1.2, 1.2, k) for k in SHAPE]
    gx, gy, gz = np.meshgrid(*xs, indexing="ij")
    return torch.tensor((1.2 * (np.sqrt(gx ** 2 + gy ** 2 + gz ** 2)
                                - 0.6)).astype(np.float32))


def _sharded(method, step):
    def solve(phi, iters):
        s = sh.ShardedLevelSet(make_mesh((2, 1, 1), ["cpu"]), SHAPE, DX,
                               steps_per_exchange=K)
        blocks, n, rms = getattr(s, method)(s.device_put(phi), step, iters,
                                            0.0)
        return s.gather(blocks), n, rms, math.isnan(rms)
    return solve


#: name -> (solve(phi, iters) -> (phi, n, rms, diverged), the loop's unit,
#: an iters that is not a multiple of it, the count the solve ends at)
LOOPS = {
    "reinit": (lambda p, it: reinit(p, DX, H, it, 0.0), 1, 7, 7),
    "reinit_narrowband": (lambda p, it: reinit_narrowband(p, DX, H, it, 0.0),
                          9, 10, 18),
    "minmax_flow": (lambda p, it: minmax_flow(p, DX, H1, it, 0.0), 1, 7, 7),
    "minmax_flow_narrowband": (
        lambda p, it: minmax_flow_narrowband(p, DX, H1, it, 0.0), 20, 45,
        45),
    "sharded.reinit": (_sharded("reinit", H), K, 7, 8),
    "sharded.minmax_flow": (_sharded("minmax_flow", H1), 1, 7, 7),
}


@pytest.mark.parametrize("case", ["nan", "not_a_multiple", "zero"])
@pytest.mark.parametrize("loop", sorted(LOOPS))
def test_solver_loop_accounting(loop, case):
    solve, unit, iters, ends_at = LOOPS[loop]
    phi = _sphere()
    if case == "nan":
        cell = torch.argmin(phi.abs()).item()
        phi.view(-1)[cell] = float("nan")
        out, n, rms, diverged = solve(phi, 60)
        assert (n, diverged) == (unit, True) and math.isnan(rms)
    elif case == "not_a_multiple":
        assert iters % unit or unit == 1
        out, n, rms, diverged = solve(phi, iters)
        assert n == ends_at and not diverged and 0 < rms < math.inf
        assert not torch.equal(out, phi)
        if loop == "minmax_flow_narrowband":
            assert torch.equal(out, minmax_flow(phi, DX, H1, iters, 0.0).phi)
    else:
        out, n, rms, diverged = solve(phi, 0)
        assert (n, rms, diverged) == (0, math.inf, False)
        assert torch.equal(out, phi)
