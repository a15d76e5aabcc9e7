"""K5, the reinitialization step's adjoint (``reinit_bwd_cells``,
``reinit_bwd_axis``, ``reinit_bwd_ztile`` and the sums' reduction that
follows them).

Work per call: every cell of the grid evaluated once through the forward
step and its hand-chained adjoint, ~1600 float operations (the forward's
452 and the adjoint's terms), counted by hand from the step's algorithm.
A call is one ``reinit_bwd_cells`` launch.
"""

from __future__ import annotations

from . import bound_s as _bound

KERNELS = ("reinit_bwd_cells", "reinit_bwd_axis", "reinit_bwd_ztile")
FIRST = "reinit_bwd_cells"
OPS_PER_CELL = 1600


def bound_s(calls: int, cells: int) -> float:
    return _bound(ops=OPS_PER_CELL * cells * calls)
