"""K8's block mode, the sharded advection (``advect_run_kernel``, and
``advect_sample_kernel`` where the advection runs across processes).

Work: every node takes every iteration and one final sample, once each,
whatever shard or card computes it: the index, its clamps and floor (21),
four trilinear blends (84), |g|^2 (5), the direction (4) and the move
(10), 124 float operations (K8's count).  Bytes are the nodes and the
corners of their cells, a few hundred kilobytes: they bound nothing.
"""

from __future__ import annotations

from . import bound_s as _bound

KERNELS = ("advect_run_kernel", "advect_sample_kernel")
OPS_PER_NODE_ITER = 124


def ops(nodes: int, iters: int) -> int:
    """The operations of ``iters`` iterations and the final sample of
    ``nodes`` nodes."""
    return OPS_PER_NODE_ITER * nodes * (iters + 1)


def bound_s(nodes: int, iters: int) -> float:
    return _bound(ops=ops(nodes, iters))
