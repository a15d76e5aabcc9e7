"""Which process this is under a ``torch.distributed`` process group (the
group itself is formed by :func:`..parallel.distributed.init_distributed`).
Kept apart from :mod:`..parallel` so that logging and the metrics stream
ask the rank without loading the sharded solvers."""

from __future__ import annotations

import torch.distributed as dist


def active() -> bool:
    """A process group of more than one process is formed."""
    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1)


def is_primary() -> bool:
    """True on the process that logs and writes outputs: rank 0, or the only
    process when there is no group."""
    return not active() or dist.get_rank() == 0
