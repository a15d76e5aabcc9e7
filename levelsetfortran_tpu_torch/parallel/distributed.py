"""Several processes, one per card (port of
``levelsetfortran_tpu/parallel/distributed.py``).

The JAX package calls ``jax.distributed.initialize`` once per host process;
afterwards its device list spans every process and a mesh shards a grid
across them.  Here :func:`init_distributed` forms a ``torch.distributed``
process group instead: NCCL between cards, gloo for the CPU (and for two
processes that share one card, which NCCL refuses).  A shard mesh made
under the group (:func:`..mesh.make_mesh`) gives every shard an owner rank;
each process holds and steps its own shards, and the halo exchange
(:mod:`.halo`) sends face slabs between the processes.

Departure: a group that was configured and fails to form raises, where the
JAX package falls back to one process.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ..utils.process import active, is_primary  # noqa: F401  (re-exported)

#: How long a collective or a point-to-point exchange may wait for a peer.
TIMEOUT = datetime.timedelta(seconds=300)


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *,
                     backend: Optional[str] = None,
                     device="cuda") -> bool:
    """Idempotent ``torch.distributed.init_process_group``.

    The group forms at ``tcp://<coordinator_address>`` with
    ``num_processes`` and ``process_id``, or from torchrun's environment
    (``MASTER_ADDR``, ``WORLD_SIZE``, ``RANK``) through ``env://``.  With
    neither this is one process and returns False, as the JAX package does;
    otherwise it returns whether the group has more than one process.

    ``backend`` None means NCCL when ``device`` is a CUDA device and gloo
    for the CPU.  On CUDA each rank binds its own card (``LOCAL_RANK``, or
    its rank modulo the visible cards) and makes it current, so ``"cuda"``
    names that card; under NCCL one collective runs at once, so that the
    communicator exists before the first point-to-point exchange."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = all(k in os.environ for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK"))
    if coordinator_address is None and not env:
        if (num_processes or 1) > 1 or process_id is not None:
            raise ValueError("init_distributed: num_processes / process_id "
                             "need a coordinator_address (or torchrun's "
                             "MASTER_ADDR, WORLD_SIZE and RANK)")
        return False
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("init_distributed: a coordinator_address needs "
                             "num_processes and process_id")
        init_method = f"tcp://{coordinator_address}"
        world, me = int(num_processes), int(process_id)
    else:
        init_method = "env://"
        world, me = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    dev = torch.device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    kw = {}
    card = None
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", me))
        card = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(card)
        if backend == "nccl":
            kw["device_id"] = card
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=me, timeout=TIMEOUT, **kw)
    if backend == "nccl":
        one = torch.ones(1, device=card)
        dist.all_reduce(one)
        torch.cuda.synchronize(card)
    return world > 1


def comm_device(t: torch.Tensor) -> torch.device:
    """Where a buffer for exchanging ``t`` with another process lives: the
    host for a card's tensor under gloo, which moves CPU tensors only, else
    ``t``'s device."""
    if t.device.type == "cuda" and dist.get_backend() == "gloo":
        return torch.device("cpu")
    return t.device


def shard_order_sum(parts: Sequence[Optional[torch.Tensor]],
                    owners: Optional[Sequence[int]] = None) -> float:
    """The sum of one scalar per shard (0-d tensors in shard order, None
    for a shard of another process), added on the host in float64 in shard
    order, so that it is the same number whatever the processes: one host
    read.  ``owners`` (rank per shard) when the shards span processes: the
    values are all-gathered, and every rank adds the same list, so all
    ranks take the same stop decision.  (An all-reduce would add in the
    backend's order.)"""
    if owners is None:
        dev = parts[0].device
        vals = torch.stack([p.to(dev) for p in parts]).tolist()
    else:
        mine = [p for p in parts if p is not None]
        dev = comm_device(mine[0])
        local = torch.zeros(len(parts), dtype=torch.float64, device=dev)
        for i, p in enumerate(parts):
            if p is not None:
                local[i] = p.to(dev, torch.float64)
        rows = [torch.empty_like(local)
                for _ in range(dist.get_world_size())]
        dist.all_gather(rows, local)
        table = torch.stack(rows).tolist()
        vals = [table[o][i] for i, o in enumerate(owners)]
    total = 0.0
    for v in vals:
        total += v
    return total
