"""Checkpoint / resume of solver state (port of
``levelsetfortran_tpu/utils/checkpoint.py``, whose stage-boundary ``.vti``
dumps descend from ``set3d.f90:336-351,553-569``).

A checkpoint is the field plus a JSON record (iteration counter, stage,
RMS), so a preempted solve resumes instead of restarting.  The JAX package
writes through orbax; here each step is a directory of ``torch.save`` files
and a ``meta.json``:

* one tensor is ``phi.pt``; a sharded field (the port's list of block
  tensors) is ``phi.<i>.pt`` per block, so the field is never gathered;
* a save is written into a temporary directory and renamed into place, so
  a process killed mid-save leaves the previous checkpoint usable;
  ``latest_step`` and ``restore`` see only complete step directories;
* ``restore(like=...)`` loads each block onto the device of ``like``'s
  block, in its dtype; without ``like`` tensors come back on the CPU;
* ``save`` takes tensors or host arrays (:func:`as_tensor`), a bfloat16
  state of the JAX package included: ``np.asarray`` of a JAX bfloat16
  array is an ``ml_dtypes`` array, carried across through its 16-bit
  pattern, so nothing here imports ``ml_dtypes``.

Under a process group (:mod:`..parallel.distributed`; the directory one
that every rank sees) the checkpointer is collective, as orbax is: every
rank calls ``save``, ``latest_step`` and ``restore`` in the same order.
A sharded field's list holds this rank's blocks (None for the others'):
every rank writes its own ``phi.<i>.pt`` into one temporary directory,
and after a barrier the primary (rank 0, "the process that writes
checkpoint metadata" of the JAX package) writes ``meta.json``, renames the
directory into place and prunes; the step list every decision reads is the
primary's, broadcast.  ``restore`` loads only this rank's blocks.  A
single tensor is written by the primary.

The save policy is orbax's: a step is saved when it is newer than the
latest one and is either the first or a multiple of
``save_interval_steps``; after a save, only the ``max_to_keep`` newest
steps are kept.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .process import active, is_primary

_META = "meta.json"


def _is_step(name: str) -> bool:
    return name.isdigit()


def as_tensor(x) -> torch.Tensor:
    """``x`` as a tensor: a tensor as it is, a host array (numpy, or what
    ``np.asarray`` makes of a JAX array) copied bit for bit; a bfloat16
    array through a 16-bit integer view of its bits."""
    if isinstance(x, torch.Tensor):
        return x
    a = np.ascontiguousarray(np.asarray(x))
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


class FieldCheckpointer:
    """{phi, JSON metadata} states in a directory, one subdirectory per step.

    Usage::

        ckpt = FieldCheckpointer("/path/ckpt", max_to_keep=3)
        ckpt.save(step, phi, extra={"rms": 1e-3, "stage": "reinit"})
        step = ckpt.latest_step()          # None if no checkpoint
        state = ckpt.restore(like=phi)     # {"phi", "extra", "step"}
    """

    def __init__(self, directory: str, *, max_to_keep: int = 3,
                 save_interval_steps: int = 1):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        if not os.access(self.directory, os.W_OK):
            raise PermissionError(f"checkpoint directory {self.directory} "
                                  "is not writable")
        self.max_to_keep = int(max_to_keep)
        self.save_interval_steps = int(save_interval_steps)

    def _listed(self) -> list:
        return sorted(int(n) for n in os.listdir(self.directory)
                      if _is_step(n))

    def all_steps(self) -> list:
        """The complete steps, oldest first (under a process group the
        primary's listing, the same on every rank)."""
        steps = [self._listed() if is_primary() else None]
        if active():
            dist.broadcast_object_list(steps, src=0)
        return steps[0]

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, phi, extra: Optional[dict] = None,
             *, wait: bool = False) -> bool:
        """Write ``phi`` (a tensor or a list of block tensors; host arrays
        go through :func:`as_tensor`) and ``extra`` as step ``step``; False
        when the policy skips the step.  Saves are synchronous, so ``wait``
        has nothing to wait for."""
        step = int(step)
        latest = self.latest_step()
        if latest is not None and latest >= step:
            return False
        if latest is not None and self.save_interval_steps \
                and step % self.save_interval_steps:
            return False
        blocks = list(phi) if isinstance(phi, (list, tuple)) else None
        group = active()
        # one directory that every rank writes into (made before the
        # barrier), else one per process
        tmp = os.path.join(self.directory, f".tmp.{step}."
                           + ("group" if group else str(os.getpid())))
        if is_primary():
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
        if group:
            dist.barrier()
        try:
            if blocks is None:
                if is_primary():
                    torch.save(as_tensor(phi).detach().cpu(),
                               os.path.join(tmp, "phi.pt"))
            else:
                for i, b in enumerate(blocks):
                    if b is not None:
                        torch.save(as_tensor(b).detach().cpu(),
                                   os.path.join(tmp, f"phi.{i}.pt"))
            if group:
                dist.barrier()
            if is_primary():
                with open(os.path.join(tmp, _META), "w") as f:
                    json.dump({"extra": dict(extra or {}),
                               "blocks": None if blocks is None
                               else len(blocks)}, f)
                os.replace(tmp, os.path.join(self.directory, str(step)))
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        if is_primary():
            for old in self._listed()[:-self.max_to_keep]:
                shutil.rmtree(os.path.join(self.directory, str(old)))
        if group:
            dist.barrier()
        return True

    def restore(self, step: Optional[int] = None, *, like=None
                ) -> Optional[dict]:
        """Load a checkpoint (default: the latest): ``{"phi", "extra",
        "step"}``, or None when there is none.  With ``like`` (a tensor, or
        a list of blocks for a sharded field) each tensor lands on the
        device and in the dtype of its ``like`` counterpart; a different
        block count or shape raises."""
        if step is None:
            step = self.latest_step()
        if step is None:
            return None
        d = os.path.join(self.directory, str(int(step)))
        with open(os.path.join(d, _META)) as f:
            meta = json.load(f)
        n = meta["blocks"]
        names = ["phi.pt"] if n is None else [f"phi.{i}.pt"
                                              for i in range(n)]
        if like is None:
            targets = [None] * len(names)
        else:
            targets = (list(like) if isinstance(like, (list, tuple))
                       else [like])
            if (n is None) != (not isinstance(like, (list, tuple))) \
                    or len(targets) != len(names):
                raise ValueError(
                    f"checkpoint step {step} holds "
                    f"{'one tensor' if n is None else f'{n} blocks'}; "
                    f"like has {len(targets)}")
        out = []
        for name, t in zip(names, targets):
            if like is not None and t is None:      # another rank's block
                out.append(None)
                continue
            x = torch.load(os.path.join(d, name), weights_only=True,
                           map_location="cpu" if t is None else t.device)
            if t is not None:
                if tuple(x.shape) != tuple(t.shape):
                    raise ValueError(f"checkpoint {name} has shape "
                                     f"{tuple(x.shape)}; like has "
                                     f"{tuple(t.shape)}")
                x = x.to(t.dtype)
            out.append(x)
        return {"phi": out[0] if n is None else out,
                "extra": dict(meta["extra"]), "step": int(step)}

    def wait(self):
        """Saves complete before ``save`` returns: nothing to wait for."""

    def close(self):
        """Nothing is held open between calls."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.wait()
        self.close()


def save_stage_field(path: str, phi, grid=None) -> None:
    """Stage-boundary export for interchange and visualization (the
    reference's ``.vti`` dumps), while :class:`FieldCheckpointer` owns the
    resume state: ``.npy`` without a grid, else ``.vti``."""
    from ..io.vti import write_vti
    t = as_tensor(phi).detach().cpu()
    # numpy has no bfloat16: its values go out as float32, exactly
    host = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    if grid is None:
        np.save(path, host)
    else:
        write_vti(path, host.astype(np.float64), grid)
