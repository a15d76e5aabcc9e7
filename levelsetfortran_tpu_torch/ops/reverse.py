"""Reverse sweeps over fixed-step forward recurrences with bounded
trajectory memory (port of ``weno_pallas.py:2236-2306``: ``_FLAT_TRAJ_BYTES``,
``_segments``, ``checkpointed_reverse``), as Python loops over tensors.

A solve whose trajectory fits in ``_FLAT_TRAJ_BYTES`` stashes every
iterate ("flat"); a larger one keeps only segment-start iterates and
recomputes each segment in reverse order ("sqrtn"), so peak memory is about
``2 sqrt(steps)`` fields at the cost of one extra forward pass.  The
threshold is the JAX package's, so both packages take the same branch.
An iterate is a tensor or, for a sharded solve, the list of a field's
blocks: the branch is then decided per shard, from one block's bytes, as
under ``shard_map``.

:func:`remat_scan` is the other form, for the solver options that have no
kernel: plain tensor steps under autograd, each step checkpointed (the JAX
package's ``jax.checkpoint`` around its scan body).
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

#: Largest trajectory, in bytes, that the backward stashes flat.
_FLAT_TRAJ_BYTES = int(1.5 * 2 ** 30)

#: The branch the last backward of each fixed-step solver took, by solver
#: name: ``"flat"`` or ``"sqrtn"``.
last_branch: dict = {}


def flat_fits(steps: int, item_bytes: int) -> bool:
    return steps * item_bytes <= _FLAT_TRAJ_BYTES


def shard_bytes(p) -> int:
    """Bytes of one iterate on one shard: a tensor's, or the largest block's
    of a list (None, another rank's block, skipped)."""
    if isinstance(p, (list, tuple)):
        return max(shard_bytes(b) for b in p if b is not None)
    return p.numel() * p.element_size()


def run_forward(fstep, p0, steps: int):
    """``steps`` forward steps from ``p0``: ``(p_steps, traj)``, ``traj``
    the stashed input iterates when the flat stash fits, else None."""
    traj = [] if flat_fits(steps, shard_bytes(p0)) else None
    p = p0
    for _ in range(steps):
        if traj is not None:
            traj.append(p)
        p = fstep(p)
    return p, traj


def run_reverse(name, fstep, bstep, p0, carry, steps: int, traj):
    """The reverse sweep after :func:`run_forward`: over ``traj`` when it
    was stashed, else by :func:`checkpointed_reverse`; records the branch
    in ``last_branch[name]``."""
    if traj is not None:
        for p_in in reversed(traj):
            carry = bstep(carry, p_in)
        last_branch[name] = "flat"
        return carry
    last_branch[name] = "sqrtn"
    return checkpointed_reverse(fstep, bstep, p0, carry, steps,
                                shard_bytes(p0))


def _segments(steps: int) -> list:
    """~sqrt(steps) segments of ~sqrt(steps) steps, the remainder last."""
    seg = max(1, math.isqrt(steps))
    if seg * seg < steps:
        seg += 1
    out = [seg] * (steps // seg)
    if steps % seg:
        out.append(steps % seg)
    return out


def _run_segment(fstep, bstep, carry, pstart, n):
    traj = []
    p = pstart
    for _ in range(n):
        traj.append(p)                 # each step's INPUT iterate
        p = fstep(p)
    for p_in in reversed(traj):
        carry = bstep(carry, p_in)
    return carry


def checkpointed_reverse(fstep, bstep, p0, carry0, steps: int,
                         item_bytes: int):
    """Run ``bstep(carry, p_in) -> carry`` over the inputs of ``steps``
    forward steps ``fstep(p) -> p_next`` from ``p0``, last step first.

    Flat when ``steps * item_bytes`` fits the budget; otherwise two-level:
    a snapshot pass keeps each segment's first iterate, then every segment,
    last first, recomputes its iterates and runs ``bstep`` over them."""
    if flat_fits(steps, item_bytes):
        return _run_segment(fstep, bstep, carry0, p0, steps)
    seg_lens = _segments(steps)
    seg = seg_lens[0]
    rem = seg_lens[-1] if seg_lens[-1] != seg else 0
    snaps = []
    p = p0
    for _ in range(len(seg_lens) - (1 if rem else 0)):
        snaps.append(p)
        for _ in range(seg):
            p = fstep(p)
    carry = _run_segment(fstep, bstep, carry0, p, rem) if rem else carry0
    for pstart in reversed(snaps):
        carry = _run_segment(fstep, bstep, carry, pstart, seg)
    return carry


def scalar_meta(x):
    """What :func:`scalar_cotangent` needs of a scalar input: None for a
    Python number, else its dtype, device and shape."""
    return (x.dtype, x.device, x.shape) if isinstance(x, torch.Tensor) \
        else None


def scalar_cotangent(meta, cot):
    """The float64 cotangent ``cot`` in the form of the scalar input that
    :func:`scalar_meta` described (None for a Python number)."""
    if meta is None:
        return None
    dtype, device, shape = meta
    return cot.to(dtype=dtype, device=device).reshape(shape)


def remat_scan(step, p0, steps: int):
    """``steps`` applications of ``step`` (a function of the iterate, its
    other inputs closed over) differentiable by autograd, each step
    checkpointed: the backward keeps one iterate per step and recomputes
    one step's intermediates at a time (``jax.checkpoint`` in the JAX
    package's ``lax.scan`` with ``remat=True``).  Without autograd (no
    grad mode) the steps just run."""
    p = p0
    for _ in range(int(steps)):
        p = (checkpoint(step, p, use_reentrant=False)
             if torch.is_grad_enabled() else step(p))
    return p
