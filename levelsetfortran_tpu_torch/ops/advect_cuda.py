"""Kernel K8 — the surface-node advection — with its plain PyTorch version.

K8 (``csrc/advect.cu``) has no Pallas counterpart.  It replaces the loop
that the JAX package compiles into one device program,
``levelsetfortran_tpu/solvers/advect.py:advect_nodes`` (:46, ``jax.jit``
around a ``lax.fori_loop``).  phi and its banded gradient are frozen while
the nodes move, so each node's path depends on its own position only: one
thread per node runs every iteration and the final sample, in one launch.

What bounds it on the H100 is latency, not bytes or operations: each
iteration gathers 32 floats at the node's cell (L1/L2 hits) and spends
~125 float operations on them, and a node's iterations form one dependent
chain.  The plain loop issues ~40 small ops per iteration from the host.

The kernel evaluates the plain loop's expressions in their order, built
with ``--fmad=false``; ``world_to_index``'s division by dx is a
multiplication by ``float32(1 / dx)``, the reciprocal taken in double and
rounded once, as PyTorch divides a CUDA tensor by a Python number (it
parts from ``float32(1) / float32(dx)`` at dx 0.015, run E's spacing).  So
positions and ``phi_surf`` are bitwise the plain loop's on the card.

:func:`advect` runs the plain loop only for CPU tensors; for CUDA tensors
it launches K8 or raises.  ``solvers.advect.advect_nodes`` takes the
wrapper for float32 and the plain loop for bfloat16 and float64
(``weno_cuda.kernel_supported``).

K8's block mode runs the sharded advection
(``parallel/sharded.py:advect_nodes_sharded``), where phi stays cut into
the blocks of a shard mesh, each block's phi and masked gradient one
4-channel field with a halo of one cell (:class:`BlockSpec` says where it
lies).  A node's sample is computed by the block that owns its base cell,
and the plain loop adds it to the other shards' zeros, so the sum is the
owner's sample with a -0.0 turned into +0.0.  Two entries:

* :func:`sample_block`, one shard's sample at every node (zeros where the
  shard does not own the base cell): bitwise the plain loop's per-shard
  sample, :func:`sample_block_plain`.  The sharded advection across
  processes launches it per shard and iteration and adds the ranks' sums
  with an all-reduce;
* :func:`run_blocks`, every iteration of every node while a block of
  one card holds its base cell (owns it, or holds its corners in the
  halo, copies of the owner's values), on node states (position,
  iterations done, final phi) in place.  :func:`advect_blocks` runs it in
  rounds: one launch per card a round, each node advanced by a card that
  holds it until it finishes or leaves what that card holds, the states
  handed on through the first card.  With every block on one card one
  round does it all; on several, a node changes cards only when it
  crosses a seam between them.  Each iteration is the plain loop's
  arithmetic in its order (:func:`move`), so positions and ``phi_surf``
  are bitwise its.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from .. import cuda_build
from ..grid.grid import Grid3D
from .interp import dot3, sample_surface
from ..utils.profiling import count
from .weno_cuda import kernel_supported, on_device


def advect_plain(phi, grad, grid: Grid3D, positions, iters: int,
                 eps: float, mag_eps: float = 1e-7):
    """The plain version of :func:`advect` (any dtype, any device): the
    loop of ``set3d.f90:482-501``, batched over the nodes."""
    x = positions
    for _ in range(iters):
        p, direction = sample_surface(phi, grad, grid, x, mag_eps=mag_eps)
        move = (p > eps).to(x.dtype)
        x = x + (move * p)[:, None] * direction
    p_final, _ = sample_surface(phi, grad, grid, x, mag_eps=mag_eps)
    return x, p_final


def advect(phi, grad, grid: Grid3D, positions, iters: int, eps: float,
           mag_eps: float = 1e-7):
    """Move the nodes ``positions`` (N, 3) ``iters`` times down ``phi``
    along ``grad`` (its banded gradient, (X, Y, Z, 3)) where their phi is
    above ``eps``: (positions (N, 3), phi at them (N,)).  One K8 launch for
    CUDA tensors (float32 only; anything else raises), the plain loop for
    CPU ones."""
    if phi.device.type == "cpu":
        return advect_plain(phi, grad, grid, positions, iters, eps, mag_eps)
    shape = tuple(phi.shape)
    dev = phi.device
    for name, t, want in (("phi", phi, shape), ("grad", grad, shape + (3,)),
                          ("positions", positions, (positions.shape[0], 3))):
        if (t.dtype != torch.float32 or tuple(t.shape) != want
                or t.device != dev):
            raise ValueError(f"advect: {name} must be a float32 {want} "
                             f"tensor on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if len(shape) != 3 or min(shape) < 2 or grad.numel() >= 2 ** 31:
        raise ValueError(f"advect: unsupported grid shape {shape}")
    if shape != tuple(grid.shape):
        raise ValueError(f"advect: phi {shape} is not on grid {grid.shape}")
    phi, grad, x = phi.contiguous(), grad.contiguous(), positions.contiguous()
    n = x.shape[0]
    out = torch.empty_like(x)
    phi_surf = torch.empty(n, dtype=torch.float32, device=dev)
    f32 = np.float32
    origin = [float(f32(o)) for o in grid.origin]
    with on_device(dev):
        cuda_build.launch(
            "lsf_advect_nodes_f32", phi.data_ptr(), grad.data_ptr(),
            x.data_ptr(), out.data_ptr(), phi_surf.data_ptr(), n, *shape,
            *origin, float(f32(1.0 / grid.dx)), int(iters),
            float(f32(eps)), float(f32(mag_eps)), float(f32(mag_eps * 1e-6)),
            torch.cuda.current_stream(dev).cuda_stream)
    advect.launches += 1
    return out, phi_surf


advect.launches = 0


# ------------------------------- block mode -------------------------------

#: Columns of a node state: x, y, z, iterations done, final phi.
STATE = 5


class BlockSpec(NamedTuple):
    """Where one shard's 4-channel field (phi and its masked gradient,
    ``(X, Y, Z, 4)`` with ``widths`` halo cells on each side of each axis)
    lies in the global grid: it owns the base cells from ``lo`` (its
    block's global origin) up to ``end`` (excluded)."""
    lo: tuple
    end: tuple
    widths: tuple

    @property
    def shift(self) -> tuple:
        """A global index's offset into the padded field."""
        return tuple(w - o for o, w in zip(self.lo, self.widths))


def takes_kernel(field) -> bool:
    """Whether a block's field takes K8's block mode: a float32 field on
    the card (:func:`~.weno_cuda.kernel_supported` of its grid)."""
    return (field.device.type == "cuda"
            and kernel_supported(tuple(field.shape[:3]), field.dtype))


def block_consts(field, spec: BlockSpec, grid: Grid3D, dtype) -> dict:
    """The constants of :func:`sample_block_plain` on ``field``'s device,
    made once per advection."""
    dev = field.device

    def t(v, dt=dtype):
        return torch.tensor(v, dtype=dt, device=dev)

    return dict(origin=t(grid.origin), hi=t([s - 1 for s in grid.shape]),
                max_i0=t([s - 2 for s in grid.shape], torch.long),
                lo=t(spec.lo, torch.long), end=t(spec.end, torch.long),
                shift=t(spec.shift, torch.long),
                li_max=t([s - 2 for s in field.shape[:3]], torch.long))


def sample_block_plain(field, spec: BlockSpec, grid: Grid3D, x,
                       consts: Optional[dict] = None, reach: bool = False):
    """One shard's sample, the plain version of :func:`sample_block` (any
    dtype, any device): ``(N, 4)`` on ``field``'s device, phi and its
    gradient trilinearly sampled at the nodes ``x`` whose base cell ``i0``
    (on the global grid, clamped as :func:`~.interp.trilinear` clamps it)
    the shard owns, zeros at the others.  Off-shard indices are clamped
    into the padded field before the gather, and their samples dropped.
    ``reach``: at the nodes whose base cell the padded field holds
    (:func:`held_by`) instead."""
    c = consts or block_consts(field, spec, grid, x.dtype)
    f = (x.to(field.device) - c["origin"]) / grid.dx
    f = torch.minimum(torch.clamp_min(f, 0.0), c["hi"])
    i0 = torch.minimum(torch.clamp_min(torch.floor(f).long(), 0),
                       c["max_i0"])
    tt = f - i0.to(f.dtype)
    if reach:
        own = ((i0 + c["shift"] >= 0)
               & (i0 + c["shift"] <= c["li_max"])).all(dim=-1)
    else:
        own = ((i0 >= c["lo"]) & (i0 < c["end"])).all(dim=-1)
    li = torch.minimum(torch.clamp_min(i0 + c["shift"], 0), c["li_max"])

    def gather(di, dj, dk):
        return field[li[:, 0] + di, li[:, 1] + dj, li[:, 2] + dk]

    tx, ty, tz = tt[:, 0:1], tt[:, 1:2], tt[:, 2:3]
    c00 = gather(0, 0, 0) * (1 - tx) + gather(1, 0, 0) * tx
    c10 = gather(0, 1, 0) * (1 - tx) + gather(1, 1, 0) * tx
    c01 = gather(0, 0, 1) * (1 - tx) + gather(1, 0, 1) * tx
    c11 = gather(0, 1, 1) * (1 - tx) + gather(1, 1, 1) * tx
    c0 = c00 * (1 - ty) + c10 * ty
    c1 = c01 * (1 - ty) + c11 * ty
    s = c0 * (1 - tz) + c1 * tz
    return torch.where(own[:, None], s, torch.zeros_like(s))


def move(x, s, eps: float, mag_eps: float = 1e-7):
    """One iteration of the loop (``set3d.f90:482-501``) from the nodes'
    samples ``s`` (N, 4): each node moved by its phi along the unit inward
    gradient where its phi is above ``eps``.  ``|g|^2`` is added in
    :func:`~.interp.dot3`'s order, as K8 adds it."""
    p, g = s[:, 0], -s[:, 1:4]
    mag2 = dot3(g, g)[:, None]
    direction = torch.where(
        mag2 < mag_eps, torch.zeros_like(g),
        g / torch.sqrt(torch.clamp_min(mag2, mag_eps * 1e-6)))
    m = (p > eps).to(x.dtype)
    return x + (m * p)[:, None] * direction


def block_table(fields, specs, device) -> torch.Tensor:
    """The kernels' table of blocks: one int64 row per field (contiguous
    float32 ``(X, Y, Z, 4)`` on ``device``): its address, its strides in
    cells, the owned range, the shift and the padded shape - 2
    (``csrc/advect.cu``'s ``ROW``)."""
    rows = []
    for f, sp in zip(fields, specs):
        nx, ny, nz = f.shape[:3]
        rows.append([f.data_ptr(), ny * nz, nz, *sp.lo, *sp.end, *sp.shift,
                     nx - 2, ny - 2, nz - 2])
    return torch.tensor(rows, dtype=torch.int64, device=device)


def _check_blocks(what, fields, grid: Grid3D, *tensors):
    dev = fields[0].device
    for f in fields:
        if (f.dtype != torch.float32 or f.dim() != 4 or f.shape[3] != 4
                or f.device != dev or not f.is_contiguous()):
            raise ValueError(f"{what}: a block field must be a contiguous "
                             f"float32 (X, Y, Z, 4) tensor on {dev}, got "
                             f"{f.dtype} {tuple(f.shape)} on {f.device}")
    for name, t, width in tensors:
        if (t.dtype != torch.float32 or t.dim() != 2 or t.shape[1] != width
                or t.device != dev):
            raise ValueError(f"{what}: {name} must be a float32 (N, "
                             f"{width}) tensor on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if len(grid.shape) != 3 or min(grid.shape) < 2:
        raise ValueError(f"{what}: unsupported grid shape {grid.shape}")


def _grid_args(grid: Grid3D) -> list:
    f32 = np.float32
    return [*(int(s) for s in grid.shape),
            *(float(f32(o)) for o in grid.origin), float(f32(1.0 / grid.dx))]


def sample_block(field, spec: BlockSpec, grid: Grid3D, x,
                 table: Optional[torch.Tensor] = None):
    """One shard's sample at every node (:func:`sample_block_plain`): one
    launch of K8's block mode for a CUDA field (float32 only; anything else
    raises), the plain version for a CPU one.  ``table``:
    :func:`block_table` of ``[field]``, made once by a caller that samples
    often."""
    if field.device.type == "cpu":
        return sample_block_plain(field, spec, grid, x)
    x = x.to(field.device).contiguous()
    _check_blocks("sample_block", [field], grid, ("x", x, 3))
    if table is None:
        table = block_table([field], [spec], field.device)
    n = x.shape[0]
    out = torch.empty((n, 4), dtype=torch.float32, device=field.device)
    with on_device(field.device):
        cuda_build.launch(
            "lsf_advect_block_f32", table.data_ptr(), 1, x.data_ptr(),
            out.data_ptr(), n, *_grid_args(grid),
            torch.cuda.current_stream(field.device).cuda_stream)
    sample_block.launches += 1
    return out


sample_block.launches = 0


def run_blocks_plain(fields, specs, grid: Grid3D, state, iters: int,
                     eps: float, mag_eps: float = 1e-7,
                     zero_sign: bool = True):
    """The plain version of :func:`run_blocks` (any dtype, any device): a
    new state.  Every node whose base cell one of these blocks holds
    (:func:`held_by`; the first that does samples it) takes iterations
    until it has taken ``iters`` and its final sample, or no block holds
    its base cell any more; ``zero_sign``: the mesh has other shards,
    whose zeros turn a sample's -0.0 into +0.0."""
    consts = [block_consts(f, sp, grid, state.dtype)
              for f, sp in zip(fields, specs)]
    x, k, ps = state[:, :3], state[:, 3], state[:, 4]
    live = k <= iters
    while bool(live.any()):
        s, taken = None, None
        for f, sp, c in zip(fields, specs, consts):
            held = held_by(sp, grid, x, f.shape[:3])
            take = held if taken is None else held & ~taken
            sb = sample_block_plain(f, sp, grid, x, c, reach=True)
            sb = torch.where(take[:, None], sb, torch.zeros_like(sb))
            s = sb if s is None else s + sb
            taken = take if taken is None else taken | take
        if zero_sign:
            s = s + 0.0
        live = live & taken
        final = live & (k == iters)
        ps = torch.where(final, s[:, 0], ps)
        stepped = live & (k < iters)
        x = torch.where(stepped[:, None], move(x, s, eps, mag_eps), x)
        k = torch.where(live, k + 1, k)
        live = stepped
    return torch.cat([x, k[:, None], ps[:, None]], dim=1)


def _base_cells(grid: Grid3D, x):
    origin = torch.tensor(grid.origin, dtype=x.dtype, device=x.device)
    hi = torch.tensor([s - 1 for s in grid.shape], dtype=x.dtype,
                      device=x.device)
    max_i0 = torch.tensor([s - 2 for s in grid.shape], device=x.device)
    f = torch.minimum(torch.clamp_min((x - origin) / grid.dx, 0.0), hi)
    return torch.minimum(torch.clamp_min(torch.floor(f).long(), 0), max_i0)


def held_by(spec: BlockSpec, grid: Grid3D, x, padded_shape):
    """Whether the block's padded field (of ``padded_shape``) holds each
    node's base cell and its +1 corners: the cells it owns and, within
    its halo, cells of its neighbours, whose values the halo copies."""
    li = _base_cells(grid, x) + torch.tensor(spec.shift, device=x.device)
    top = torch.tensor([s - 2 for s in padded_shape], device=x.device)
    return ((li >= 0) & (li <= top)).all(dim=-1)


def run_blocks(fields, specs, grid: Grid3D, state, iters: int, eps: float,
               mag_eps: float = 1e-7, zero_sign: bool = True,
               table: Optional[torch.Tensor] = None):
    """Advance the node states ``state`` (N, :data:`STATE`) over the blocks
    ``fields`` of one device (:func:`run_blocks_plain`): one launch of K8's
    block mode for CUDA fields, in place (float32 only; anything else
    raises), the plain version for CPU ones.  Returns the new state."""
    if fields[0].device.type == "cpu":
        return run_blocks_plain(fields, specs, grid, state, iters, eps,
                                mag_eps, zero_sign)
    dev = fields[0].device
    _check_blocks("run_blocks", fields, grid, ("state", state, STATE))
    if not state.is_contiguous():
        raise ValueError("run_blocks: the state must be contiguous")
    if table is None:
        table = block_table(fields, specs, dev)
    f32 = np.float32
    with on_device(dev):
        cuda_build.launch(
            "lsf_advect_blocks_run_f32", table.data_ptr(), len(fields),
            state.data_ptr(), state.shape[0], *_grid_args(grid), int(iters),
            float(f32(eps)), float(f32(mag_eps)), float(f32(mag_eps * 1e-6)),
            int(bool(zero_sign)), torch.cuda.current_stream(dev).cuda_stream)
    run_blocks.launches += 1
    return state


run_blocks.launches = 0


def advect_blocks(fields, specs, grid: Grid3D, positions, iters: int,
                  eps: float, mag_eps: float = 1e-7, *,
                  zero_sign: bool = True,
                  groups: Optional[Sequence[Sequence[int]]] = None):
    """Every node of ``positions`` (N, 3) moved ``iters`` times over the
    blocks ``fields`` of one process (a field per shard, where
    :func:`run_blocks` takes them): ``(positions, phi_surf)`` on
    ``positions``' device.

    In rounds: each round hands the node states to every device's blocks
    (``groups``: lists of shard indices advanced together, by default the
    shards of each device), one :func:`run_blocks` each, and keeps for
    each node the state furthest along.  Whichever group advances a node
    computes the same iterations, bitwise (a block's halo holds copies of
    the owner's values), so the furthest state is the node's.  A round
    advances every unfinished node by at least one iteration (its owner's
    group holds it), and a node stops only where its base cell leaves
    what the group's blocks hold, so one group of every shard finishes in
    one round, and a node that wanders across a seam and back stays with
    the group above the seam."""
    home = positions.device
    if groups is None:
        by = {}
        for i, f in enumerate(fields):
            by.setdefault(f.device, []).append(i)
        groups = list(by.values())
    if sorted(i for g in groups for i in g) != list(range(len(fields))):
        raise ValueError(f"advect_blocks: groups {groups} do not cover "
                         f"the {len(fields)} shards once each")
    cols = torch.zeros((positions.shape[0], STATE - 3),
                       dtype=positions.dtype, device=home)
    state = torch.cat([positions, cols], dim=1).contiguous()
    tables = {}
    for _ in range(iters + 2):
        outs = []
        for n, g in enumerate(groups):
            fs, sps = [fields[i] for i in g], [specs[i] for i in g]
            dev = fs[0].device
            if dev.type == "cuda" and n not in tables:
                tables[n] = block_table(fs, sps, dev)
            outs.append(run_blocks(
                fs, sps, grid, state.to(dev, copy=True), iters, eps,
                mag_eps, zero_sign, table=tables.get(n)).to(home))
        global rounds
        rounds += 1
        count("advect.rounds")
        if len(groups) == 1:
            state = outs[0]
            break
        for out in outs:     # each the same path, some further along
            state = torch.where((out[:, 3] > state[:, 3])[:, None], out,
                                state)
        if not bool((state[:, 3] <= iters).any()):
            break
    else:
        raise RuntimeError("advect_blocks: a node's base cell has no "
                           "owner among the blocks")
    return state[:, :3], state[:, 4]


#: Rounds of :func:`advect_blocks` since the process started.
rounds = 0
