"""K8's block mode (``ops/advect_cuda.py``: ``sample_block``,
``run_blocks``, ``advect_blocks``) and the decomposed path's spans and
counters, on the CPU.

The block mode's plain versions are held bitwise against the sharded
advection's loop as it stood before the block mode (a frozen copy below:
one sample per shard, the shards' samples added in shard order, the move
with ``torch.sum``), on (2,2,1), (4,1,1) and (2,2,2) meshes, with nodes on
the seams, on the grid's outer faces and off the grid; the rounds of
``advect_blocks`` with one group of blocks and with one group per shard
(nodes handed from shard to shard across a seam); the sign of a zero sample
(the owner's -0.0 plus the other shards' +0.0).  Then the route (float32 on
the card to the kernels, the CPU, bfloat16 and float64 to the plain loop),
and the spans and counters a sharded ``run_mesh`` leaves under a profiler
session.  The kernels themselves run on the card only (``chip_smoke.py``'s
K8 block phase holds them bitwise against these plain versions there).
No tolerance: every comparison is bitwise, sign of zero included.
"""

import numpy as np
import pytest
import torch

from levelsetfortran_tpu_torch import run_mesh
from levelsetfortran_tpu_torch.config import LevelSetConfig
from levelsetfortran_tpu_torch.grid.grid import Grid3D
from levelsetfortran_tpu_torch.models import analytic
from levelsetfortran_tpu_torch.ops import advect_cuda
from levelsetfortran_tpu_torch.ops.weno_cuda import kernel_supported
from levelsetfortran_tpu_torch.parallel import halo
from levelsetfortran_tpu_torch.parallel import sharded as sh
from levelsetfortran_tpu_torch.parallel.mesh import make_mesh, split_blocks
from levelsetfortran_tpu_torch.utils import profiling

torch.set_num_threads(1)
#: A grid whose seams and faces lie on exact binary coordinates.
GSHAPE, DX, ORIGIN = (32, 24, 16), 0.0625, (-1.0, -0.75, -0.5)
GRID = Grid3D(shape=GSHAPE, origin=ORIGIN, dx=DX)
MESHES = [(2, 2, 1), (4, 1, 1), (2, 2, 2)]
ITERS = 30


def _field(kind="sphere"):
    axes = [o + DX * np.arange(n) for o, n in zip(ORIGIN, GSHAPE)]
    x, y, z = np.meshgrid(*axes, indexing="ij")
    if kind == "plane":                     # the plane x = -0.1
        return (x + 0.1).astype(np.float32)
    return (np.sqrt((x - 0.03) ** 2 + y ** 2 + (z + 0.02) ** 2)
            - 0.4).astype(np.float32)


def _nodes():
    """Nodes off the sphere, on every mesh's seams (x = -0.5, 0, 0.5; y =
    0; z = 0), on the outer faces and beyond them."""
    rng = np.random.default_rng(5)
    d = rng.normal(size=(60, 3))
    pts = 0.46 * d / np.linalg.norm(d, axis=1, keepdims=True)
    seams = [(0.0, 0.2, 0.3), (0.0, 0.0, 0.45), (0.3, 0.0, -0.3),
             (-0.5, 0.0, 0.0), (0.5, 0.0, 0.0), (0.0, -0.45, 0.0),
             (0.2, 0.3, 0.0)]
    faces = [(-1.0, 0.0, 0.0), (ORIGIN[0] + DX * (GSHAPE[0] - 1), 0.1, 0.0),
             (0.0, -0.75, 0.1), (0.0, 0.0, ORIGIN[2] + DX * (GSHAPE[2] - 1)),
             (3.0, -3.0, 0.1)]
    return np.concatenate([pts, seams, faces]).astype(np.float32)


def _bits(t):
    return t.contiguous().view(torch.int32 if t.dtype == torch.float32
                               else torch.int64)


def _same(a, b):
    return a.shape == b.shape and torch.equal(_bits(a), _bits(b))


def _consts_before(field, sp, grid, dtype):
    """The per-shard constants of the loop before the block mode."""
    def t(v, dt=dtype):
        return torch.tensor(v, dtype=dt, device=field.device)
    return dict(
        origin=t(grid.origin), hi=t([s - 1 for s in grid.shape]),
        max_i0=t([s - 2 for s in grid.shape], torch.long),
        lo=t(sp.lo, torch.long), end=t(sp.end, torch.long),
        shift=t([w - o for o, w in zip(sp.lo, sp.widths)], torch.long),
        li_max=t([s - 2 for s in field.shape[:3]], torch.long))


def _sample_before(field, c, grid, x):
    """One shard's sample in the loop before the block mode."""
    f = (x.to(field.device) - c["origin"]) / grid.dx
    f = torch.minimum(torch.clamp_min(f, 0.0), c["hi"])
    i0 = torch.minimum(torch.clamp_min(torch.floor(f).long(), 0),
                       c["max_i0"])
    tt = f - i0.to(f.dtype)
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


def _loop_before(mesh, blocks, grid, positions, iters, eps=1e-13):
    """The sharded advection's loop before the block mode: the per-shard
    sample, the shard-order sum and the move (``torch.sum``) of
    ``parallel/sharded.py`` as they stood, on fields made the same way."""
    fields, specs = _fields(mesh, blocks)
    home = positions.device
    consts = [_consts_before(f, sp, grid, positions.dtype)
              for f, sp in zip(fields, specs)]

    def sample(x):
        total = None
        for field, c in zip(fields, consts):
            s = _sample_before(field, c, grid, x).to(home)
            total = s if total is None else total + s
        return total

    mag_eps = 1e-7
    x = positions
    for _ in range(iters):
        s = sample(x)
        p, g = s[:, 0], -s[:, 1:4]
        mag2 = torch.sum(g * g, dim=-1, keepdim=True)
        direction = torch.where(
            mag2 < mag_eps, torch.zeros_like(g),
            g / torch.sqrt(torch.clamp_min(mag2, mag_eps * 1e-6)))
        move = (p > eps).to(x.dtype)
        x = x + (move * p)[:, None] * direction
    return x, sample(x)[:, 0]


def _fields(mesh, blocks):
    """Each shard's 4-channel field and spec (``order`` 8, radius 8.1)."""
    return sh.advection_fields(mesh, blocks, DX)


def _case(mesh_shape, kind="sphere"):
    mesh = make_mesh(mesh_shape, ["cpu"])
    blocks = split_blocks(mesh, torch.from_numpy(_field(kind)))
    return mesh, blocks, torch.from_numpy(_nodes())


@pytest.mark.parametrize("mesh_shape", MESHES, ids=str)
def test_sample_block_plain_is_the_loops_sample(mesh_shape):
    """Per shard, the block mode's plain sample is the old loop's, and
    the nodes on seams have exactly one owner."""
    mesh, blocks, x = _case(mesh_shape)
    fields, specs = _fields(mesh, blocks)
    owners = torch.zeros(x.shape[0], dtype=torch.long)
    for f, sp in zip(fields, specs):
        want = _sample_before(f, _consts_before(f, sp, GRID, x.dtype), GRID,
                              x)
        assert _same(advect_cuda.sample_block_plain(f, sp, GRID, x), want)
        assert _same(advect_cuda.sample_block(f, sp, GRID, x), want)
        c = _consts_before(f, sp, GRID, x.dtype)
        i0 = torch.floor(torch.minimum(torch.clamp_min(
            (x - c["origin"]) / DX, 0.0), c["hi"])).long()
        i0 = torch.minimum(i0, c["max_i0"])
        owners += ((i0 >= c["lo"]) & (i0 < c["end"])).all(dim=-1).long()
    assert owners.eq(1).all()


@pytest.mark.parametrize("mesh_shape", MESHES, ids=str)
def test_sharded_loop_bitwise_as_before(mesh_shape):
    mesh, blocks, x = _case(mesh_shape)
    want = _loop_before(mesh, blocks, GRID, x, ITERS)
    got = sh.advect_nodes_sharded(mesh, blocks, GRID, x, DX, iters=ITERS)
    assert _same(got.positions, want[0]) and _same(got.phi_surf, want[1])
    assert float((want[0] - x)[:60].abs().max()) > 1e-3   # the nodes moved


@pytest.mark.parametrize("per_shard", [False, True],
                         ids=["one group", "a group per shard"])
@pytest.mark.parametrize("mesh_shape", MESHES, ids=str)
def test_advect_blocks_bitwise_the_loop(mesh_shape, per_shard):
    """The rounds of ``run_blocks`` (its plain version) against the old
    loop: one group finishes in one round, a group per shard hands the
    nodes on."""
    mesh, blocks, x = _case(mesh_shape)
    want = _loop_before(mesh, blocks, GRID, x, ITERS)
    fields, specs = _fields(mesh, blocks)
    groups = [[i] for i in range(len(fields))] if per_shard else None
    before = advect_cuda.rounds
    pos, phi = advect_cuda.advect_blocks(fields, specs, GRID, x, ITERS,
                                         1e-13, groups=groups)
    assert _same(pos, want[0]) and _same(phi, want[1])
    rounds = advect_cuda.rounds - before
    assert rounds == 1 if not per_shard else rounds >= 1


def test_nodes_cross_a_seam_between_groups():
    """Nodes pulled across the x seam of (2, 1, 1) onto the plane x = -0.1:
    the shard that owned them gives them up mid-run, the next round's
    owner finishes them, bitwise the loop."""
    mesh, blocks, _ = _case((2, 1, 1), "plane")
    x = torch.tensor([[0.05, 0.1, 0.0], [0.2, -0.3, 0.1],
                      [-0.3, 0.0, 0.05], [0.01, 0.0, 0.0]])
    want = _loop_before(mesh, blocks, GRID, x, ITERS)
    assert (want[0][:, 0] < 0.0).all() and (x[[0, 1, 3], 0] > 0.0).all()
    fields, specs = _fields(mesh, blocks)
    before = advect_cuda.rounds
    got = advect_cuda.advect_blocks(fields, specs, GRID, x, ITERS, 1e-13,
                                    groups=[[0], [1]])
    assert advect_cuda.rounds - before >= 2
    assert _same(got[0], want[0]) and _same(got[1], want[1])


@pytest.mark.parametrize("mesh_shape,sign", [((2, 2, 1), 0), ((1, 1, 1), 1)],
                         ids=["(2, 2, 1)", "(1, 1, 1)"])
def test_sign_of_a_zero_sample(mesh_shape, sign):
    """A field of -0.0: the loop adds the owner's -0.0 to the other
    shards' +0.0 (+0.0); a mesh of one shard keeps -0.0.  The block mode
    follows both."""
    mesh = make_mesh(mesh_shape, ["cpu"])
    blocks = split_blocks(mesh, torch.full(GSHAPE, -0.0))
    x = torch.from_numpy(_nodes())
    want = _loop_before(mesh, blocks, GRID, x, 3)
    assert bool((torch.signbit(want[1]) == bool(sign)).all())
    fields, specs = _fields(mesh, blocks)
    got = advect_cuda.advect_blocks(fields, specs, GRID, x, 3, 1e-13,
                                    zero_sign=mesh.n_shards > 1)
    assert _same(got[0], want[0]) and _same(got[1], want[1])
    got = sh.advect_nodes_sharded(mesh, blocks, GRID, x, DX, iters=3)
    assert _same(got.phi_surf, want[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
@pytest.mark.parametrize("on_card", [False, True], ids=["cpu", "card"])
def test_route(dtype, on_card, monkeypatch):
    """float32 blocks on the card take the block mode (``advect_blocks``
    in one process); the CPU, bfloat16 and float64 the plain loop.  "card":
    the device test stubbed to pass CPU blocks, which then run the kernels'
    plain versions."""
    if on_card:
        monkeypatch.setattr(advect_cuda, "takes_kernel", lambda f: (
            kernel_supported(tuple(f.shape[:3]), f.dtype)))
    calls = {"advect_blocks": 0, "sample_block_plain": 0}
    for name in calls:
        real = getattr(advect_cuda, name)

        def spy(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)

        monkeypatch.setattr(advect_cuda, name, spy)
    mesh = make_mesh((2, 2, 1), ["cpu"])
    blocks = split_blocks(mesh, torch.from_numpy(_field()).to(dtype))
    res = sh.advect_nodes_sharded(mesh, blocks, GRID,
                                  torch.from_numpy(_nodes()).to(dtype), DX,
                                  iters=2)
    assert res.positions.dtype == dtype
    kernel = on_card and dtype == torch.float32
    assert (calls["advect_blocks"] > 0) == kernel
    assert kernel or calls["sample_block_plain"] > 0


def test_block_mode_checks_its_inputs():
    mesh, blocks, x = _case((2, 2, 1))
    fields, specs = _fields(mesh, blocks)
    with pytest.raises(ValueError, match="float32"):
        advect_cuda._check_blocks("t", [fields[0].double()], GRID)
    with pytest.raises(ValueError, match="state"):
        advect_cuda._check_blocks("t", fields, GRID,
                                  ("state", torch.zeros((3, 4)), 5))
    with pytest.raises(ValueError, match="cover"):
        advect_cuda.advect_blocks(fields, specs, GRID, x, 2, 1e-13,
                                  groups=[[0, 1], [1, 2]])


def test_block_table_rows():
    mesh, blocks, _ = _case((2, 2, 1))
    fields, specs = _fields(mesh, blocks)
    t = advect_cuda.block_table(fields, specs, "cpu")
    assert t.shape == (4, 15) and t.dtype == torch.int64
    f, sp = fields[3], specs[3]
    assert t[3].tolist() == [f.data_ptr(), f.shape[1] * f.shape[2],
                             f.shape[2], 16, 12, 0, 32, 24, 16, -15, -11, 0,
                             f.shape[0] - 2, f.shape[1] - 2, f.shape[2] - 2]
    assert sp.widths == (1, 1, 0)


# ------------------------- spans and counters -------------------------

def _recording(fn):
    """``fn()`` under a CPU profiler session with the counters cleared:
    (its value, the names of the events, the counters)."""
    profiling._counters.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    names = [e.name for e in prof.events()]
    got = profiling.counters()
    profiling._counters.clear()
    return out, names, got


def test_halo_bytes_by_hand():
    """(2, 2, 1) blocks of (8, 6, 5), halo 2: each of the four blocks
    receives one x slab (2, 6 + 4, 5) and one y slab (8 + 4, 2, 5) from a
    neighbour; the global faces are zero-filled, not copied."""
    mesh = make_mesh((2, 2, 1), ["cpu"])
    blocks = split_blocks(mesh, torch.randn(16, 12, 5))
    _, names, got = _recording(
        lambda: halo.halo_exchange(blocks, (2, 2, 0), mesh))
    assert got["halo.bytes"] == 4 * 4 * (2 * 10 * 5 + 12 * 2 * 5)
    assert names.count("lsf.halo_exchange") == 1


def test_periodic_wrap_onto_its_own_face_is_not_counted():
    mesh = make_mesh((2, 1, 1), ["cpu"])
    blocks = split_blocks(mesh, torch.randn(16, 6, 5))
    _, _, got = _recording(
        lambda: halo.halo_exchange(blocks, 1, mesh, periodic=True))
    # x: two slabs of (1, 8, 7) each way; y and z wrap onto each block
    assert got["halo.bytes"] == 4 * 2 * 2 * 8 * 7


def test_sharded_run_mesh_spans_and_counters():
    mesh = analytic.icosphere_mesh(subdivisions=1)
    cfg = LevelSetConfig(dx=0.12, pad_cells=6, reinit_iters=12,
                         minmax_iters=6, final_reinit_iters=4,
                         advect_iters=5, mesh_shape=(2, 2, 1), device="cpu",
                         gather_results=False)
    res, names, got = _recording(lambda: run_mesh(mesh, cfg))
    for name in ("lsf.sharded.init", "lsf.sharded.advect",
                 "lsf.halo_exchange"):
        assert name in names, name
    assert names.count("lsf.sharded.solve") == 3     # reinit, min/max, final
    assert got["sharded.host_reads"] == got["sharded.steps"] > 0
    assert got["sharded.steps"] >= res.reinit_iters + res.minmax_iters
    assert got["halo.bytes"] > 0
    # with no session recording, nothing is counted
    profiling._counters.clear()
    run_mesh(mesh, cfg)
    assert profiling.counters() == {}
