"""K10, the init's candidate culling on the card (``ops/cull_cuda.py``).

On the CPU: the plain version's rows against the host build's
(``pack_rows(build_init_culling(...))``), the init's field from either
set of rows, and the routes (the CPU builds on the host; ``cull_rows``
runs the plain version for the CPU and off it launches K10 or raises).
The rows may differ only by a pair within ``NEAR_ULPS`` float32 ulps of
its threshold, counted at the scale of the quadratic form that decides it
(``cull_cuda.margin_ulps``), where the host's BLAS rounds the three-term
dot another way than the fixed order; the fields are held bitwise.

On the card (marker ``card``; they skip without one): K10's rows bitwise
its plain version's, and ``signed_distance_init(culling="auto")``, which
takes K10 there, bitwise the init on the host-built culling, whole and
for one block of a larger grid.  Run them on the card with
``python -m pytest --noconftest -p no:cacheprovider -m card
tests/test_torch_init_cull.py`` (no JAX is imported).
"""

import contextlib
import types

import numpy as np
import pytest
import torch

from levelsetfortran_tpu_torch import cuda_build
from levelsetfortran_tpu_torch.grid import grid as tgrid
from levelsetfortran_tpu_torch.models.analytic import (icosphere_mesh,
                                                       two_cubes_mesh)
from levelsetfortran_tpu_torch.ops import cull_cuda, init_cuda
from levelsetfortran_tpu_torch.ops import init_sign as tinit
from levelsetfortran_tpu_torch.utils import profiling

torch.set_num_threads(1)
MESHES = {"two_cubes": two_cubes_mesh,
          "icosphere2": lambda: icosphere_mesh(subdivisions=2)}
#: A pair the two builds keep apart must lie this close to its threshold,
#: in float32 ulps of the quadratic form (``cull_cuda.margin_ulps``).
NEAR_ULPS = 4
#: The run cell's spacing (``h100bench/configs/icosphere5_256.json``).
RUN_DX = 0.00855


def _host_rows(m, grid):
    c = tinit.build_init_culling(grid, m.vertices, m.elements)
    return init_cuda.pack_rows(c.cands, c.bidxs, m.n_elems)


def _lists(rows):
    """Each block's candidates as a host array, by block id."""
    flat = (rows.flat.cpu().numpy() if isinstance(rows.flat, torch.Tensor)
            else rows.flat)
    return {int(b): flat[o:o + n] for b, o, n in
            zip(rows.bidx, rows.offsets, rows.counts)}


def _apart(frame, host, other):
    """The (block, triangle) pairs one set of rows keeps and the other not,
    each with its distance to the nearer threshold
    (:func:`~levelsetfortran_tpu_torch.ops.cull_cuda.margin_ulps`)."""
    a, b = _lists(host), _lists(other)
    assert sorted(a) == sorted(b)
    return [(k, t, cull_cuda.margin_ulps(frame, k, int(t))) for k in a
            for t in np.setxor1d(a[k], b[k])]


@pytest.mark.parametrize("dx", [0.1, 0.05])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_plain_rows_match_the_host_build(mesh, dx):
    """The plain version's rows against ``pack_rows(build_init_culling())``:
    the same blocks in the same order and counts, the same candidates in
    ascending order, apart only at a pair within NEAR_ULPS of its
    threshold (counted; none on these meshes)."""
    m = MESHES[mesh]()
    grid = tgrid.from_surface(m.vertices, dx, 3)
    host = _host_rows(m, grid)
    frame = cull_cuda.cull_frame(grid, m.vertices, m.elements)
    plain = cull_cuda.cull_rows_plain(frame)
    assert isinstance(plain.flat, torch.Tensor)
    assert plain.flat.dtype == torch.int32
    assert set(plain.bidx.tolist()) == set(range(len(frame.centers)))
    assert (np.diff(plain.counts) <= 0).all()
    for row in _lists(plain).values():
        assert (np.diff(row) > 0).all()
    apart = _apart(frame, host, plain)
    print(f"{mesh} dx {dx}: {len(apart)} pair(s) apart from the host "
          f"build, at {[round(u, 2) for *_, u in apart]} ulps")
    assert all(u <= NEAR_ULPS for *_, u in apart)
    if not apart:
        np.testing.assert_array_equal(plain.bidx, host.bidx)
        np.testing.assert_array_equal(plain.counts, host.counts)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("dx", [0.1, 0.05])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_init_fields_from_both_rows_are_bitwise(mesh, dx, dtype):
    """The init's field over the plain version's rows (their ``flat`` a
    tensor) is bitwise the field over the host build's."""
    m = MESHES[mesh]()
    grid = tgrid.from_surface(m.vertices, dx, 3)
    frame = cull_cuda.cull_frame(grid, m.vertices, m.elements)
    v = torch.as_tensor(m.vertices, dtype=dtype)
    tri = v[torch.as_tensor(m.elements, dtype=torch.long)]
    a, b = (tinit._init_rows(grid, tri, rows, frame.block, frame.nblocks,
                             dtype=dtype, tile=512)
            for rows in (_host_rows(m, grid),
                         cull_cuda.cull_rows_plain(frame)))
    assert torch.equal(a, b)


def test_rows_table_of_a_tensor_flat():
    """``Rows.table`` pads a tensor ``flat`` as it pads an array."""
    E = 9
    rows = init_cuda.pack_rows(
        (np.array([[1, E, 3, E, E], [4, 5, 6, 7, 8], [E] * 5], np.int32),),
        (np.array([7, 2, 5], np.int32),), E)
    on = init_cuda.Rows(rows.bidx, rows.counts, rows.offsets,
                        torch.as_tensor(rows.flat))
    for sl in (slice(None), slice(1, 3)):
        np.testing.assert_array_equal(on.table(sl, 6, E).numpy(),
                                      rows.table(sl, 6, E))


def test_frame_is_the_host_builds(monkeypatch):
    """The host build takes its constants from ``cull_frame``: a margin
    reaches both the frame and the rows' slack."""
    m = MESHES["icosphere2"]()
    grid = tgrid.from_surface(m.vertices, 0.1, 3)
    seen = []
    real = cull_cuda.cull_frame

    def spy(*a, **k):
        seen.append(real(*a, **k))
        return seen[-1]

    monkeypatch.setattr(cull_cuda, "cull_frame", spy)
    tinit.build_init_culling(grid, m.vertices, m.elements, margin=0.06)
    (f,) = seen
    assert f.margin == 0.06
    assert f.slack == np.float32(1e-3 * (f.R_b + 0.06) + 1e-9)
    assert f.nblocks == tuple(-(-s // 16) for s in grid.shape)
    assert f.nparents == tuple(-(-s // 4) for s in f.nblocks)


class _Calls:
    def __init__(self, monkeypatch, module, *names):
        self.n = {k: 0 for k in names}
        for k in names:
            real = getattr(module, k)

            def wrap(*a, _real=real, _k=k, **kw):
                self.n[_k] += 1
                return _real(*a, **kw)

            monkeypatch.setattr(module, k, wrap)


def test_auto_culling_on_the_cpu_builds_on_the_host(monkeypatch):
    """``culling="auto"`` on the CPU builds through ``build_init_culling``
    and ``pack_rows``; K10's wrapper is not called, and no device build is
    counted."""
    host = _Calls(monkeypatch, tinit, "build_init_culling", "pack_rows")
    k10 = _Calls(monkeypatch, cull_cuda, "cull_rows", "cull_rows_plain")
    m = two_cubes_mesh()
    grid = tgrid.from_surface(m.vertices, 0.2, 2)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        profiling._counters.clear()
        tinit.signed_distance_init(grid, m.vertices, m.elements)
        seen = profiling.counters()
    assert host.n == {"build_init_culling": 1, "pack_rows": 1}
    assert k10.n == {"cull_rows": 0, "cull_rows_plain": 0}
    assert "init.pairs" in seen and "init.culls_on_device" not in seen


@contextlib.contextmanager
def _no_card(monkeypatch):
    """Meta tensors stand in for the card's: a launch records its entry
    and arguments and raises as a launch with no library would; the plain
    version fails if called."""
    launched = []

    def launch(name, *args):
        launched.append((name, args))
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(cuda_build, "launch", launch)
    monkeypatch.setattr(cull_cuda, "on_device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(cull_cuda, "cull_rows_plain",
                        lambda *a, **k: pytest.fail("fell back"))
    yield launched


def test_cull_rows_runs_the_plain_version_on_the_cpu(monkeypatch):
    calls = _Calls(monkeypatch, cull_cuda, "cull_rows_plain")
    m = two_cubes_mesh()
    frame = cull_cuda.cull_frame(tgrid.from_surface(m.vertices, 0.2, 2),
                                 m.vertices, m.elements)
    before = cull_cuda.cull_rows.launches
    rows = cull_cuda.cull_rows(frame, "cpu")
    assert calls.n == {"cull_rows_plain": 1}
    assert cull_cuda.cull_rows.launches == before
    assert rows.flat.device.type == "cpu"


def test_cull_rows_launches_or_raises_off_the_cpu(monkeypatch):
    """Off the CPU the wrapper launches K10's first entry with every
    argument of its signature (the blocks, parents, triangles and both
    rasters' inner sizes), or raises; it never runs the plain version."""
    m = icosphere_mesh(subdivisions=2)
    grid = tgrid.from_surface(m.vertices, 0.1, 3)
    frame = cull_cuda.cull_frame(grid, m.vertices, m.elements)
    before = cull_cuda.cull_rows.launches
    with _no_card(monkeypatch) as launched:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            cull_cuda.cull_rows(frame, "meta")
        ((name, a),) = launched
    assert name == "lsf_cull_count"
    assert len(a) == len(cuda_build.SIGNATURES[name])
    nb, nbc = frame.nblocks, frame.nparents
    assert a[10:17] == (len(frame.centers), len(frame.pcen), m.n_elems,
                        nb[1], nb[2], nbc[1], nbc[2])
    assert a[17:20] == (frame.R_b, frame.R_p, frame.margin)
    assert cull_cuda.cull_rows.launches == before
    assert len(cuda_build.SIGNATURES["lsf_cull_fill"]) == 18


def test_cull_rows_raises_on_another_device(monkeypatch):
    monkeypatch.setattr(cull_cuda, "cull_rows_plain",
                        lambda *a, **k: pytest.fail("fell back"))
    monkeypatch.setattr(cuda_build, "launch",
                        lambda *a: pytest.fail("launched"))
    m = two_cubes_mesh()
    frame = cull_cuda.cull_frame(tgrid.from_surface(m.vertices, 0.2, 2),
                                 m.vertices, m.elements)
    with pytest.raises((RuntimeError, AssertionError, ValueError)):
        cull_cuda.cull_rows(frame, "meta")


# ------------------------------ on the card ------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K10 runs on the card only")
    return torch.device("cuda")


def _card_cases():
    """(name, mesh, grid): the run cell's body at its spacing on a
    128^3-class grid (the icosphere of 20,480 triangles at radius 0.5),
    and the two cubes at dx 0.05."""
    ball = icosphere_mesh(radius=0.5, subdivisions=5)
    cubes = two_cubes_mesh()
    return {"icosphere5": (ball, tgrid.from_surface(ball.vertices, RUN_DX,
                                                    10)),
            "two_cubes": (cubes, tgrid.from_surface(cubes.vertices, 0.05,
                                                    10))}


@pytest.mark.card
@pytest.mark.parametrize("case", ["icosphere5", "two_cubes"])
def test_k10_rows_are_bitwise_the_plain_version(card, case):
    m, grid = _card_cases()[case]
    frame = cull_cuda.cull_frame(grid, m.vertices, m.elements)
    before = cull_cuda.cull_rows.launches
    k10 = cull_cuda.cull_rows(frame, card)
    plain = cull_cuda.cull_rows_plain(frame, card)
    assert cull_cuda.cull_rows.launches == before + 1
    assert k10.flat.device.type == "cuda"
    for name in ("bidx", "counts", "offsets"):
        np.testing.assert_array_equal(getattr(k10, name),
                                      getattr(plain, name))
    assert torch.equal(k10.flat, plain.flat)
    apart = _apart(frame, _host_rows(m, grid), k10)
    print(f"{case} {grid.shape}: {len(apart)} pair(s) apart from the host "
          f"build")
    assert all(u <= NEAR_ULPS for *_, u in apart)


@pytest.mark.card
@pytest.mark.parametrize("case", ["icosphere5", "two_cubes"])
def test_auto_init_on_the_card_is_bitwise_the_host_culled(card, case):
    """``culling="auto"`` on the card (K10, one device build counted)
    against the same init on the host build's culling."""
    m, grid = _card_cases()[case]
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        profiling._counters.clear()
        auto = tinit.signed_distance_init(grid, m.vertices, m.elements,
                                          device=card)
        seen = profiling.counters()
    host = tinit.signed_distance_init(
        grid, m.vertices, m.elements, device=card,
        culling=tinit.build_init_culling(grid, m.vertices, m.elements))
    assert seen.get("init.culls_on_device") == 1
    assert torch.equal(auto, host)


@pytest.mark.card
def test_block_of_on_the_card_is_bitwise_the_host_culled(card):
    """Block (1, 0, 0) of a (2, 2, 1) cut of the icosphere's grid, culled
    by K10, against the same block on its host-built culling."""
    m, grid = _card_cases()["icosphere5"]
    b = (grid.shape[0] // 2, grid.shape[1] // 2, grid.shape[2])
    off = (b[0], 0, 0)
    sub = tgrid.Grid3D(shape=b, origin=tuple(
        o + i * grid.dx for o, i in zip(grid.origin, off)), dx=grid.dx)
    auto = tinit.signed_distance_init(sub, m.vertices, m.elements,
                                      device=card, block_of=(grid, off))
    host = tinit.signed_distance_init(
        sub, m.vertices, m.elements, device=card, block_of=(grid, off),
        culling=tinit.build_init_culling(sub, m.vertices, m.elements))
    assert torch.equal(auto, host)
