"""The sharded init's blocks at once: once a block's scan is launched the
host waits on no card inside the init, so blocks on different cards run
together.

On the CPU: ``_init_rows`` makes no copy from the host and no host read
after the scan's launch (the plain scan stands in for K7; the calls that
would copy or read on the card are recorded), for K10's rows, the host
build's and the dense rows; the spans and counters of the sharded init on
a (2, 2, 1) mesh; the overlap counter against stand-in cards whose events
are pending or done.

On the card (marker ``card``; they skip without one): the sharded init's
blocks bitwise each block's own init, run alone with the card synchronised
between; on two or more cards at least one block overlapped another
card's work.  Run them on the card with ``python -m pytest --noconftest
-p no:cacheprovider -m card tests/test_torch_sharded_init.py`` (no JAX is
imported).
"""

import glob
import json
import os
import types

import numpy as np
import pytest
import torch

from levelsetfortran_tpu_torch.grid import grid as tgrid
from levelsetfortran_tpu_torch.models.analytic import icosphere_mesh
from levelsetfortran_tpu_torch.ops import cull_cuda, init_cuda
from levelsetfortran_tpu_torch.ops import init_sign as tinit
from levelsetfortran_tpu_torch.parallel.halo import local_offsets
from levelsetfortran_tpu_torch.parallel.mesh import make_mesh
from levelsetfortran_tpu_torch.utils import profiling

torch.set_num_threads(1)


def _ball_grid(n=32, subdivisions=2):
    ball = icosphere_mesh(subdivisions=subdivisions)
    lo, hi = ball.vertices.min(0), ball.vertices.max(0)
    span = float((hi - lo).max()) * 1.2
    grid = tgrid.Grid3D(shape=(n,) * 3, dx=span / (n - 1), origin=tuple(
        float(c) for c in (lo + hi) / 2 - span / 2))
    return ball, grid


def _rows(kind, m, grid):
    if kind == "dense":
        nb = tuple(-(-s // 16) for s in grid.shape)
        return init_cuda.dense_rows(int(np.prod(nb)), m.n_elems), 16, nb
    frame = cull_cuda.cull_frame(grid, m.vertices, m.elements)
    if kind == "k10":
        rows = cull_cuda.cull_rows_plain(frame)
    else:
        c = tinit.build_init_culling(grid, m.vertices, m.elements)
        rows = init_cuda.pack_rows(c.cands, c.bidxs, m.n_elems)
    return rows, frame.block, frame.nblocks


class _Copies:
    """Records, once armed, every call that would copy from the host to
    the card or read the card back there."""

    def __init__(self, monkeypatch):
        self.armed, self.seen, self.offsets_made = False, [], 0
        self.offsets = None
        real_as_tensor = torch.as_tensor

        def as_tensor(data, *a, **k):
            if self.offsets is not None and data is self.offsets:
                self.offsets_made += 1
            self._note("torch.as_tensor")
            return real_as_tensor(data, *a, **k)

        monkeypatch.setattr(torch, "as_tensor", as_tensor)
        for name in ("tensor", "from_numpy"):
            self._wrap(monkeypatch, torch, name, "torch." + name)
        for name in ("cpu", "item", "numpy", "tolist", "__bool__",
                     "__float__", "__int__"):
            self._wrap(monkeypatch, torch.Tensor, name, "Tensor." + name)
        real_to = torch.Tensor.to

        def to(t, *a, **k):
            # a move between devices; a dtype alone stays on the card
            if "device" in k or any(isinstance(x, (str, torch.device))
                                    for x in a):
                self._note("Tensor.to")
            return real_to(t, *a, **k)

        monkeypatch.setattr(torch.Tensor, "to", to)

    def _note(self, what):
        if self.armed:
            self.seen.append(what)

    def _wrap(self, monkeypatch, owner, name, label):
        real = getattr(owner, name)

        def wrapped(*a, **k):
            self._note(label)
            return real(*a, **k)

        monkeypatch.setattr(owner, name, wrapped)


@pytest.mark.parametrize("kind", ["k10", "host", "dense"])
def test_nothing_copied_or_read_after_the_scan_launch(kind, monkeypatch):
    """After the scan's launch (the plain scan in K7's wrapper stands in
    for it) ``_init_rows`` neither copies a host array to the device nor
    reads one back; the rows' offsets are made into a tensor once, for
    the scan and the exact stage both."""
    m, grid = _ball_grid(40)
    rows, block, nblocks = _rows(kind, m, grid)
    v = torch.as_tensor(m.vertices, dtype=torch.float32)
    tri = v[torch.as_tensor(m.elements, dtype=torch.long)]
    want = tinit._init_rows(grid, tri, rows, block, nblocks,
                            dtype=torch.float32, tile=512)
    copies = _Copies(monkeypatch)
    copies.offsets = rows.offsets
    real = init_cuda.select_rows

    def launch(*a, **k):
        out = real(*a, **k)
        copies.armed = True
        return out

    monkeypatch.setattr(init_cuda, "select_rows", launch)
    got = tinit._init_rows(grid, tri, rows, block, nblocks,
                           dtype=torch.float32, tile=512)
    assert copies.armed, "the scan went by another route"
    assert copies.seen == []
    assert copies.offsets_made == (0 if kind == "dense" else 1)
    assert torch.equal(got, want)


def _spans(logdir):
    (path,) = glob.glob(os.path.join(logdir, "*.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("cat") == "user_annotation"
            and e.get("ph") == "X"]


def _inside(child, parent):
    return (child["tid"] == parent["tid"] and parent["ts"] <= child["ts"]
            and child["ts"] + child["dur"] <= parent["ts"] + parent["dur"])


def test_sharded_init_spans_and_counters(tmp_path, monkeypatch):
    """Under a session: four ``lsf.sharded.init.block`` spans inside
    ``lsf.sharded.init``, an ``lsf.init`` in each; four blocks counted,
    none overlapped on the CPU.  Without one: no span, no count, no
    event."""
    m, grid = _ball_grid(32, subdivisions=1)
    mesh = make_mesh((2, 2, 1), ["cpu"])

    def go():
        return tinit.signed_distance_init_sharded(grid, m.vertices,
                                                  m.elements, mesh)

    with monkeypatch.context() as mp:
        mp.setattr(profiling, "_counters", {})
        mp.setattr(torch.profiler, "record_function",
                   lambda *a, **k: pytest.fail("a span with no session"))
        mp.setattr(torch.cuda, "Event",
                   lambda *a, **k: pytest.fail("an event with no session"))
        plain = go()
        assert profiling.counters() == {}
    logdir = str(tmp_path / "trace")
    with profiling.trace(logdir):
        traced = go()
        got = profiling.counters()
    assert got["sharded.init_blocks"] == 4
    assert got["sharded.init_overlapped"] == 0
    spans = _spans(logdir)
    (outer,) = [e for e in spans if e["name"] == "lsf.sharded.init"]
    blocks = [e for e in spans if e["name"] == "lsf.sharded.init.block"]
    inits = [e for e in spans if e["name"] == "lsf.init"]
    assert len(blocks) == 4 and len(inits) == 4
    assert all(_inside(b, outer) for b in blocks)
    assert all(sum(_inside(i, b) for i in inits) == 1 for b in blocks)
    for a, b in zip(plain, traced, strict=True):
        assert torch.equal(a, b)


class _Event:
    """A stand-in for ``torch.cuda.Event``: recorded on a stream, done or
    not as the test says."""
    done = False

    def record(self, stream):
        self.stream = stream

    def query(self):
        return self.done


@pytest.mark.parametrize("cards, done, overlapped", [
    (["cuda:0", "cuda:1", "cuda:2", "cuda:3"], False, 3),
    (["cuda:0", "cuda:1"], False, 3),       # blocks on cards 0, 1, 0, 1
    (["cuda:0"], False, 0),                 # one card: stream order
    (["cuda:0", "cuda:1", "cuda:2", "cuda:3"], True, 0),
])
def test_overlap_counter(cards, done, overlapped, monkeypatch):
    """A block counts as overlapped when, once it is enqueued, an earlier
    block's event on another card is not done yet."""
    mesh = make_mesh((2, 2, 1), cards)
    calls = []

    def init(sub, v, elements, *, device, **k):
        calls.append(device)
        return torch.zeros(sub.shape)

    monkeypatch.setattr(tinit, "signed_distance_init", init)
    monkeypatch.setattr(torch.cuda, "Event", type(
        "Event", (_Event,), {"done": done}))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(device=dev))
    grid = tgrid.Grid3D(shape=(8, 8, 4), origin=(0.0, 0.0, 0.0), dx=0.1)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        profiling._counters.clear()
        blocks = tinit.signed_distance_init_sharded(
            grid, np.zeros((3, 3)), np.zeros((1, 3), np.int32), mesh)
        got = profiling.counters()
    assert calls == list(mesh.devices) and len(blocks) == 4
    assert got == {"sharded.init_blocks": 4,
                   "sharded.init_overlapped": overlapped}


# ------------------------------ on the card ------------------------------

@pytest.fixture
def cards():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K7 and K10 run on the card only")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


@pytest.mark.card
def test_blocks_at_once_are_bitwise_each_block_alone(cards):
    """A (2, 2, 1) cut of a 254^3-class grid of the icosphere of 20,480
    triangles, the blocks round-robin over the cards present: each block
    of the sharded init bitwise that block's own init run alone, the cards
    synchronised between; on two or more cards at least one block was
    enqueued while another card still worked on an earlier one."""
    m = icosphere_mesh(radius=1.0, subdivisions=5)
    grid = tgrid.from_surface(m.vertices, 0.00855, 10, (2, 2, 1))
    mesh = make_mesh((2, 2, 1), cards)
    tinit.signed_distance_init_sharded(grid, m.vertices, m.elements, mesh)
    for d in cards:
        torch.cuda.synchronize(d)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        profiling._counters.clear()
        got = tinit.signed_distance_init_sharded(grid, m.vertices,
                                                 m.elements, mesh)
        seen = profiling.counters()
    for d in cards:
        torch.cuda.synchronize(d)
    b = mesh.block_shape(grid.shape)
    for off, dev, block in zip(local_offsets(mesh, b), mesh.devices, got):
        sub = tgrid.Grid3D(shape=b, origin=tuple(
            o + i * grid.dx for o, i in zip(grid.origin, off)), dx=grid.dx)
        alone = tinit.signed_distance_init(sub, m.vertices, m.elements,
                                           device=dev, block_of=(grid, off))
        torch.cuda.synchronize(dev)
        assert block.device == dev and torch.equal(block, alone), off
    print(f"{grid.shape} on {len(cards)} card(s): {seen}")
    assert seen["sharded.init_blocks"] == 4
    if len(cards) >= 2:
        assert seen["sharded.init_overlapped"] >= 1
    else:
        assert seen["sharded.init_overlapped"] == 0
