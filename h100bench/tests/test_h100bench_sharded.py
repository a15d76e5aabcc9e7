"""The sharded cell on the CPU at a tiny size: its reference against the
program's sharded ``run_mesh`` reads within the cell's limits, and two
planted faults read incorrect (a node on a seam sampled by two owners; the
reinit's stop test once a chunk of 9 steps instead of every step).  Then
the reference's brick rules, the count of K8's block mode, and the new
readers on a synthetic timeline, None where their span or counter is
absent."""

import json
import math

import numpy as np
import pytest
import torch

from levelsetfortran_tpu_torch.ops import advect_cuda
from levelsetfortran_tpu_torch.parallel import sharded as sh
from levelsetfortran_tpu_torch.utils import profiling

from h100bench import catalog, run, trace
from h100bench.reference import sharded as ref
from h100bench.roofline import k8_block
from h100bench.run import Run
from h100bench.tests import tiny

CELL = "icosphere5_512.sharded4"
READERS = ("sharded.advect_s", "sharded.exchange_ms",
           "sharded.solve_idle_share", "sharded.host_reads_per_step",
           "k8_block_roofline")


@pytest.fixture(scope="module")
def sharded_root(tmp_path_factory):
    """The tiny benchmark with the sharded cell's body and spacing made
    small too, its (2, 2, 1) mesh kept; the reinit's tolerance loosened so
    that the coarse body's reinit stops after a few steps, as the cell's
    does (2 at 512^3), and not at a cap."""
    root = tiny.make(tmp_path_factory.mktemp("bench"))
    p = root / "h100bench" / "configs" / "icosphere5_512.json"
    c = json.loads(p.read_text())
    c.update(body={"generator": "icosphere", "subdivisions": 1,
                   "radius": 1.0}, dx=0.12, pad_cells=6,
             levelset=dict(tiny.CAPS, reinit_tol=3e-4, **c["levelset"]))
    p.write_text(json.dumps(c))
    return root


def test_sound_runs_are_correct(sharded_root):
    res = run.measure(CELL, 2 ** 31 + 77, 0.2, False, device="cpu",
                      root=sharded_root)
    assert res["correct"], res["checks"]
    assert {"mesh_s", "setup_s"} <= set(res["metrics"])


def _seam_twice(real):
    """Each shard also samples the nodes whose base cell lies one cell
    past either of its faces: a node at a seam gets two owners' samples."""
    def wide(field, spec, grid, x, consts=None, reach=False):
        spec = spec._replace(lo=tuple(v - 1 for v in spec.lo),
                             end=tuple(v + 1 for v in spec.end))
        return real(field, spec, grid, x, None, reach)
    return wide


def _stop_each_chunk(self, blocks, h, iters, tol, sign_src, chunk=9):
    """``ShardedLevelSet._reinit`` with the stop test on the last step of
    each chunk of ``chunk`` steps only."""
    from levelsetfortran_tpu_torch.parallel.halo import halo_exchange
    sign = blocks if sign_src is None else sign_src
    spads = sh._each(torch.Tensor.contiguous,
                     halo_exchange(sign, self.widths, self.mesh))
    pads = self._padded(blocks, self.widths)
    outs = sh._each(torch.zeros_like, pads)
    n, rms = 0, math.inf
    while n < iters:
        pads, outs, dsqs = self._reinit_once(pads, outs, spads, h, self.k,
                                             True)
        n += self.k
        rms = sh._global_rms(dsqs, self.gshape, self.mesh)
        if n % chunk == 0 and (rms < tol or math.isnan(rms)):
            break
    return self._cropped(pads, self.widths), n, rms


@pytest.mark.parametrize("fault", ["seam node sampled twice",
                                   "stop test once a chunk"])
def test_fault_reads_incorrect(sharded_root, monkeypatch, fault):
    if fault == "seam node sampled twice":
        monkeypatch.setattr(advect_cuda, "sample_block_plain",
                            _seam_twice(advect_cuda.sample_block_plain))
    else:
        monkeypatch.setattr(sh.ShardedLevelSet, "_reinit", _stop_each_chunk)
    res = run.measure(CELL, 2 ** 31 + 78, 0.2, False, device="cpu",
                      root=sharded_root)
    assert res["correct"] is False, res["checks"]


def test_axis_bricks_anchor_on_each_block():
    """Blocks of 13: bricks at 0 and 8 (cut at 13), then 13 and 21; the
    window reaches 4 cells out, no further than the block's halo or the
    grid."""
    got = ref.axis_bricks(26, 2)
    assert got == [(0, 8, 0, 12), (8, 13, 4, 17), (13, 21, 9, 25),
                   (21, 26, 17, 26)]
    assert ref.axis_bricks(16, 1) == [(0, 8, 0, 12), (8, 16, 4, 16)]


def test_live_cells_is_the_brick_minimum():
    g = torch.Generator().manual_seed(4)
    phi = torch.rand((26, 16, 10), generator=g) + 0.5
    phi[15, 3, 2] = 0.0                 # in x brick (13, 21), window 9-25
    bricks = [ref.axis_bricks(26, 2), ref.axis_bricks(16, 2),
              ref.axis_bricks(10, 1)]
    live = ref.live_cells(phi, bricks, 0.1)
    assert live.shape == phi.shape
    want = torch.zeros_like(live)
    # x bricks whose window holds 15: (8, 13) [4, 17) and (13, 21) [9, 25);
    # y: blocks of 8, (0, 8) [0, 12) only; z, one block: (0, 8) [0, 10)
    # only ((8, 10) looks at [4, 10))
    want[8:21, 0:8, 0:8] = True
    assert torch.equal(live, want)


def test_k8_block_count():
    assert k8_block.ops(10242, 1000) == 124 * 10242 * 1001
    assert k8_block.bound_s(10242, 1000) == pytest.approx(
        124 * 10242 * 1001 / 67e12)
    assert k8_block.KERNELS == ("advect_run_kernel", "advect_sample_kernel")


# ------------------------- the new readers -------------------------

MAIN, DEV = 1, 7


def _x(cat, name, ts, dur, tid=MAIN, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


# two meshes (0-500, 500-1000): halo copies launched inside the exchange
# spans, a fill outside them, the block mode's run kernel in the advection
EVENTS = [
    _x("user_annotation", "h100bench.window", 0, 1000),
    _x("user_annotation", "h100bench.job", 0, 500),
    _x("user_annotation", "h100bench.job", 500, 500),
    _x("user_annotation", "lsf.sharded.solve", 10, 200),
    _x("user_annotation", "lsf.halo_exchange", 20, 30),
    _x("user_annotation", "lsf.sharded.advect", 300, 100),
    _x("user_annotation", "lsf.sharded.solve", 510, 100),
    _x("user_annotation", "lsf.halo_exchange", 520, 20),
    _x("user_annotation", "lsf.sharded.advect", 700, 200),
    _x("cuda_runtime", "cudaMemcpyAsync", 22, 2, corr=1),
    _x("gpu_memcpy", "Memcpy PtoP (Device -> Device)", 25, 40, DEV, 1),
    _x("cuda_runtime", "cudaLaunchKernel", 30, 2, corr=2),
    _x("kernel", "fill_kernel", 70, 10, DEV, 2),
    _x("cuda_runtime", "cudaLaunchKernel", 60, 2, corr=3),
    _x("kernel", "reinit_brick_kernel", 100, 50, DEV, 3),
    _x("cuda_runtime", "cudaLaunchKernel", 310, 2, corr=4),
    _x("kernel", "advect_run_kernel", 320, 60, DEV, 4),
    _x("cuda_runtime", "cudaMemcpyAsync", 525, 2, corr=5),
    _x("gpu_memcpy", "Memcpy PtoP (Device -> Device)", 530, 20, DEV, 5),
    _x("cuda_runtime", "cudaLaunchKernel", 710, 2, corr=6),
    _x("kernel", "advect_run_kernel", 720, 80, DEV, 6),
]


def _run(events=EVENTS, ctx=None):
    tr = trace.Trace(events)
    win = tr.span("h100bench.window")
    recs = [{"units": 1, "n_nodes": 100}, {"units": 1, "n_nodes": 100}]
    return Run(ctx, recs, 1.0, {}, 0.0, tr, win.ts, win.end)


class _Ctx:
    config = {"levelset": {"mesh_shape": [2, 2, 1], "advect_iters": 9}}


def _read(name, r):
    return catalog.metric(name).read(r)


def test_readers_on_a_timeline(monkeypatch):
    monkeypatch.setattr(profiling, "_counters",
                        {"sharded.steps": 30, "sharded.host_reads": 30})
    r = _run(ctx=_Ctx())
    assert _read("sharded.advect_s", r) == pytest.approx(150e-6)
    # copies and the fill launched inside the exchanges: (40 + 10, 20) us
    assert _read("sharded.exchange_ms", r) == pytest.approx(0.035)
    # solve spans 300 us, busy inside them 10-210: 25..65, 70..80,
    # 100..150 = 100; 510-610: 530..550 = 20
    assert _read("sharded.solve_idle_share", r) == pytest.approx(
        100.0 * (1 - 120 / 300))
    assert _read("sharded.host_reads_per_step", r) == 1.0
    share = _read("k8_block_roofline", r)
    assert share == pytest.approx(100.0 * 2 * k8_block.bound_s(100, 9)
                                  / 140e-6)


@pytest.mark.parametrize("name", READERS)
def test_readers_none_without_their_span_or_counter(monkeypatch, name):
    """A program without the spans and counters (the parent of this cell)
    reports nothing, and raises nothing."""
    monkeypatch.setattr(profiling, "_counters", {})
    bare = [e for e in EVENTS if not e["name"].startswith(("lsf.",
                                                           "advect_"))]
    assert _read(name, _run(bare, _Ctx())) is None
    r = _run(ctx=_Ctx())
    r.trace = None
    assert _read(name, r) is None


def test_counter_reader_without_counters_function(monkeypatch):
    monkeypatch.delattr(profiling, "counters")
    assert _read("sharded.host_reads_per_step", _run(ctx=_Ctx())) is None


def test_the_cell_asks_for_four_cards_and_reports_its_metrics():
    bench = catalog.benchmark()
    w = catalog.workload(bench, CELL)
    assert w["chips"] == 4 and w["traffic"] == "sharded"
    names = {m["name"] for m in catalog.metrics_of(bench, CELL, True)}
    assert set(READERS) <= names
    assert {m["name"] for m in catalog.metrics_of(bench, CELL, False)} == {
        "mesh_s", "setup_s"}
    c = catalog.config(bench, w["config"])
    grid = ref.grid_on(*_unit_sphere(c), c["dx"], c["pad_cells"],
                       c["levelset"]["mesh_shape"])
    assert grid.shape == (512, 512, 512)


def _unit_sphere(c):
    from h100bench import meshes
    from h100bench.reference import geometry
    verts, _ = geometry.soup_mesh(meshes.base_soup(c["body"]))
    return (verts,)


def test_reference_grid_is_the_programs():
    """The sharded ``from_surface``: each axis rounded up to the mesh."""
    from levelsetfortran_tpu_torch.grid.grid import from_surface
    verts = np.array([[0.0, 0.0, 0.0], [1.0, 0.5, 0.3], [0.2, 0.9, 0.1]])
    for dx in (0.1, 0.07, 0.004085):
        g = ref.grid_on(verts, dx, 10, (2, 2, 1))
        assert g.shape == from_surface(verts, dx, 10, (2, 2, 1)).shape
        assert all(n % m == 0 for n, m in zip(g.shape, (2, 2, 1)))
