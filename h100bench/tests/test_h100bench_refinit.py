"""The cell ``icosphere5_256_refinit.run``: it resolves to its own
configuration, traffic, entry, limits and metrics; K9's count against one
made by hand; its readers on a synthetic timeline, and None wherever the
program lacks their span or counter (the parent of the change that added
them); and one run of the cell on the CPU at a tiny size."""

import json

import pytest

from h100bench import catalog, trace
from h100bench.reference import geometry, refinit
from h100bench.roofline import bound_s, k9
from h100bench.run import Ctx, Run
from h100bench.tests import tiny
from levelsetfortran_tpu_torch.utils import profiling

CELL = "icosphere5_256_refinit.run"
BENCH = catalog.benchmark()
READERS = ("refinit.init_ms", "k9_roofline", "refinit.reinit_ms_per_step",
           "refinit.reinit_idle_share")


def test_cell_resolves():
    w = catalog.workload(BENCH, CELL)
    assert (w["config"], w["traffic"], w["chips"]) == (
        "icosphere5_256_refinit", "run_refinit", 1)
    c = catalog.config(BENCH, w["config"])
    base = catalog.config(BENCH, "icosphere5_256")
    assert c["levelset"] == {"init_mode": "reference"}
    for key in ("body", "dx", "pad_cells", "dtype", "reduced"):
        assert c[key] == base[key], key
    t = catalog.traffic(w["traffic"])
    assert t["entry"] == "run_refinit"
    assert {k: v for k, v in t.items() if k != "entry"} == {
        **{k: v for k, v in catalog.traffic("run").items() if k != "entry"},
        "shuffle_block": 4}
    entry = catalog.entry(t["entry"])
    assert entry.Entry.__mro__[1].__name__ == "Entry"
    assert entry.Entry.check is not entry.Entry.__mro__[1].check
    assert set(catalog.limits(CELL)) == set(catalog.limits(
        "icosphere5_256.run"))
    assert {m["name"] for m in catalog.metrics_of(BENCH, CELL, False)} == {
        "mesh_s", "setup_s"}
    assert {m["name"] for m in catalog.metrics_of(BENCH, CELL, True)} == \
        set(READERS)


def test_k9_counts_by_hand():
    """Two triangles spanning [0, 1]^3 at dx 0.25, pad 6: the grid's 18
    points an axis from -1.5, the box from index 6 - 3 to 10 + 3, so 11
    points an axis and 1331 x 2 pairs; at 8 operations a pair the bound
    is the operations'."""
    soup = [[[0, 0, 0], [1, 0, 0], [0, 1, 1]],
            [[1, 1, 1], [0, 1, 0], [1, 0, 1]]]
    verts, _ = geometry.soup_mesh(soup)
    grid = geometry.from_surface(verts, 0.25, 6)
    assert grid.shape == (18, 18, 18) and grid.origin == (-1.5,) * 3
    assert refinit.subbox(grid, verts) == [(3, 13)] * 3
    assert k9.sizes(soup, 0.25, 6) == (1331, 2)
    assert k9.pairs(soup, 0.25, 6) == 2662
    assert k9.bound_s(1331, 2) == bound_s(
        ops=8 * 2662, nbytes=12 * 1333 + 8 * 1331)
    # the box clamps to the grid where the pad is under the margin
    assert k9.sizes(soup, 0.25, 1) == (8 ** 3, 2)


MAIN, DEV = 1, 7


def _x(cat, name, ts, dur, tid=MAIN, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _launch(ts, corr):
    return _x("cuda_runtime", "cudaLaunchKernel", ts, 2, MAIN, corr)


def _kernel(ts, dur, corr):
    return _x("kernel", f"k{corr}", ts, dur, DEV, corr)


# two jobs: the init's search (a kernel of 30 us, one of 10) and sign (5),
# then a dense reinit of 100 us in which the card runs 40 us
EVENTS = [_x("user_annotation", "h100bench.window", 0, 1000)]
for j, t0 in enumerate((0, 500)):
    EVENTS += [
        _x("user_annotation", "h100bench.job", t0, 500),
        _x("user_annotation", "lsf.init.reference", t0 + 10, 90),
        _x("user_annotation", "lsf.init.reference.nearest", t0 + 10, 50),
        _x("user_annotation", "lsf.init.reference.sign", t0 + 60, 40),
        _x("user_annotation", "lsf.reinit", t0 + 200, 100),
        _launch(t0 + 20, 10 * j + 1), _kernel(t0 + 22, 30, 10 * j + 1),
        _launch(t0 + 40, 10 * j + 2), _kernel(t0 + 52, 10, 10 * j + 2),
        _launch(t0 + 70, 10 * j + 3), _kernel(t0 + 72, 5, 10 * j + 3),
        _launch(t0 + 210, 10 * j + 4), _kernel(t0 + 220, 25, 10 * j + 4),
        _launch(t0 + 250, 10 * j + 5), _kernel(t0 + 255, 15, 10 * j + 5)]


@pytest.fixture(scope="module")
def ctx(tmp_path_factory):
    """The cell's context on a tiny copy of the benchmark."""
    root = _tiny(tmp_path_factory.mktemp("bench"))
    bench = catalog.benchmark(root)
    here = root / "h100bench"
    w = catalog.workload(bench, CELL)
    return Ctx(CELL, 2500000101, catalog.config(bench, w["config"], root),
               catalog.traffic(w["traffic"], here), "cpu", str(root))


def _tiny(dest):
    root = tiny.make(dest)
    p = root / "h100bench" / "configs" / "icosphere5_256_refinit.json"
    c = json.loads(p.read_text())
    c.update(tiny.TINY["icosphere5_256"])
    c["levelset"] = dict(c["levelset"], init_mode="reference")
    p.write_text(json.dumps(c))
    return root


def _run(ctx, events=EVENTS):
    tr = trace.Trace(events)
    win = tr.span("h100bench.window")
    return Run(ctx, [{"units": 1, "pool": 0}, {"units": 1, "pool": 1}], 1.0,
               {}, 0.0, tr, win.ts, win.end)


def _read(name, run):
    return catalog.metric(name).read(run)


def test_readers(ctx, monkeypatch):
    monkeypatch.setattr(profiling, "_counters", {"reinit.steps": 8})
    run = _run(ctx)
    assert _read("refinit.init_ms", run) == pytest.approx(0.045)
    assert _read("refinit.reinit_ms_per_step", run) == pytest.approx(
        0.080 / 8)
    assert _read("refinit.reinit_idle_share", run) == pytest.approx(60.0)
    from h100bench import jobs
    soups, _ = jobs.soups(ctx)
    c = ctx.config
    want = sum(k9.bound_s(*k9.sizes(soups[k], c["dx"], c["pad_cells"]))
               for k in (0, 1)) / 80e-6 * 100.0
    assert _read("k9_roofline", run) == pytest.approx(want)


@pytest.mark.parametrize("name", READERS)
def test_readers_none_without_their_span_or_counter(ctx, monkeypatch,
                                                    name):
    """A program without the reference init's spans and the dense reinit's
    counter, as before this cell, reports nothing, and raises nothing."""
    monkeypatch.setattr(profiling, "_counters", {})
    bare = [e for e in EVENTS if not e["name"].startswith(
        ("lsf.init.reference", "lsf.reinit"))]
    assert _read(name, _run(ctx, bare)) is None
    r = _run(ctx)
    r.trace = None
    assert _read(name, r) is None
    if name == "refinit.reinit_ms_per_step":
        assert _read(name, _run(ctx)) is None   # the span but no counter


def test_cell_runs_on_a_tiny_copy(tmp_path):
    """The cell's entry, check and readers on the CPU: correct, with its
    end-to-end metrics, traced and not."""
    from h100bench import run
    root = _tiny(tmp_path)
    res = run.measure(CELL, 2500000103, 0.2, False, device="cpu", root=root)
    assert res["correct"], res["checks"]
    assert {"mesh_s", "setup_s"} <= set(res["metrics"])
    assert all(c["value"] == 0.0 for c in res["checks"].values())
    res = run.measure(CELL, 2500000104, 0.2, True, device="cpu", root=root)
    assert res["correct"], res["checks"]


def test_reference_and_entry_load_no_jax():
    """The plain reference and K9's count load nothing of either package;
    the entry loads the port and no JAX."""
    from h100bench.tests.test_h100bench_imports import JAX, _loaded
    top = _loaded("import h100bench.reference.refinit, h100bench.roofline.k9")
    assert not top & (JAX | {"levelsetfortran_tpu_torch"})
    top = _loaded("from h100bench import catalog\n"
                  "catalog.entry('run_refinit')")
    assert "levelsetfortran_tpu_torch" in top and not top & JAX
