"""The port's spans and counters (``utils/profiling.py``: ``span``,
``count``, ``counters``, ``trace``) on the CPU, on small analytic meshes.

Under a profiler session the three entry points a user calls (``run``
with its outputs, ``run_batch`` of two geometries, and
``image_loss_and_vertex_grad``) leave in the Chrome trace the spans of
each layer, each inside its parent, and count the init's pairs and points
and the batch's steps and host reads.  With no session recording, no
``record_function`` is entered and nothing is counted, and the outputs
are bitwise the same either way.
"""

import glob
import json
import logging
import math
import os

import numpy as np
import pytest
import torch

import levelsetfortran_tpu_torch as lsf
from levelsetfortran_tpu_torch.config import LevelSetConfig
from levelsetfortran_tpu_torch.grid.grid import Grid3D
from levelsetfortran_tpu_torch.io.stl import write_stl
from levelsetfortran_tpu_torch.models import analytic
from levelsetfortran_tpu_torch.ops import init_sign
from levelsetfortran_tpu_torch.ops.init_cuda import pack_rows
from levelsetfortran_tpu_torch.utils import logging as lsf_logging
from levelsetfortran_tpu_torch.utils import profiling

torch.set_num_threads(1)
CONFIG = LevelSetConfig(dx=0.12, pad_cells=10, reinit_iters=15,
                        minmax_iters=5, advect_iters=3, device="cpu")
KW = dict(eye=(0.0, -3.0, 0.0), target=(0.0, 0.0, 0.0), reinit_steps=4,
          minmax_steps=2, height=10, width=10, n_march_steps=32)

#: (child, parent) of every span each entry point leaves.
INIT = [("lsf.init.pack_rows", "lsf.init"), ("lsf.init.select", "lsf.init"),
        ("lsf.init.exact", "lsf.init")]
CULLED = [("lsf.init.culling", "lsf.init"),
          ("lsf.init.culling.parents", "lsf.init.culling"),
          ("lsf.init.culling.blocks", "lsf.init.culling"),
          ("lsf.init.culling.buckets", "lsf.init.culling")]
NESTING = {
    "run": [("lsf.read_stl", None)] + [
        (c, "lsf.run_mesh") for c in (
            "lsf.run_mesh.grid", "lsf.init", "lsf.reinit_narrowband",
            "lsf.minmax_narrowband", "lsf.advect", "lsf.run_mesh.asym",
            "lsf.run_mesh.to_host", "lsf.run_mesh.write")] + INIT + CULLED + [
        ("lsf.write_vti", "lsf.run_mesh.write"),
        ("lsf.write_s3d", "lsf.run_mesh.write")],
    "batch": [(c, "lsf.run_batch") for c in (
        "lsf.run_batch.load", "lsf.run_batch.init", "lsf.batched_solve",
        "lsf.run_batch.advect", "lsf.run_batch.to_host",
        "lsf.run_batch.write")] + INIT + CULLED + [
        ("lsf.read_stl", "lsf.run_batch.load"),
        ("lsf.init", "lsf.run_batch.init"),
        ("lsf.advect", "lsf.run_batch.advect"),
        ("lsf.write_vti", "lsf.run_batch.write"),
        ("lsf.write_s3d", "lsf.run_batch.write")],
    "grad": [(c, "lsf.render_from_vertices") for c in (
        "lsf.init", "lsf.reinit_fixed", "lsf.minmax_fixed", "lsf.render")]
    + INIT + [(c, "lsf.vertex_grad") for c in (
        "lsf.reinit_fixed.backward", "lsf.minmax_fixed.backward",
        "lsf.render.backward")],
}


def _octahedron(scale=0.7):
    v = scale * np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                          [0, 0, 1], [0, 0, -1]], np.float64)
    f = np.array([[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4],
                  [2, 0, 5], [1, 2, 5], [3, 1, 5], [0, 3, 5]], np.int32)
    return v, f


def _case(name, tmp):
    """A callable running one entry point, returning its outputs as a list
    of tensors and arrays."""
    if name == "grad":
        v, f = _octahedron()
        n, half = 20, 1.2
        grid = Grid3D(shape=(n,) * 3, origin=(-half,) * 3,
                      dx=2 * half / (n - 1))
        vt = torch.tensor(v, dtype=torch.float32)

        def go():
            return list(lsf.image_loss_and_vertex_grad(
                vt, f, grid, torch.zeros((10, 10)), **KW))
        return go
    paths = []
    for i, m in enumerate([analytic.icosphere_mesh(radius=0.5,
                                                   subdivisions=1),
                           analytic.box_mesh(half_extent=(0.5, 0.4, 0.3))]):
        paths.append(os.path.join(tmp, f"m{i}.stl"))
        write_stl(paths[-1], m)
    if name == "run":
        def go():
            r = lsf.run(paths[0], CONFIG, out_dir=os.path.join(tmp, "o"))
            return [r.phi_init, r.phi_smoothed, r.phi_final, r.advected]
        return go

    def go():
        items = lsf.run_batch(paths, CONFIG, write_outputs=True,
                              out_dir=os.path.join(tmp, "b"))
        go.iters = ([it.reinit_iters for it in items],
                    [it.minmax_iters for it in items])
        return [x for it in items
                for x in (it.phi_init, it.phi_smoothed, it.advected)]
    return go


def _spans(logdir):
    (path,) = glob.glob(os.path.join(logdir, "*.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("cat") == "user_annotation"
            and e.get("ph") == "X"]


@pytest.fixture(scope="module", params=sorted(NESTING))
def recorded(request, tmp_path_factory):
    """One case run twice: first with no session and
    ``torch.profiler.record_function`` made to count its entries, then
    under ``profiling.trace``."""
    tmp = str(tmp_path_factory.mktemp(request.param))
    go = _case(request.param, tmp)
    entered = []

    def counting(*a, **k):
        entered.append(a)
        raise AssertionError("record_function entered with no session")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.profiler, "record_function", counting)
        mp.setattr(profiling, "_counters", {})
        plain = go()
        quiet = profiling.counters()
    logdir = os.path.join(tmp, "trace")
    with profiling.trace(logdir):
        traced = go()
        counts = profiling.counters()
    return dict(name=request.param, go=go, plain=plain, traced=traced,
                entered=entered, quiet=quiet, counts=counts,
                spans=_spans(logdir))


def test_spans_nest(recorded):
    """Every span of the case is there, each inside a span of its
    parent's name on its thread."""
    spans = recorded["spans"]
    names = {e["name"] for e in spans}
    for child, parent in NESTING[recorded["name"]]:
        assert child in names, child
        if parent is None:
            continue
        parents = [p for p in spans if p["name"] == parent]
        for c in (e for e in spans if e["name"] == child):
            assert any(p["tid"] == c["tid"] and p["ts"] <= c["ts"]
                       and c["ts"] + c["dur"] <= p["ts"] + p["dur"]
                       for p in parents), (child, parent)


def test_quiet_without_a_session(recorded):
    """With no session recording no span enters a ``record_function`` and
    nothing is counted; under one the init counts its points."""
    assert recorded["entered"] == [] and recorded["quiet"] == {}
    assert recorded["counts"]["init.points"] > 0


def test_outputs_bitwise_with_and_without_a_session(recorded):
    for a, b in zip(recorded["plain"], recorded["traced"], strict=True):
        a, b = (torch.as_tensor(x) for x in (a, b))
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("recorded", ["batch"], indirect=True)
def test_batch_counts_one_read_per_step(recorded):
    """One host read of the (B,) RMS vector per packed step, in each of
    the two packed solves."""
    reinit_iters, minmax_iters = recorded["go"].iters
    c = recorded["counts"]
    assert (c["batch.host_reads"] == c["batch.steps"]
            == max(reinit_iters) + max(minmax_iters))
    assert sum(e["name"] == "lsf.batched_solve"
               for e in recorded["spans"]) == 2


@pytest.mark.parametrize("culling", [None, "auto"])
def test_init_pairs(culling, tmp_path):
    """``init.pairs`` counts the (point, candidate) pairs of the selection
    scan: points times triangles with no culling (a grid of whole 16^3
    blocks), the packed rows' candidates times 16^3 with one."""
    m = analytic.icosphere_mesh(radius=0.5, subdivisions=1)
    grid = Grid3D(shape=(48, 32, 32), origin=(-0.72, -0.48, -0.48),
                  dx=0.03)
    with profiling.trace(str(tmp_path)):
        init_sign.signed_distance_init(grid, m.vertices, m.elements,
                                       culling=culling)
        got = profiling.counters()
    points = math.prod(grid.shape)
    if culling is None:
        want = points * m.n_elems
    else:
        c = init_sign.build_init_culling(grid, m.vertices, m.elements,
                                         tile=512)
        rows = pack_rows(c.cands, c.bidxs, m.n_elems)
        want = rows.pairs_per_point * 16 ** 3
        assert want < points * m.n_elems
    assert got == {"init.pairs": want, "init.points": points}


def test_span_and_count_follow_the_session(tmp_path):
    """``span`` is one shared null context and ``count`` does nothing
    outside a session; inside one they record, and ``trace`` starts the
    counters from zero and logs them at its end."""
    assert profiling.span("a") is profiling.span("b")
    before = profiling.counters()
    profiling.count("x", 3)
    assert profiling.counters() == before
    logdir = str(tmp_path)
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    lsf_logging.logger.addHandler(handler)
    old = lsf_logging.logger.level
    lsf_logging.logger.setLevel(logging.INFO)
    try:
        with profiling.trace(logdir):
            assert profiling.counters() == {}
            with profiling.span("lsf.test"):
                profiling.count("x", 3)
                profiling.count("x")
    finally:
        lsf_logging.logger.removeHandler(handler)
        lsf_logging.logger.setLevel(old)
    assert profiling.counters() == {"x": 4}
    assert [e["name"] for e in _spans(logdir)] == ["lsf.test"]
    logged = [json.loads(r.getMessage()) for r in records]
    assert [e["counters"] for e in logged if e["stage"] == "counters"] == [
        {"x": 4}]


def test_log_event_builds_nothing_when_info_is_off(monkeypatch):
    """``log_event`` returns before building its JSON where the logger
    drops INFO records, and still builds one where it keeps them."""
    calls = []
    monkeypatch.setattr(lsf_logging.json, "dumps",
                        lambda *a, **k: calls.append(a) or "{}")
    logger, old = lsf_logging.logger, lsf_logging.logger.level
    try:
        logger.setLevel(logging.WARNING)
        lsf_logging.log_event("timer", name="a", seconds=1.0)
        lsf_logging.StageTimer().mark("b")
        assert calls == []
        logger.setLevel(logging.INFO)
        lsf_logging.log_event("timer", name="a", seconds=1.0)
        assert len(calls) == 1
    finally:
        logger.setLevel(old)
