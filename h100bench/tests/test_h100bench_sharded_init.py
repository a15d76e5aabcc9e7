"""The readers of the sharded init (``sharded.init_s``,
``sharded.init_overlap``) on a synthetic timeline: the blocks' spans on
one host thread, their operations on four cards ending at different
times; None without the span or the counters."""

import pytest

from levelsetfortran_tpu_torch.utils import profiling

from h100bench import catalog, trace
from h100bench.run import Run

CELL = "icosphere5_512.sharded4"
READERS = ("sharded.init_s", "sharded.init_overlap")
MAIN, OTHER = 1, 2
CARDS = (10, 11, 12, 13)


def _x(cat, name, ts, dur, tid=MAIN, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _block(ts, dur):
    return _x("user_annotation", "lsf.sharded.init.block", ts, dur)


def _op(launch, start, dur, corr, card, tid=MAIN):
    return [_x("cuda_runtime", "cudaLaunchKernel", launch, 2, tid, corr),
            _x("kernel", f"k{corr}", start, dur, CARDS[card], corr)]


# job 1 (0-1000): four blocks enqueued 100-180, each card's scan runs
# after its launch, card 2's ends last at 600; a kernel launched after
# the blocks (the solvers, 700) and one launched inside a block's
# interval from another thread do not count.  Job 2 (1000-2000): the
# blocks in turn, each card's work ending before the next block starts;
# a copy (no kernel) ends last.
EVENTS = [
    _x("user_annotation", "h100bench.window", 0, 2000),
    _x("user_annotation", "h100bench.job", 0, 1000),
    _x("user_annotation", "h100bench.job", 1000, 1000),
    _x("user_annotation", "lsf.sharded.init", 90, 100),
    _block(100, 20), _block(120, 20), _block(140, 20), _block(160, 20),
    *_op(105, 110, 300, 1, 0), *_op(125, 130, 380, 2, 1),
    *_op(145, 150, 450, 3, 2), *_op(165, 170, 200, 4, 3),
    *_op(150, 155, 900, 5, 3, tid=OTHER),
    *_op(700, 705, 50, 6, 0),
    _x("user_annotation", "lsf.sharded.init", 1090, 400),
    _block(1100, 100), _block(1200, 100), _block(1300, 100),
    _block(1400, 100),
    *_op(1105, 1110, 80, 7, 0), *_op(1205, 1210, 80, 8, 1),
    *_op(1305, 1310, 80, 9, 2),
    _x("cuda_runtime", "cudaMemcpyAsync", 1405, 2, MAIN, 10),
    _x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 1410, 120,
       CARDS[3], 10),
]


def _run(events=EVENTS):
    tr = trace.Trace(events)
    win = tr.span("h100bench.window")
    return Run(None, [{"units": 1}, {"units": 1}], 2.0, {}, 0.0, tr,
               win.ts, win.end)


def _read(name, r):
    return catalog.metric(name).read(r)


def test_init_seconds_span_start_to_last_device_end():
    # job 1: 100 .. 150 + 450 = 600; job 2: 1100 .. 1410 + 120 = 1530
    r = _run()
    per_job = catalog.metric("sharded.init_s").seconds_per_job(
        r, "lsf.sharded.init.block")
    assert per_job == pytest.approx([500e-6, 430e-6])
    assert _read("sharded.init_s", r) == pytest.approx(465e-6)


def test_init_seconds_none_for_a_job_without_blocks():
    """A job with no block span (or none of its operations) reads None
    and drops out of the mean."""
    r = _run([e for e in EVENTS if not (
        e["name"] == "lsf.sharded.init.block" and e["ts"] >= 1000)])
    per_job = catalog.metric("sharded.init_s").seconds_per_job(
        r, "lsf.sharded.init.block")
    assert per_job == pytest.approx([500e-6, None])
    assert _read("sharded.init_s", r) == pytest.approx(500e-6)


@pytest.mark.parametrize("counts, share", [
    ({"sharded.init_blocks": 40, "sharded.init_overlapped": 30}, 0.75),
    ({"sharded.init_blocks": 40, "sharded.init_overlapped": 0}, 0.0),
    ({"sharded.init_blocks": 0, "sharded.init_overlapped": 0}, None),
    ({"sharded.init_blocks": 40}, None),
    ({}, None),
])
def test_overlap_share(monkeypatch, counts, share):
    monkeypatch.setattr(profiling, "_counters", dict(counts))
    assert _read("sharded.init_overlap", _run()) == pytest.approx(share)


@pytest.mark.parametrize("name", READERS)
def test_readers_none_without_their_span_or_counter(monkeypatch, name):
    """A program without the block spans and counters (the parent of this
    change) reports nothing, and raises nothing."""
    monkeypatch.setattr(profiling, "_counters", {})
    bare = [e for e in EVENTS if e["name"] != "lsf.sharded.init.block"]
    assert _read(name, _run(bare)) is None
    r = _run()
    r.trace = None
    assert _read(name, r) is None


def test_reported_in_the_sharded_cell_only():
    bench = catalog.benchmark()
    for cell in (w["name"] for w in bench["workloads"]):
        names = {m["name"] for m in catalog.metrics_of(bench, cell, True)}
        assert (set(READERS) <= names) == (cell == CELL), cell
