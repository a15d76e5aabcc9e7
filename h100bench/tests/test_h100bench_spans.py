"""The readers of the program's spans and counters on a synthetic
timeline: kernels tied to a span by their launch's correlation id on the
span's thread, the device's idle time inside spans, the two counter
ratios, and None wherever a span or counter is missing."""

import pytest

from h100bench import catalog, spans, trace
from h100bench.run import Run
from levelsetfortran_tpu_torch.utils import profiling

NEW = ("run.to_host_s", "init.pairs_per_point", "grad.fwd_ms",
       "grad.init_ms", "batch.solve_idle_share", "batch.host_reads_per_step")

MAIN, AUTOGRAD, DEV = 1, 2, 7


def _x(cat, name, ts, dur, tid=MAIN, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _span(name, ts, dur, tid=MAIN):
    return _x("user_annotation", name, ts, dur, tid)


def _launch(ts, corr, tid=MAIN):
    return _x("cuda_runtime", "cudaLaunchKernel", ts, 2, tid, corr)


def _kernel(ts, dur, corr):
    return _x("kernel", f"k{corr}", ts, dur, DEV, corr)


# job 1 (0-500): the forward on the main thread with the init inside it,
# the backward's span on the autograd thread; job 2 (500-1000): a packed
# solve and no forward
EVENTS = [
    _span("h100bench.window", 0, 1000),
    _span("h100bench.job", 0, 500),
    _span("h100bench.job", 500, 500),
    _span("lsf.render_from_vertices", 10, 190),
    _span("lsf.init", 20, 60),
    _span("lsf.run_mesh.to_host", 100, 50),
    _span("lsf.reinit_fixed.backward", 260, 140, tid=AUTOGRAD),
    _span("lsf.batched_solve", 600, 100),
    _span("lsf.run_mesh.to_host", 800, 100),
    _launch(30, 1), _kernel(35, 10, 1),
    _launch(100, 2), _kernel(105, 20, 2),
    _launch(250, 3), _kernel(255, 30, 3),
    _launch(300, 4, tid=AUTOGRAD), _kernel(305, 40, 4),
    # inside the forward's interval, but launched from another thread
    _launch(50, 5, tid=AUTOGRAD), _kernel(55, 7, 5),
    _launch(610, 6), _kernel(620, 20, 6),
    _x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 690, 30, DEV),
]


def _run(events=EVENTS):
    tr = trace.Trace(events)
    win = tr.span("h100bench.window")
    return Run(None, [{"units": 1}, {"units": 1}], 1.0, {}, 0.0, tr,
               win.ts, win.end)


def _read(name, run):
    return catalog.metric(name).read(run)


@pytest.mark.parametrize("name, per_job", [
    ("lsf.render_from_vertices", [0.030, None]),
    ("lsf.init", [0.010, None]),
    ("lsf.reinit_fixed.backward", [0.040, None]),
    ("lsf.batched_solve", [None, 0.020]),
])
def test_kernels_by_launch_on_the_span_thread(name, per_job):
    assert spans.kernel_ms_per_job(_run(), name) == pytest.approx(per_job)


def test_forward_and_init_readers():
    run = _run()
    assert _read("grad.fwd_ms", run) == pytest.approx(0.030)
    assert _read("grad.init_ms", run) == pytest.approx(0.010)


def test_span_seconds_per_job():
    run = _run()
    assert spans.seconds_per_job(run, "lsf.run_mesh.to_host") == \
        pytest.approx([50e-6, 100e-6])
    assert _read("run.to_host_s", run) == pytest.approx(75e-6)


def test_idle_share_clipped_to_spans():
    # inside 600-700 the kernel runs 620-640 and the copy 690-700
    run = _run()
    assert spans.idle_share_in(run, "lsf.batched_solve") == \
        pytest.approx(70.0)
    assert _read("batch.solve_idle_share", run) == pytest.approx(70.0)


@pytest.mark.parametrize("counts, pairs, reads", [
    ({"init.pairs": 2400, "init.points": 2, "batch.steps": 40,
      "batch.host_reads": 40}, 1200.0, 1.0),
    ({"init.pairs": 30, "init.points": 4, "batch.steps": 10,
      "batch.host_reads": 25}, 7.5, 2.5),
    ({"init.pairs": 5, "init.points": 0}, None, None),
    ({}, None, None),
])
def test_counter_ratios(monkeypatch, counts, pairs, reads):
    monkeypatch.setattr(profiling, "_counters", dict(counts))
    run = _run()
    assert _read("init.pairs_per_point", run) == pytest.approx(pairs)
    assert _read("batch.host_reads_per_step", run) == pytest.approx(reads)
    run.trace = None
    assert _read("init.pairs_per_point", run) is None


def test_counters_absent_from_the_program(monkeypatch):
    """A program without ``counters()`` (an older version) reads None."""
    monkeypatch.delattr(profiling, "counters")
    run = _run()
    assert _read("init.pairs_per_point", run) is None
    assert _read("batch.host_reads_per_step", run) is None


@pytest.mark.parametrize("name", NEW)
def test_missing_span_or_counter_reads_none(monkeypatch, name):
    """A cell that bypasses the layer, or a program without its spans and
    counters, reports nothing, not 0."""
    monkeypatch.setattr(profiling, "_counters", {})
    bare = [e for e in EVENTS if not e["name"].startswith("lsf.")]
    assert _read(name, _run(bare)) is None
    run = _run()
    run.trace = None
    assert _read(name, run) is None
