"""The trace arithmetic on a synthetic timeline."""

import pytest

from h100bench import readers, trace
from h100bench.run import Run


def _x(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


EVENTS = [
    _x("user_annotation", "h100bench.window", 0, 100),
    _x("user_annotation", "h100bench.job", 0, 50),
    _x("user_annotation", "h100bench.job", 50, 50),
    _x("cpu_op", "aten::item", 20, 10),
    _x("cpu_op", "read", 60, 25),
    _x("cpu_op", "inner", 62, 5),
    _x("kernel", "void k_a<1>(float*)", 5, 10, tid=7, corr=1),
    _x("kernel", "(anonymous namespace)::k_b(float*)", 12, 8, tid=7,
       corr=2),
    _x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 40, 5, tid=7),
    _x("kernel", "void k_a<1>(float*)", 90, 5, tid=7, corr=3),
    _x("gpu_user_annotation", "h100bench.job", 0, 100, tid=7),
]


def test_busy_and_gaps():
    tr = trace.Trace(EVENTS)
    # kernels 5-15 and 12-20 merge to 5-20; 40-45; 90-95
    assert trace.busy_s(tr, 0, 100) == pytest.approx(25e-6)
    assert trace.gaps(tr, 0, 100) == [(0, 5), (20, 40), (45, 90),
                                      (95, 100)]
    assert trace.busy_s(tr, 10, 42) == pytest.approx(12e-6)


def test_idle_share():
    tr = trace.Trace(EVENTS)
    run = Run(None, [], 1.0, {}, 0.0, tr, 0.0, 100.0)
    assert readers.idle_share(run) == pytest.approx(75.0)
    run.trace = None
    assert readers.idle_share(run) is None


def test_idle_gaps_by_host_activity():
    tr = trace.Trace(EVENTS)
    got = dict(trace.idle_gaps(tr, 0, 100))
    # 0-5 and 95-100: the job spans; 20-40 (mid 30): aten::item, which
    # ends there; 45-90 (mid 67.5): inside "read", not "inner"
    assert got["read"] == pytest.approx(45e-6)
    assert got["aten::item"] == pytest.approx(20e-6)
    assert got["h100bench.job"] == pytest.approx(10e-6)
    assert sum(got.values()) == pytest.approx(75e-6)


def test_top_ops_and_names():
    tr = trace.Trace(EVENTS)
    top = dict(trace.top_device_ops(tr, 0, 100))
    assert top["k_a"] == pytest.approx(15e-6)
    assert top["k_b"] == pytest.approx(8e-6)
    assert top["Memcpy DtoH"] == pytest.approx(5e-6)
    assert [k.corr for k in tr.kernels_in(0, 50, "k_a")] == [1]


def test_job_spans_in_order():
    tr = trace.Trace(EVENTS)
    run = Run(None, [{"n": 0}, {"n": 1}], 1.0, {}, 0.0, tr, 0.0, 100.0)
    got = [(r["n"], sp.ts) for r, sp in run.job_spans()]
    assert got == [(0, 0.0), (1, 50.0)]
