"""The reader of the ``.vti`` writer's counters: the share of writes whose
field the host had to transpose, 0.0 where the counter is present at 0,
and None on a program that does not count its writes."""

import pytest

from h100bench.tests.test_h100bench_spans import _read, _run
from levelsetfortran_tpu_torch.utils import profiling


@pytest.mark.parametrize("counts, share", [
    ({"vti.writes": 2, "vti.host_transposes": 0}, 0.0),
    ({"vti.writes": 4, "vti.host_transposes": 1}, 0.25),
    ({"vti.writes": 0, "vti.host_transposes": 0}, None),
    # an older program, which does not count its writes
    ({"init.pairs": 30, "init.points": 4}, None),
])
def test_vti_host_transpose_share(monkeypatch, counts, share):
    """0.0 where every write found its field in the payload's order and
    the counter is present at 0; None without the counters."""
    monkeypatch.setattr(profiling, "_counters", dict(counts))
    run = _run()
    assert _read("vti.host_transpose_share", run) == pytest.approx(share)
    run.trace = None
    assert _read("vti.host_transpose_share", run) is None


def test_vti_share_absent_from_the_program(monkeypatch):
    """A program without ``counters()`` (an older version) reads None."""
    monkeypatch.delattr(profiling, "counters")
    assert _read("vti.host_transpose_share", _run()) is None
