"""How a grid field becomes the host float64 array a result holds
(``pipeline/run.py:_host_field``): a field on a card passes through one
pinned float32 buffer, kept and reused across calls, and is widened from
there straight into the result; any other field takes
``.to("cpu", torch.float64)``.  Either way the values, the shape (x, y, z)
and the x-fastest strides are those of the plain ``.to``.

On the CPU the staging path runs with a plain tensor standing in for the
pinned allocation.  On the card (marker ``card``; skips without one) the
buffer is pinned and the values bitwise the plain copy's; run it with
``python -m pytest --noconftest -p no:cacheprovider -m card
tests/test_torch_host_handover.py``.
"""

import sys
import threading

import numpy as np
import pytest
import torch

from levelsetfortran_tpu_torch.config import LevelSetConfig
from levelsetfortran_tpu_torch.models import analytic
from levelsetfortran_tpu_torch.pipeline import run
from levelsetfortran_tpu_torch.utils import profiling

DTYPES = [torch.float32, torch.float64, torch.bfloat16]


def _plain(t) -> np.ndarray:
    """The old hand-over: one ``.to`` of the (x, y, z) field."""
    return t.detach().to("cpu", torch.float64).numpy()


def _bits(a: np.ndarray) -> bytes:
    """The values in logical (C) order, as raw bytes."""
    return a.tobytes(order="C")


def _field(shape, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g, dtype=torch.float64).to(dtype)


def _check(got: np.ndarray, t) -> None:
    want = _plain(t)
    assert got.dtype == np.float64 and got.shape == tuple(t.shape)
    assert got.transpose(2, 1, 0).flags.c_contiguous
    assert _bits(got) == _bits(want)


@pytest.fixture
def staged(monkeypatch):
    """The staging path on the CPU: every field staged, a plain tensor for
    the pinned allocation (the sizes asked for are recorded), and a fresh
    buffer slot."""
    asked = []

    def pinned(nbytes):
        asked.append(nbytes)
        return torch.empty(nbytes, dtype=torch.uint8)

    monkeypatch.setattr(run, "_staged", lambda t: True)
    monkeypatch.setattr(run, "_pinned", pinned)
    monkeypatch.setattr(run, "_staging", None)
    return asked


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(9, 6, 4), (1, 5, 3), (7, 1, 1)])
def test_cpu_route_is_the_plain_copy(monkeypatch, dtype, shape):
    def pinned(nbytes):
        raise AssertionError("a CPU field took the staging path")

    monkeypatch.setattr(run, "_pinned", pinned)
    t = _field(shape, dtype)
    assert not run._staged(t)
    _check(run._host_field(t), t)


@pytest.mark.parametrize("dtype", DTYPES)
def test_staged_values_are_the_plain_copy(staged, dtype):
    t = _field((9, 6, 4), dtype)
    _check(run._host_field(t), t)
    assert staged == [t.numel() * t.element_size()]


def test_staged_results_are_independent_and_the_buffer_reused(staged):
    a_t, b_t = _field((9, 6, 4), torch.float32, 1), _field(
        (9, 6, 4), torch.float32, 2)
    a = run._host_field(a_t)
    a_bits = _bits(a)
    buf = run._staging
    b = run._host_field(b_t)
    assert run._staging is buf and staged == [9 * 6 * 4 * 4]
    assert _bits(a) == a_bits and _bits(b) == _bits(_plain(b_t))
    assert not np.shares_memory(a, b)
    for r in (a, b):
        assert not np.shares_memory(r, buf.numpy())
    # a smaller field reuses the buffer, a larger one regrows it
    small = _field((3, 6, 4), torch.float32, 3)
    _check(run._host_field(small), small)
    assert run._staging is buf
    big = _field((11, 7, 5), torch.float64, 4)
    _check(run._host_field(big), big)
    assert run._staging is not buf
    assert run._staging.numel() == 11 * 7 * 5 * 8
    assert staged == [9 * 6 * 4 * 4, 11 * 7 * 5 * 8]
    assert _bits(a) == a_bits


def test_staged_into_a_touched_result(staged):
    t = _field((9, 6, 4), torch.float32)
    out = run._host_array(t.shape)
    assert out.shape == t.shape and out.flags.f_contiguous
    assert not out.any()
    assert run._host_field(t, out) is out
    _check(out, t)


def test_run_mesh_staged_is_bitwise_the_cpu_route(monkeypatch):
    """``run_mesh`` with every field staged (its results' memory touched
    during the init) hands over the CPU route's fields, bit for bit."""
    mesh = analytic.icosphere_mesh(radius=0.5, subdivisions=1)
    cfg = LevelSetConfig(dx=0.12, pad_cells=6, reinit_iters=12,
                         minmax_iters=6, final_reinit_iters=4,
                         advect_iters=3, device="cpu")
    plain = run.run_mesh(mesh, cfg)
    asked = []
    monkeypatch.setattr(run, "_staged", lambda t: True)
    monkeypatch.setattr(run, "_pinned", lambda n: asked.append(n) or
                        torch.empty(n, dtype=torch.uint8))
    monkeypatch.setattr(run, "_staging", None)
    staged = run.run_mesh(mesh, cfg)
    assert asked == [plain.phi_init.size * 4]
    for name in ("phi_init", "phi_smoothed", "phi_final"):
        got, want = getattr(staged, name), getattr(plain, name)
        assert got.transpose(2, 1, 0).flags.c_contiguous
        assert got.shape == want.shape and _bits(got) == _bits(want)
    assert not np.shares_memory(staged.phi_init, staged.phi_smoothed)


def test_staged_from_many_threads_keeps_each_field(staged):
    """Threads that hand over fields at once (more than the cores, with a
    short switch interval) each get their own field's values: the one
    buffer is never shared by two hand-overs."""
    fields = [_field((9, 6, 4 + k % 3), torch.float32, k) for k in range(16)]
    got, errors = {}, []

    def hand_over(k):
        try:
            for _ in range(20):
                got[k] = run._host_field(fields[k])
                assert _bits(got[k]) == _bits(_plain(fields[k]))
        except AssertionError as e:
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=hand_over, args=(k,))
                   for k in range(len(fields))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert not errors and sorted(got) == list(range(len(fields)))


def test_staged_bytes_counted(staged):
    t = _field((9, 6, 4), torch.float32)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        profiling._counters.clear()
        run._host_field(t)
        run._host_field(t)
        got = profiling.counters()
    profiling._counters.clear()
    assert got == {"host.staged_bytes": 2 * 9 * 6 * 4 * 4}


def test_cpu_route_counts_nothing():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        profiling._counters.clear()
        run._host_field(_field((9, 6, 4), torch.float32))
        got = profiling.counters()
    profiling._counters.clear()
    assert got == {}


# ------------------------------ on the card ------------------------------

@pytest.fixture
def card(monkeypatch):
    """The card, with a fresh buffer slot."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the pinned staging runs for "
                    "fields on a card only")
    monkeypatch.setattr(run, "_staging", None)
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("dtype", DTYPES)
def test_card_values_bitwise_the_plain_copy_through_a_pinned_buffer(
        card, dtype):
    t = _field((64, 64, 64), dtype).to(card)
    got = run._host_field(t)
    _check(got, t)
    assert run._staging.is_pinned()
    assert run._staging.numel() >= t.numel() * t.element_size()
    assert not np.shares_memory(got, run._staging.numpy())


@pytest.mark.card
def test_card_buffer_reused_and_regrown(card):
    first = _field((64, 64, 64), torch.float32, 1).to(card)
    a = run._host_field(first)
    buf = run._staging
    b = run._host_field(_field((64, 64, 60), torch.float32, 2).to(card))
    assert run._staging is buf and _bits(a) == _bits(_plain(first))
    assert not np.shares_memory(a, b)
    big = _field((64, 64, 80), torch.float32, 3).to(card)
    _check(run._host_field(big), big)
    assert run._staging.numel() == 64 * 64 * 80 * 4
    assert run._staging.is_pinned()
