"""A run with the timed path broken underneath reads ``correct`` false,
for each fault a cell can have, and so does the control: the program's
own bfloat16 path in place of float32.  On the CPU, at tiny sizes, with
the look for a card skipped."""

import pytest
import torch

from levelsetfortran_tpu_torch.ops import minmax_cuda, weno_cuda
from levelsetfortran_tpu_torch.pipeline import batch as batch_mod
from levelsetfortran_tpu_torch.pipeline import differentiable
from levelsetfortran_tpu_torch.pipeline import run as run_mod

from h100bench import catalog, control, run


def _unchanged(p, *args, out=None, with_rms=False, **kw):
    """A step that returns its state unchanged."""
    out = p.clone() if out is None else out.copy_(p)
    if not with_rms:
        return out
    return out, torch.zeros(p.shape[:-3], dtype=torch.float64)


def _shifted(fn):
    """The advection, every node moved a quarter cell off its answer."""
    def moved(phi, grid, positions, dx, **kw):
        res = fn(phi, grid, positions, dx, **kw)
        return res._replace(positions=res.positions + 0.25 * dx)
    return moved


def _half_left_out(fn):
    """The packed step with the back half of the batch never stepped."""
    def half(p, sign, dx, h, live, **kw):
        live = live.clone()
        live[live.shape[0] // 2:] = 0
        return fn(p, sign, dx, h, live, **kw)
    return half


def _brighter(fn):
    def render(*a, **kw):
        out = fn(*a, **kw)
        return out._replace(image=out.image * 1.01)
    return render


FAULTS = {
    "icosphere5_256.run": {
        "minmax step unchanged": (minmax_cuda, "minmax_fusedk", _unchanged),
        "reinit step unchanged": (weno_cuda, "reinit_step", _unchanged),
        "nodes altered": (run_mod, "advect_nodes",
                          _shifted(run_mod.advect_nodes))},
    "twocube10_dx05.batch8": {
        "minmax step unchanged": (minmax_cuda, "minmax_step_packed",
                                  _unchanged),
        "half the batch left out": (
            weno_cuda, "reinit_step_packed",
            _half_left_out(weno_cuda.reinit_step_packed)),
        "nodes altered": (batch_mod, "advect_nodes",
                          _shifted(batch_mod.advect_nodes))},
    "icosphere5_256.grad": {
        "reinit step unchanged": (weno_cuda, "reinit_step", _unchanged),
        "image altered": (differentiable, "render",
                          _brighter(differentiable.render))},
}
CASES = [(c, f) for c in FAULTS for f in FAULTS[c]]


def test_sound_runs_are_correct(tiny_root):
    for cell in FAULTS:
        res = run.measure(cell, 77, 0.2, False, device="cpu", root=tiny_root)
        assert res["correct"], (cell, res["checks"])


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_reads_incorrect(tiny_root, monkeypatch, cell, fault):
    mod, name, bad = FAULTS[cell][fault]
    monkeypatch.setattr(mod, name, bad)
    res = run.measure(cell, 78, 0.2, False, device="cpu", root=tiny_root)
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("cell", sorted(FAULTS))
def test_control_reads_incorrect(tiny_root, cell):
    got = control.readings(cell, [79], ["bfloat16"], device="cpu",
                           root=tiny_root)
    limits = catalog.limits(cell, tiny_root / "h100bench")
    correct, checks = run.verdict(got[0]["numbers"], limits)
    assert correct is False, checks
