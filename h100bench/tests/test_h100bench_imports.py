"""Nothing the benchmark runs loads JAX or the JAX package; the reference
loads nothing of the program either.  Top-level names are compared whole:
``levelsetfortran_tpu_torch`` is the port, not the JAX package."""

import json
import subprocess
import sys
import types
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
JAX = {"jax", "jaxlib", "flax", "levelsetfortran_tpu"}


def _loaded(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\nprint(json.dumps("
         "sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_the_port_and_no_jax():
    top = _loaded("import h100bench.run, h100bench.control\n"
                  "from h100bench import catalog\n"
                  "for n in ('run', 'batch', 'grad'): catalog.entry(n)\n"
                  "b = catalog.benchmark()\n"
                  "for m in b['end_to_end'] + b['per_layer']:\n"
                  "    catalog.metric(m['name'])")
    assert "levelsetfortran_tpu_torch" in top
    assert not top & JAX


def test_reference_loads_nothing_of_the_program():
    top = _loaded("import h100bench.reference.pipeline, "
                  "h100bench.roofline.k7, h100bench.compare")
    assert not top & (JAX | {"levelsetfortran_tpu_torch"})


def test_forbidden_compares_whole_names(monkeypatch):
    from h100bench import run
    monkeypatch.setitem(sys.modules, "levelsetfortran_tpu_torch_x", sys)
    assert "levelsetfortran_tpu_torch_x" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "levelsetfortran_tpu.ops", sys)
    assert run.forbidden_modules() == ["levelsetfortran_tpu.ops"]


def test_no_card_no_result():
    pytest.importorskip("torch")
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would measure it")
    out = subprocess.run(
        [sys.executable, "-m", "h100bench.run", "--workload",
         "icosphere5_256.run", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 2 and out.stdout.strip() == ""


@pytest.mark.parametrize("where", [None, "reference", "metric"])
def test_jax_loaded_after_the_window_prints_no_result(
        tiny_root, monkeypatch, capsys, where):
    """JAX loaded by the reference's check or by a metric's reader, both
    after the window, still stops the run: exit 3 and no result."""
    from h100bench import catalog, run
    from h100bench.reference import pipeline as ref

    def loading(fn):
        def wrapped(*a, **kw):
            monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
            return fn(*a, **kw)
        return wrapped

    if where == "reference":
        monkeypatch.setattr(ref, "run_mesh", loading(ref.run_mesh))
    elif where == "metric":
        found = catalog.metric
        monkeypatch.setattr(catalog, "metric", lambda *a: (
            types.SimpleNamespace(read=loading(found(*a).read))))
    rc = run.main(["--workload", "icosphere5_256.run", "--seed", "3",
                   "--seconds", "0.2", "--trace", "0"], device="cpu",
                  root=tiny_root)
    out = capsys.readouterr()
    if where is None:
        assert rc == 0 and json.loads(out.out.splitlines()[-1])["correct"]
    else:
        assert rc == 3 and out.out.strip() == ""
        assert "jax" in out.err
