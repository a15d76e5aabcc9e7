"""Every part of every cell is found by its name, and a new cell, traffic
mix and metric need only new files and entries."""

import hashlib
import json
import shutil

import pytest

from h100bench import catalog

BENCH = catalog.benchmark()
METRICS = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_config_resolves(name):
    c = catalog.config(BENCH, name)
    assert c["name"] == name
    assert {"body", "dx", "pad_cells", "reduced", "assumed"} <= set(c)
    entry = next(e for e in BENCH["configs"] if e["name"] == name)
    assert entry["reduced"] == c["reduced"]
    assert entry["file"].startswith(BENCH["paths"][0] + "/")


@pytest.mark.parametrize("name", sorted({w["traffic"]
                                         for w in BENCH["workloads"]}))
def test_traffic_resolves(name):
    t = catalog.traffic(name)
    assert int(t["pool"]) > 0
    assert hasattr(catalog.entry(t["entry"]), "Entry")


@pytest.mark.parametrize("name", METRICS)
def test_metric_resolves(name):
    assert callable(catalog.metric(name).read)


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves(name):
    w = catalog.workload(BENCH, name)
    lim = catalog.limits(name)
    assert lim and all(v is not None and v >= 0 for v in lim.values())
    reported = catalog.metrics_of(BENCH, name, False)
    assert "setup_s" in {m["name"] for m in reported}
    assert len(reported) >= 2
    assert catalog.metrics_of(BENCH, name, True)
    assert w["chips"] == 1


@pytest.mark.parametrize("name", ["k7", "k5"])
def test_roofline_resolves(name):
    import importlib
    mod = importlib.import_module(f"h100bench.roofline.{name}")
    assert callable(mod.bound_s) and mod.KERNELS


def _digest(root):
    h = hashlib.sha256()
    for p in sorted(root.rglob("*")):
        if p.is_file() and "__pycache__" not in p.parts:
            h.update(str(p.relative_to(root)).encode())
            h.update(p.read_bytes())
    return h.hexdigest()


def test_new_cell_needs_only_new_files(tiny_root, tmp_path):
    """A throwaway configuration, traffic mix, metric and cell, added as
    files and entries: the runner finds and reports them, and no file that
    was there changes."""
    from h100bench import run
    root = tmp_path / "copy"
    shutil.copytree(tiny_root, root)
    here = root / "h100bench"
    before = _digest(here)
    (here / "configs" / "cubes_tiny.json").write_text(json.dumps(dict(
        name="cubes_tiny", body={"generator": "two_cubes", "spacing": 1.0,
                               "size": 1.2, "subdiv": 2},
        dx=0.15, pad_cells=5, levelset={
            "reinit_iters": 18, "minmax_iters": 40, "advect_iters": 20,
            "final_reinit_iters": 9}, assumed=[], reduced=[])))
    (here / "traffic" / "run_pair.json").write_text(json.dumps(dict(
        entry="run", pool=2, scale=[0.99, 1.01], rotate_deg=30.0)))
    (here / "metrics" / "jobs_done.py").write_text(
        "def read(run):\n    return float(len(run.records))\n")
    (here / "limits" / "cubes_tiny.run_pair.json").write_text(json.dumps(
        catalog.limits("icosphere5_256.run")))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(
        name="cubes_tiny", source="https://example.org/cubes",
        file="h100bench/configs/cubes_tiny.json", reduced=[], why="test"))
    bench["workloads"].append(dict(name="cubes_tiny.run_pair",
                                   config="cubes_tiny", traffic="run_pair",
                                   chips=1, why="test"))
    bench["per_layer"].append(dict(
        name="jobs_done", unit="jobs", better="higher",
        source="program_counter", layer="pipeline/run.py", moves="mesh_s",
        workloads=["cubes_tiny.run_pair"]))
    bench["end_to_end"][0]["workloads"].append("cubes_tiny.run_pair")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    res = run.measure("cubes_tiny.run_pair", 5, 0.2, False, device="cpu",
                      root=root)
    assert res["correct"], res["checks"]
    assert {"mesh_s", "setup_s"} <= set(res["metrics"])
    res = run.measure("cubes_tiny.run_pair", 6, 0.2, True, device="cpu",
                      root=root)
    assert res["metrics"]["jobs_done"]["value"] >= 1
    added = {"configs/cubes_tiny.json", "traffic/run_pair.json",
             "metrics/jobs_done.py", "limits/cubes_tiny.run_pair.json"}
    for rel in added:
        (here / rel).unlink()
    assert _digest(here) == before
