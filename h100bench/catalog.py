"""Finds every part of a cell by its name in ``BENCHMARK.json``.

A cell names a configuration (``configs/<name>.json``, the path that
``BENCHMARK.json`` gives) and a traffic mix (``traffic/<name>.json``); the
traffic names the entry that drives the program (``entries/<name>.py``).
Each metric is ``metrics/<name>.py``, each cell's correctness limits
``limits/<cell>.json``.  Adding a cell, a mix or a metric adds files and
entries; nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = HERE.parent) -> dict:
    return _json(root / "BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str, root: Path = HERE.parent) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return _json(root / c["file"])
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str, here: Path = HERE) -> dict:
    return _json(here / "traffic" / f"{name}.json")


def limits(cell: str, here: Path = HERE) -> dict:
    return _json(here / "limits" / f"{cell}.json")


def entry(name: str, here: Path = HERE):
    """The module that drives the program for one kind of job."""
    return _load(here / "entries" / f"{name}.py", "entry_" + name)


def metric(name: str, here: Path = HERE):
    """The reader of one metric: a module with ``read(run)``."""
    return _load(here / "metrics" / f"{name}.py", "metric_" + name)


def _load(path: Path, label: str):
    if not path.exists():
        raise KeyError(f"no file {path}")
    name = "h100bench._found." + label.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_of(bench: dict, cell: str, traced: bool) -> list:
    """The metric entries a cell reports: its end-to-end ones untraced,
    its per-layer ones traced.  A metric with a ``workloads`` key belongs
    to those cells; one without, to every cell that reports what it
    moves."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not traced:
        return e2e
    mine = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in mine
                             else [])]
