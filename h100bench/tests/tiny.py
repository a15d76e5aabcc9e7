"""A copy of the benchmark at sizes a CPU test run holds: the same files,
with each configuration's body and spacing made small."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

#: Iteration caps that keep a tiny mesh to a second or so.
CAPS = {"reinit_iters": 36, "minmax_iters": 200, "advect_iters": 50,
        "final_reinit_iters": 18}
#: Per configuration: the small body and spacing.
TINY = {
    "icosphere5_256": dict(body={"generator": "icosphere", "subdivisions": 1,
                             "radius": 1.0},
                       dx=0.12, pad_cells=6, grad_grid_points=24,
                       levelset=CAPS),
    "twocube10_dx05": dict(body={"generator": "two_cubes", "spacing": 3.0,
                                 "size": 1.0, "subdiv": 1},
                           dx=0.15, pad_cells=6, levelset=CAPS),
}


def make(dest: Path, pool: int = 4, batch: int = 2) -> Path:
    """A tiny copy of the benchmark under ``dest``: its root, with
    ``BENCHMARK.json`` and ``h100bench/``."""
    dest.mkdir(parents=True, exist_ok=True)
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(ROOT / "h100bench", dest / "h100bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for name, over in TINY.items():
        p = dest / "h100bench" / "configs" / f"{name}.json"
        c = json.loads(p.read_text())
        c.update(over)
        p.write_text(json.dumps(c))
    for p in (dest / "h100bench" / "traffic").glob("*.json"):
        t = json.loads(p.read_text())
        t["pool"] = pool
        if "batch" in t:
            t["batch"] = batch
        if "image" in t:
            t.update(image=8, reinit_steps=3, minmax_steps=2)
        p.write_text(json.dumps(t))
    return dest
