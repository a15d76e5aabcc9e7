"""One mesh at a time under the upstream's own init
(``init_mode="reference"``): the job of ``entries/run.py`` unchanged
(``read_stl``, ``run_mesh`` without writing, two ``write_vti`` and one
``write_s3d`` into ``os.devnull``).

Compared: the same numbers as ``run``'s, against
:func:`..reference.refinit.run_mesh`.  The count of points whose nearest
centroid float64 distances would change goes to standard error as a
reading; no limit bounds it.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

from h100bench import catalog, compare
from h100bench.reference import refinit

_RUN = catalog.entry("run", Path(__file__).resolve().parents[1])


class Entry(_RUN.Entry):

    def check(self, kept) -> dict:
        c = self.ctx.config
        dx = c["dx"]
        readings = []
        for _, (k, res) in kept:
            want = refinit.run_mesh(self.soups[k], dx, c["pad_cells"],
                                    c.get("levelset", {}), self.ctx.device)
            print(f"reading centroid_departures "
                  f"{want['centroid_departures']} of "
                  f"{want['subbox_points']} points", file=sys.stderr)
            readings.append(dict(
                phi_init_dx=compare.field_gap(res.phi_init, want["phi_init"],
                                              dx),
                phi_smoothed_dx=compare.field_gap(
                    res.phi_smoothed, want["phi_smoothed"], dx),
                phi_final_dx=compare.field_gap(res.phi_final,
                                               want["phi_final"], dx),
                nodes_dx=compare.nodes_gap(res.advected, want["advected"],
                                           dx),
                iters_gap=float(max(
                    abs(res.reinit_iters - want["reinit_iters"]),
                    abs(res.minmax_iters - want["minmax_iters"])))))
            del want
            if self.ctx.device == "cuda":
                torch.cuda.empty_cache()
        return compare.worst(readings)
