"""Many small parts at once, as a server batches them: ``run_batch`` of
``batch`` STL files of the pool (the auto strategy: the packed solvers
for float32), then each geometry's ``write_vti`` of its initial and
smoothed field and ``write_s3d`` of its advected nodes into
``os.devnull``.  The pool is cycled ``batch`` files at a time.  A record
holds the wall time, the writers' time, the batch's stage marks and the
geometries' iteration counts.

Compared, per geometry: the initial and smoothed fields, the advected
nodes and the iteration counts against the plain reference's dense solves
on the batch's common grid shape.
"""

from __future__ import annotations

import os
import time

import torch
from torch.profiler import record_function

import levelsetfortran_tpu_torch as lsf
from levelsetfortran_tpu_torch.utils.logging import StageTimer

from h100bench import compare, jobs
from h100bench.reference import pipeline as ref


class Entry:

    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg = jobs.levelset_config(ctx)
        self.b = int(ctx.traffic["batch"])

    def setup(self):
        self.soups, _ = jobs.soups(self.ctx)
        self.paths = jobs.stl_files(self.soups, self.ctx.tmpdir)

    def _members(self, i: int) -> list:
        n = len(self.paths)
        return [(self.b * i + j) % n for j in range(self.b)]

    def warm(self):
        self._one(self._members(0))

    def job(self, i: int):
        ks = self._members(i)
        rec, items = self._one(ks)
        return rec, (ks, items)

    def _one(self, ks):
        t0 = time.perf_counter()
        timer = StageTimer()
        items = lsf.run_batch([self.paths[k] for k in ks], self.cfg,
                              timer=timer)
        t1 = time.perf_counter()
        with record_function("h100bench.write"):
            for it in items:
                lsf.write_vti(os.devnull, it.phi_init, it.grid)
                lsf.write_vti(os.devnull, it.phi_smoothed, it.grid)
                lsf.write_s3d(os.devnull, it.mesh, it.advected)
        t2 = time.perf_counter()
        rec = dict(wall=t2 - t0, units=len(items), io_s=t2 - t1,
                   timers=dict(timer.marks),
                   reinit_iters=[it.reinit_iters for it in items],
                   minmax_iters=[it.minmax_iters for it in items],
                   shape=list(items[0].grid.shape))
        return rec, items

    def release(self):
        pass

    def check(self, kept) -> dict:
        c = self.ctx.config
        dx = c["dx"]
        readings = []
        for _, (ks, items) in kept:
            wants = ref.run_batch([self.soups[k] for k in ks], dx,
                                  c["pad_cells"], c.get("levelset", {}),
                                  self.ctx.device)
            for it, want in zip(items, wants):
                readings.append(dict(
                    phi_init_dx=compare.field_gap(it.phi_init,
                                                  want["phi_init"], dx),
                    phi_smoothed_dx=compare.field_gap(
                        it.phi_smoothed, want["phi_smoothed"], dx),
                    nodes_dx=compare.nodes_gap(it.advected,
                                               want["advected"], dx),
                    iters_gap=float(max(
                        abs(it.reinit_iters - want["reinit_iters"]),
                        abs(it.minmax_iters - want["minmax_iters"])))))
            if len(wants) != len(items):
                readings.append(dict(iters_gap=float("inf")))
            if self.ctx.device == "cuda":
                torch.cuda.empty_cache()
        return compare.worst(readings)
