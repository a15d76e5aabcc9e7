"""One mesh at a time, as ``run()`` serves it: the program's ``read_stl``
on an STL file of the pool, ``run_mesh`` without writing, then
``write_vti`` of the initial and the smoothed field and ``write_s3d`` of
the advected nodes, all three into ``os.devnull``.  A record holds the
wall time, the time in the readers and writers, the program's stage marks
and iteration counts; in a traced run also the init's host culling
time.

Compared: the initial, smoothed and final fields, the advected nodes and
the iteration counts against the plain reference on the same STL soup.
"""

from __future__ import annotations

import os
import time

import torch
from torch.profiler import record_function

import levelsetfortran_tpu_torch as lsf
from levelsetfortran_tpu_torch.ops import init_sign

from h100bench import compare, jobs
from h100bench.reference import pipeline as ref


class Entry:

    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg = jobs.levelset_config(ctx)

    def setup(self):
        self.soups, warm = jobs.soups(self.ctx)
        self.paths = jobs.stl_files(self.soups, self.ctx.tmpdir)
        self.warm_path = jobs.stl_files([warm], self.ctx.tmpdir, "warm")[0]

    def warm(self):
        self._one(self.warm_path)

    def job(self, i: int):
        k = i % len(self.paths)
        rec, res = self._one(self.paths[k])
        rec["pool"] = k
        return rec, (k, res)

    def _one(self, path):
        traced = self.ctx.traced
        t0 = time.perf_counter()
        with record_function("h100bench.read_stl"):
            mesh = lsf.read_stl(path)
        t1 = time.perf_counter()
        if traced:
            init_sign.stage_times = {}
        res = lsf.run_mesh(mesh, self.cfg, write_outputs=False)
        t2 = time.perf_counter()
        with record_function("h100bench.write"):
            lsf.write_vti(os.devnull, res.phi_init, res.grid)
            lsf.write_vti(os.devnull, res.phi_smoothed, res.grid)
            lsf.write_s3d(os.devnull, mesh, res.advected)
        t3 = time.perf_counter()
        rec = dict(wall=t3 - t0, units=1, io_s=(t1 - t0) + (t3 - t2),
                   timers=dict(res.timers), reinit_iters=res.reinit_iters,
                   minmax_iters=res.minmax_iters,
                   shape=list(res.grid.shape), n_tri=int(mesh.n_elems))
        if traced:
            rec["culling_s"] = init_sign.stage_times.get("culling")
            init_sign.stage_times = None
        return rec, res

    def release(self):
        pass

    def check(self, kept) -> dict:
        c = self.ctx.config
        dx = c["dx"]
        readings = []
        for _, (k, res) in kept:
            want = ref.run_mesh(self.soups[k], dx, c["pad_cells"],
                                c.get("levelset", {}), self.ctx.device)
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
