"""One mesh at a time on a grid cut into blocks, one block per card, as
``run_mesh`` serves it with ``LevelSetConfig.mesh_shape``: the program's
``read_stl`` on an STL file of the pool, ``run_mesh`` without writing and
with the fields left in their blocks on the cards (``gather_results``
false), then ``write_s3d`` of the advected nodes into ``os.devnull``.  The
``.vti`` volumes are not written: their streaming writer is host-bound at
512^3 and would set the pace.  A record holds the wall time, the time in
the reader and the writer, the program's stage marks and iteration counts,
the nodes and the cards the blocks lay on.

Compared, after the window: the kept job's blocks gathered to the host
against the plain reference of the sharded rules on the whole grid
(``reference/sharded.py``, on the first card): the initial, smoothed and
final fields, the advected nodes and the iteration counts.  The check's
seconds and the reference's peak memory go to standard error.
"""

from __future__ import annotations

import os
import sys
import time

import torch
from torch.profiler import record_function

import levelsetfortran_tpu_torch as lsf

from h100bench import compare, jobs
from h100bench.reference import sharded as ref

#: Keys of the configuration's ``levelset`` that place the grid, not the
#: solvers' settings.
LAYOUT = ("mesh_shape", "gather_results")


def gather(blocks, mesh_shape):
    """The whole field of a shard-ordered list of blocks (x slowest, z
    fastest), float64 on the host."""
    mx, my, mz = mesh_shape
    it = iter(b.detach().to("cpu", torch.float64) for b in blocks)
    return torch.cat([torch.cat([torch.cat([next(it) for _ in range(mz)], 2)
                                 for _ in range(my)], 1)
                      for _ in range(mx)], 0).numpy()


class Entry:

    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg = jobs.levelset_config(ctx)
        self.mesh_shape = tuple(ctx.config["levelset"]["mesh_shape"])

    def setup(self):
        self.soups, warm = jobs.soups(self.ctx)
        self.paths = jobs.stl_files(self.soups, self.ctx.tmpdir)
        self.warm_path = jobs.stl_files([warm], self.ctx.tmpdir, "warm")[0]

    def warm(self):
        rec, _ = self._one(self.warm_path)
        print(f"sharded: grid {rec['shape']} cut {list(self.mesh_shape)}, "
              f"blocks on {rec['devices']}", file=sys.stderr, flush=True)

    def job(self, i: int):
        k = i % len(self.paths)
        rec, res = self._one(self.paths[k])
        rec["pool"] = k
        return rec, (k, res)

    def _one(self, path):
        t0 = time.perf_counter()
        with record_function("h100bench.read_stl"):
            mesh = lsf.read_stl(path)
        t1 = time.perf_counter()
        res = lsf.run_mesh(mesh, self.cfg, write_outputs=False)
        t2 = time.perf_counter()
        with record_function("h100bench.write"):
            lsf.write_s3d(os.devnull, mesh, res.advected)
        t3 = time.perf_counter()
        blocks = [b for b in res.phi_init if b is not None]
        rec = dict(wall=t3 - t0, units=1, io_s=(t1 - t0) + (t3 - t2),
                   timers=dict(res.timers), reinit_iters=res.reinit_iters,
                   minmax_iters=res.minmax_iters,
                   shape=list(res.grid.shape), n_tri=int(mesh.n_elems),
                   n_nodes=int(res.advected.shape[0]),
                   devices=sorted({str(b.device) for b in blocks}))
        return rec, res

    def release(self):
        pass

    def check(self, kept) -> dict:
        c = self.ctx.config
        dx = c["dx"]
        overrides = {k: v for k, v in c.get("levelset", {}).items()
                     if k not in LAYOUT}
        cuda = self.ctx.device == "cuda"
        device = "cuda:0" if cuda else self.ctx.device
        readings = []
        for _, (k, res) in kept:
            got = {name: gather(getattr(res, name), self.mesh_shape)
                   for name in ("phi_init", "phi_smoothed", "phi_final")}
            t0 = time.perf_counter()
            if cuda:
                torch.cuda.reset_peak_memory_stats(device)
            want = ref.run_mesh(self.soups[k], dx, c["pad_cells"], overrides,
                                self.mesh_shape, device)
            peak = torch.cuda.max_memory_allocated(device) if cuda else 0
            print(f"sharded check: reference {time.perf_counter() - t0:.1f} "
                  f"s, peak {peak / 2 ** 30:.2f} GiB on {device}",
                  file=sys.stderr, flush=True)
            readings.append(dict(
                phi_init_dx=compare.field_gap(got["phi_init"],
                                              want["phi_init"], dx),
                phi_smoothed_dx=compare.field_gap(
                    got["phi_smoothed"], want["phi_smoothed"], dx),
                phi_final_dx=compare.field_gap(got["phi_final"],
                                               want["phi_final"], dx),
                nodes_dx=compare.nodes_gap(res.advected, want["advected"],
                                           dx),
                iters_gap=float(max(
                    abs(res.reinit_iters - want["reinit_iters"]),
                    abs(res.minmax_iters - want["minmax_iters"])))))
            del want, got
            if cuda:
                torch.cuda.empty_cache()
        return compare.worst(readings)
