"""A shape fitter's step: one ``image_loss_and_vertex_grad`` of a rendered
image against a zero target, the result waited for on the card.

The grid is the body's cube rule (``grid_points`` per axis over 1.2 times
its largest extent, the configuration's ``grad_grid_points``), and the
init's candidate culling is built once in set-up from the base body, with
a margin that covers every job's displacement, as a fitting loop reuses
it.  Each job's vertices are the base body's scaled and turned by the
traffic's ranges (``scale``, ``rotate_deg``).  The traffic sets
``reinit_steps``, ``minmax_steps``, ``image`` (pixels per side), ``eye``
and ``target``.

Compared: the loss (relative) and the vertex gradient (its largest
difference over its largest entry) against the plain reference's
autograd through the same chain.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

import levelsetfortran_tpu_torch as lsf
from levelsetfortran_tpu_torch.grid.grid import Grid3D
from levelsetfortran_tpu_torch.ops.init_sign import build_init_culling

from h100bench import compare, meshes
from h100bench.reference import geometry, pipeline as ref

#: Steps of the render's ray march (the program's default), given to the
#: program and the reference alike.
MARCH_STEPS = 64


class Entry:

    def __init__(self, ctx):
        self.ctx = ctx
        t = ctx.traffic
        self.kw = dict(eye=tuple(t["eye"]), target=tuple(t["target"]),
                       reinit_steps=int(t["reinit_steps"]),
                       minmax_steps=int(t["minmax_steps"]),
                       height=int(t["image"]), width=int(t["image"]),
                       n_march_steps=MARCH_STEPS)
        self.dtype = getattr(torch, ctx.dtype or "float32")

    def setup(self):
        ctx, t = self.ctx, self.ctx.traffic
        base = meshes.base_soup(ctx.config["body"])
        self.verts, self.elems = geometry.soup_mesh(base)
        self.grid = geometry.cube_grid(self.verts, ctx.config[
            "grad_grid_points"])
        rot = t.get("rotate_deg", 0.0)
        var = meshes.variants(ctx.seed, int(t["pool"]), t["scale"], rot,
                              int(t.get("shuffle_block", 4)))
        c = (self.verts.min(0) + self.verts.max(0)) / 2.0
        r = float(np.max(np.linalg.norm(self.verts - c, axis=1)))
        s_lo, s_hi = (float(x) for x in t["scale"])
        self.margin = 1.01 * r * (max(s_hi - 1.0, 1.0 - s_lo) + 2.0 * s_hi
                                  * math.sin(math.radians(rot) / 2.0)) + 1e-6
        # each job's vertices: the base mesh's, moved (same numbering)
        self.pool = [meshes.transform(self.verts, s, axis, angle)
                     for s, axis, angle in var]
        dev = ctx.device
        g = Grid3D(shape=self.grid.shape, origin=self.grid.origin,
                   dx=self.grid.dx)
        self.port_grid = g
        self.cull = build_init_culling(g, self.verts, self.elems, block=16,
                                       margin=self.margin)
        self.on_card = [torch.as_tensor(v, dtype=self.dtype, device=dev)
                        for v in self.pool]
        self.target = torch.zeros((self.kw["height"], self.kw["width"]),
                                  dtype=self.dtype, device=dev)

    def warm(self):
        self._one(self.on_card[-1])

    def job(self, i: int):
        k = i % (len(self.on_card) - 1)
        rec, out = self._one(self.on_card[k])
        rec["pool"] = k
        return rec, (k, out)

    def _one(self, v):
        t0 = time.perf_counter()
        loss, grad = lsf.image_loss_and_vertex_grad(
            v, self.elems, self.port_grid, self.target, culling=self.cull,
            **self.kw)
        if v.device.type == "cuda":
            torch.cuda.synchronize(v.device)
        t1 = time.perf_counter()
        return dict(wall=t1 - t0, units=1,
                    shape=list(self.grid.shape)), (loss, grad)

    def release(self):
        self.on_card = None
        self.cull = None

    def check(self, kept) -> dict:
        rows = geometry.culling_rows(self.grid, self.verts, self.elems,
                                     block=16, margin=self.margin)
        readings = []
        for _, (k, (loss, grad)) in kept:
            want_loss, want_grad = ref.image_grad(
                self.pool[k], self.elems, self.grid, rows,
                device=self.ctx.device, **self.kw)
            got = grad.detach().cpu().double().numpy()
            scale = float(np.max(np.abs(want_grad)))
            readings.append(dict(
                loss_rel=abs(float(loss) - want_loss) / abs(want_loss),
                grad_rel=(float(np.max(np.abs(got - want_grad))) / scale
                          if got.shape == want_grad.shape and scale > 0
                          else math.inf)))
            if self.ctx.device == "cuda":
                torch.cuda.empty_cache()
        return compare.worst(readings)
