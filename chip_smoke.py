#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

Run from the repository root with no arguments:  python3 chip_smoke.py

Phases, one line each; any failure raises and the exit code is non-zero:
  0. device: the card's name and power limit (nvidia-smi), torch and CUDA
     versions; TF32 is switched on for the whole run, so a matmul that
     should stay full fp32 would show;
  1. build: compile the CUDA kernels from levelsetfortran_tpu_torch/csrc;
  2. kernels: each kernel against its plain PyTorch version on the card at
     (67, 45, 39) and (222, 222, 222), dense, with the fused sum and banded
     with a real mask; K4 also against 4 launches of K3, bitwise, and
     timed beside them (dense and banded; at 222^3 and, after run A, on
     run A's own field and band mask at 262x42x42); the
     adjoint kernels K5 (with a sign source unlike phi) and K6 (on a field
     after a K1 step) against their plain versions (K6 bitwise, also with
     a solve's buffers) and against a second launch, bitwise; median times
     from CUDA events; the pack modes of K1
     and K3 at (8, 64^3) and at run E's (8, 129^3), one geometry frozen,
     against a second launch, each geometry's solo launch and their plain
     versions, bitwise, and one packed launch timed against 8 solo ones,
     all 8 live;
  3. runs A (twoCube10 twin, dx 0.05, 262x42x42), B (icosphere with 20,480
     triangles, dx 0.01, 222^3) and C (A with --narrow-band off), each
     through ``python -m levelsetfortran_tpu_torch`` and in-process
     through ``run()`` with the launch counters read around it; outputs
     checked against the analytic SDFs;
  4. run D, the differentiable path at the JAX package's end-to-end
     gradient size (``bench.py:bench_e2e_pixgrad(256)``): icosphere with
     20,480 triangles on 256^3, 50 reinit and 20 min/max steps, a 64x64
     image, one ``image_loss_and_vertex_grad`` against a zero image; the
     launch counters, the reverse sweeps' branches and the wall; then each
     stage alone, forward and backward, chained on the same cotangents
     (its times and backward peaks, and the same gradient); K5 and K6 at
     256^3 on run D's own inputs against their plain versions; then the
     24^3 octahedron on the card against the CPU plain path, and its
     finite-difference gate;
  5. run E, the batched serving path (``run_batch``): four icospheres and
     four boxes on a common 129^3 grid, through the CLI with eight inputs
     and in-process with the launch counters read around it; each output
     checked against its analytic SDF; the packed solver stages held
     against the solo dense solvers on the same init, bitwise;
  6. the block modes of K1 and K3 (phase 2c: one shard's halo-padded block
     of a domain-decomposed grid) on a (2,2,1) split of the 222^3 sphere
     field and a (2,2,2) split of (66, 46, 38): against their plain
     versions over the whole padded output, the gathered field against the
     solo kernel on the whole grid (bitwise), the owned-range sums against
     the solo sum, two steps per exchange and the overlapped step against
     plain stepping (bitwise), the banded step against the dense one on
     active bricks; then run F, run B's mesh with ``--mesh-shape 2,2,1``
     through the CLI and ``run()``, held to run B's gates and against run
     B's fields, the block-mode counters read around it and the solo
     kernels' counters zero; then its solver stages once more at fixed
     counts, dense, with two steps per exchange and overlapped, bitwise
     equal to each other and to the solo dense solvers;
  7. the block and banded modes of the adjoint kernels K5 and K6 (phase
     2d): block mode on the bench sphere of ``bench.py:328-363`` (256^3)
     cut (2,2,1) and on (66, 46, 38) cut (2,2,2), every shard against its
     plain version and a second launch, the gathered owned cotangents
     against the solo kernel, bitwise (K6's against its plain version
     too); banded mode on the bench sphere with a real mask, against its
     plain version and (K6, bitwise) the dense kernel;
  8. run G (phase 4b), run D with a (2,2,1) shard mesh on one card: the
     sharded init, ``reinit_fixed_sharded`` and ``minmax_fixed_sharded``
     (the block modes of K1/K3/K5/K6), against run D in the same call;
     then the two sharded solvers alone on run D's own init against the
     solo solvers, bitwise; and the differentiable narrow-band solves
     (phase 4c) on the bench sphere: ``reinit_scan_banded`` beside the
     dense solve, ``minmax_scan(banded=True)`` bitwise the dense one, the
     banded sharded reinit bitwise the solo banded one.
The second-to-last line is the kernels' JSON record, the last line the
device record.  Needs no network; starts one child process per run.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from functools import partial

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SHAPES = ((67, 45, 39), (222, 222, 222))
MAIN_SHAPE = SHAPES[1]
#: Adjoint kernels against their plain versions, relative to max |cot|:
#: K5's 21-term stencil gather and ghost-BC gather follow the plain
#: version's order, but its cot_sign cancels (ROADMAP H10), so a reordered
#: sum shows at ~1e-6.  K6 evaluates the same expressions in the same order
#: and its field cotangent is held bitwise (no tolerance).  Scalars: float64
#: sums of the same per-cell terms, other order.
ADJ_TOL = {"K5": 1e-5, "scalars": 1e-5}
#: Enqueued calls per host-time measurement.
HOST_CALLS = 100
#: Peak rates of one H100 SXM (NVIDIA's data sheet): HBM3 bytes/s and
#: float32 operations/s outside the tensor cores (an FMA counted as two).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
#: Float operations a kernel's function needs, counted by hand from csrc/
#: (an add, multiply, compare-select, division or square root is one):
#: per cell, K1's step (145 per axis for WENO5 and the Godunov square, 14
#: for the tail) and the fused sum (3); per in-band interior cell, one
#: min/max update (14) and its adjoint's own terms (19), and per cell K6's
#: 6-neighbour gather (16); per cell K5's forward and adjoint (~1600).
OPS = {"reinit": 452, "rms": 3, "minmax_band": 14, "reinit_vjp": 1600,
       "minmax_vjp_band": 19, "minmax_vjp": 16}
#: Run E, the batched serving path: four icospheres (5,120 triangles) and
#: four boxes at dx 0.015 with the default config (pad 10): a common grid
#: of 129^3 per geometry.  The boxes have 4 quads per edge (192
#: triangles): with 12 long triangles the exact-distance init takes the
#: wrong sign at a few points beside an edge (ROADMAP H11).  Depth cut:
#: 250 advection iterations instead of 1000 (the nodes have settled by 200;
#: the advection is launch-bound, 15 s of the in-process run at 1000).
RUN_E_ADVECT_ITERS = 250
RUN_E_DX = 0.015
RUN_E_SPHERES = (0.5, 0.6, 0.7, 0.8)
RUN_E_BOXES = ((0.8, 0.8, 0.8), (0.8, 0.5, 0.3), (0.4, 0.8, 0.6),
               (0.6, 0.6, 0.8))
#: The pack kernels' checks: B geometries, geometry FROZEN not stepping.
PACK_B, FROZEN = 8, 3
#: The JAX package's banded-gradient bench (``bench.py:328-363``): |x| - 0.6
#: on 256^3 points of [-1, 1]^3, h = 0.1 dx.
BENCH_N, BENCH_R = 256, 0.6
BENCH_DX = 2.0 / (BENCH_N - 1)
#: Iterations (reinit, min/max) of runs A, B, C and F: the JAX package's
#: own counts on these meshes (run C), unchanged since the port's first
#: kernels; the kernels' fused sums are bitwise fixed, so they cannot move.
EXPECTED_ITERS = {"A": (18, 1080), "B": (9, 40), "C": (13, 1064),
                  "F": (2, 24)}
#: The card's name and power limit as nvidia-smi prints them (set by
#: start()), printed beside every time.
CARD = "nvidia-smi not read"


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def sphere(shape, dx, radius):
    """Sphere SDF centered in the box, on the device, float32."""
    import torch
    axes = [(np.arange(n) - (n - 1) / 2.0) * dx for n in shape]
    gx, gy, gz = np.meshgrid(*axes, indexing="ij")
    phi = np.sqrt(gx ** 2 + gy ** 2 + gz ** 2) - radius
    return torch.tensor(phi, dtype=torch.float32, device="cuda")


def median_ms(fn, reps):
    import torch
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def device_ms(fn, calls=10, traces=3):
    """Device time per call of ``fn``: every CUDA kernel it launches, summed
    under ``torch.profiler`` over ``calls`` calls; the median of ``traces``
    such traces, since the profiler now and then drops some or all of a
    trace's device activity (a time below the bound, or 0)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    totals = []
    for _ in range(traces):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        total = 0.0
        for e in prof.key_averages():
            t = getattr(e, "device_time_total", None)
            total += getattr(e, "cuda_time_total", 0.0) if t is None else t
        totals.append(total)
    return float(np.median(totals)) / calls / 1e3


def host_ms(fn, calls=HOST_CALLS):
    """Host time per call: ``calls`` calls enqueued with no synchronize
    between them, the host clock over the count."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e3


def bitwise(a, b):
    """Two float tensors hold the same bits."""
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    it = torch.int64 if a.dtype == torch.float64 else torch.int32
    return torch.equal(a.contiguous().view(it), b.contiguous().view(it))


def k6_bufs_holds(what, call, make, ref):
    """K6 with a solve's buffers: ``call(bufs)`` launches it, ``make()``
    makes new ones, ``ref`` is a launch without them.  Two launches give
    ``ref``'s field bitwise, return None for the scalars and add them into
    the buffers' running sums as a caller adds each step's: (0 + s) + s.
    Returns the buffers."""
    bufs = make()
    a, b = call(bufs), call(bufs)
    check(a[1] is None and a[2] is None and bitwise(a[0], ref[0])
          and bitwise(b[0], ref[0]),
          f"K6 {what}: the field with a solve's buffers differs")
    want = [(0.0 + float(v)) + float(v) for v in ref[1:]]
    got = [float(v) for v in bufs.sums]
    check(got == want, f"K6 {what}: running sums {got!r}, want {want!r}")
    return bufs


def k6_host_times(rec, call, bufs):
    """Host time per call of a K6 entry without and with a solve's buffers,
    and the events' time with them."""
    rec["host_ms"] = host_ms(lambda: call(None))
    rec["bufs_host_ms"] = host_ms(lambda: call(bufs))
    rec["bufs_ms"] = median_ms(lambda: call(bufs), 20)


def k6_times_text(rec):
    return (f"device {rec['device_ms']:.4f} ms, host {rec['host_ms']:.4f} "
            f"ms per call ({rec['bufs_host_ms']:.4f} with a solve's "
            f"buffers, events then {rec['bufs_ms']:.4f} ms)")


def twice_equal(fn):
    """Two calls of ``fn`` return bitwise equal tensors."""
    import torch
    a, b = fn(), fn()
    a = a if isinstance(a, (tuple, list)) else (a,)
    b = b if isinstance(b, (tuple, list)) else (b,)
    return all(torch.equal(x, y) for x, y in zip(a, b))


def err(a, b):
    return float((a.double() - b.double()).abs().max())


def bound(nbytes, ops):
    """The least time the card could take for the work: its bytes (each
    input read once, each output written once) over the memory rate or its
    float operations over the float32 rate, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def band_cells(phi, dx, radius=4.1):
    """Interior cells whose own value is in the min/max band: the cells a
    min/max step (or its adjoint) updates, over the last three axes."""
    band = (phi.abs() < float(np.float32(radius) * np.float32(dx)))
    return int(band[..., 1:-1, 1:-1, 1:-1].sum())


def fused_against_k3(tag, phi, dx, h1, active):
    """K4 (4 fused steps) against 4 K3 launches on the same input, dense
    and banded with ``active``: bitwise (fields and the last step's sum),
    then both timed in turns (medians of 20, the lesser of two)."""
    import torch
    from levelsetfortran_tpu_torch.ops import minmax_cuda as mc

    def k4(act):
        return mc.minmax_fusedk(phi, dx, h1, ksteps=4, active=act,
                                with_rms=True)

    def k3x4(act):
        q = phi
        for s in range(4):
            q = mc.minmax_step(q, dx, h1, active=act, with_rms=s == 3)
        return q

    t = {}
    for name, act in (("dense", None), ("banded", active)):
        f, fd = k4(act)
        q, qd = k3x4(act)
        check(torch.equal(f, q) and float(fd) == float(qd),
              f"K4 {tag} {name}: not bitwise equal to 4 K3 launches "
              f"({err(f, q):.3g}, sums {float(fd)!r} / {float(qd)!r})")
        a = median_ms(lambda: k4(act), 20)
        b = median_ms(lambda: k3x4(act), 20)
        t[name] = (min(a, median_ms(lambda: k4(act), 20)),
                   min(b, median_ms(lambda: k3x4(act), 20)))
    frozen = int(active.numel() - active.sum())
    phase("kernels", f"K4 vs 4 K3 launches {tag} {tuple(phi.shape)}: "
          f"bitwise equal (fields and sums); dense {t['dense'][0]:.4f} ms "
          f"vs {t['dense'][1]:.4f} ms, banded ({frozen}/{active.numel()} "
          f"bricks frozen) {t['banded'][0]:.4f} ms vs {t['banded'][1]:.4f} "
          f"ms; card {CARD}")


def kernel_phase(record):
    """Phase 2: every kernel against its plain version."""
    import torch
    from levelsetfortran_tpu_torch.ops import minmax_cuda as mc
    from levelsetfortran_tpu_torch.ops import weno_cuda as wc

    tol = {"reinit": 1e-6, "minmax": 1e-7}
    for shape in SHAPES:
        dx = 0.01 if shape == MAIN_SHAPE else 0.05
        phi = sphere(shape, dx, 1.0 if shape == MAIN_SHAPE else 0.6)
        h = 0.1 * dx / 3.0
        margin = 9 * h / dx
        act_r = wc.tile_activity(phi, dx, 8.1, margin, window="band4")
        h1 = 0.01 * dx / 3.0
        act_m = wc.tile_activity(phi, dx, 4.1, window="owned")
        check(0 < int(act_r.sum()) < act_r.numel(), "reinit mask skips")
        check(0 < int(act_m.sum()) < act_m.numel(), "minmax mask skips")
        main = shape == MAIN_SHAPE

        # K1: dense with the fused sum, then banded (mint and carry)
        k, kd = wc.reinit_step(phi, phi, dx, h, with_rms=True)
        p, pd = wc.reinit_step_plain(phi, phi, dx, h, with_rms=True)
        e1 = err(k, p)
        rel = abs(float(kd) - float(pd)) / max(float(pd), 1e-30)
        kb = wc.reinit_step(phi, phi, dx, h, active=act_r)
        pb = wc.reinit_step_plain(phi, phi, dx, h, active=act_r)
        kc = wc.reinit_step(phi, phi, dx, h, active=act_r, out=phi + 0.0,
                            mint=False)
        e1 = max(e1, err(kb, pb), err(kc, pb))
        check(e1 <= tol["reinit"] and rel <= 1e-5,
              f"K1 {shape}: max_abs_err {e1:.3g}, dsq rel {rel:.3g}")
        check(twice_equal(lambda: wc.reinit_step(phi, phi, dx, h,
                                                 with_rms=True))
              and twice_equal(lambda: wc.reinit_step(
                  phi, phi, dx, h, active=act_r, with_rms=True)),
              f"K1 {shape}: two launches differ")
        rec = record["reinit_step"]
        rec["max_abs_err"] = max(rec["max_abs_err"], e1)
        if main:
            rec["ms"] = median_ms(lambda: wc.reinit_step(
                phi, phi, dx, h, with_rms=True), 20)
            rec["plain_ms"] = median_ms(lambda: wc.reinit_step_plain(
                phi, phi, dx, h, with_rms=True), 5)
            rec["banded_ms"] = median_ms(lambda: wc.reinit_step(
                phi, phi, dx, h, active=act_r, with_rms=True), 20)
            rec["device_ms"] = device_ms(lambda: wc.reinit_step(
                phi, phi, dx, h, with_rms=True))
            rec["banded_device_ms"] = device_ms(lambda: wc.reinit_step(
                phi, phi, dx, h, active=act_r, with_rms=True))
            rec.update(bound(12 * phi.numel(), OPS["reinit"] * phi.numel()))
        phase("kernels", f"K1 {shape}: max_abs_err {e1:.3g} (tol 1e-6), "
              f"dsq rel {rel:.3g} (tol 1e-5), two launches bitwise equal "
              f"(dense and banded), active bricks "
              f"{int(act_r.sum())}/{act_r.numel()}")

        # K3: dense with the fused sum, then banded
        k, kd = mc.minmax_step(phi, dx, h1, with_rms=True)
        p, pd = mc.minmax_step_plain(phi, dx, h1, with_rms=True)
        e3 = err(k, p)
        rel3 = abs(float(kd) - float(pd)) / max(float(pd), 1e-30)
        kb = mc.minmax_step(phi, dx, h1, active=act_m)
        e3 = max(e3, err(kb, mc.minmax_step_plain(phi, dx, h1,
                                                  active=act_m)))
        check(e3 <= tol["minmax"] and rel3 <= 1e-5,
              f"K3 {shape}: max_abs_err {e3:.3g}, dsq rel {rel3:.3g}")
        check(twice_equal(lambda: mc.minmax_step(phi, dx, h1, with_rms=True))
              and twice_equal(lambda: mc.minmax_step(
                  phi, dx, h1, active=act_m, with_rms=True)),
              f"K3 {shape}: two launches differ")
        rec = record["minmax_step"]
        rec["max_abs_err"] = max(rec["max_abs_err"], e3)
        if main:
            rec["ms"] = median_ms(lambda: mc.minmax_step(
                phi, dx, h1, with_rms=True), 20)
            rec["plain_ms"] = median_ms(lambda: mc.minmax_step_plain(
                phi, dx, h1, with_rms=True), 10)
            rec["banded_ms"] = median_ms(lambda: mc.minmax_step(
                phi, dx, h1, active=act_m, with_rms=True), 20)
            rec["device_ms"] = device_ms(lambda: mc.minmax_step(
                phi, dx, h1, with_rms=True))
            rec["banded_device_ms"] = device_ms(lambda: mc.minmax_step(
                phi, dx, h1, active=act_m, with_rms=True))
            rec.update(bound(8 * phi.numel(),
                             OPS["minmax_band"] * band_cells(phi, dx)
                             + OPS["rms"] * phi.numel()))
        phase("kernels", f"K3 {shape}: max_abs_err {e3:.3g} (tol 1e-7), "
              f"dsq rel {rel3:.3g}, two launches bitwise equal (dense and "
              f"banded), active bricks "
              f"{int(act_m.sum())}/{act_m.numel()}")

        # K4: 4 fused steps against 4 launches of K3 (bitwise) and plain
        e4 = 0.0
        for active in (None, act_m):
            k4, k4d = mc.minmax_fusedk(phi, dx, h1, ksteps=4, active=active,
                                       with_rms=True)
            q = phi
            for s in range(4):
                q, qd = mc.minmax_step(q, dx, h1, active=active,
                                       with_rms=True)
            check(torch.equal(k4, q) and float(k4d) == float(qd),
                  f"K4 {shape} active={active is not None}: not bitwise "
                  f"equal to 4 K3 launches ({err(k4, q):.3g})")
            p4 = mc.minmax_fusedk_plain(phi, dx, h1, ksteps=4,
                                        active=active)
            e4 = max(e4, err(k4, p4))
        check(e4 <= tol["minmax"], f"K4 {shape}: max_abs_err {e4:.3g}")
        rec = record["minmax_fusedk"]
        rec["max_abs_err"] = max(rec["max_abs_err"], e4)
        if main:
            rec["ms"] = median_ms(lambda: mc.minmax_fusedk(
                phi, dx, h1, ksteps=4, with_rms=True), 20)
            rec["plain_ms"] = median_ms(lambda: mc.minmax_fusedk_plain(
                phi, dx, h1, ksteps=4, with_rms=True), 10)
            rec["banded_ms"] = median_ms(lambda: mc.minmax_fusedk(
                phi, dx, h1, ksteps=4, active=act_m, with_rms=True), 20)
            rec.update(bound(8 * phi.numel(),
                             4 * OPS["minmax_band"] * band_cells(phi, dx)
                             + OPS["rms"] * phi.numel()))
        phase("kernels", f"K4 {shape}: bitwise equal to 4 K3 launches, "
              f"max_abs_err vs plain {e4:.3g} (tol 1e-7)")
        if main:
            fused_against_k3("sphere", phi, dx, h1, act_m)
        del k, p, kb, pb, kc
        # K5: a sign source whose sign and value differ from phi's (a
        # sphere 10% larger); K6: a field after one K1 step
        r = 1.0 if main else 0.6
        adjoint_checks(record, phi, sphere(shape, dx, 1.1 * r),
                       wc.reinit_step(phi, phi, dx, h), dx, h, h1, main)
        del phi
        torch.cuda.empty_cache()
    for name in ("reinit_step", "minmax_step", "minmax_fusedk",
                 "reinit_step_vjp", "minmax_step_vjp"):
        rec = record[name]
        banded = (f" (banded {rec['banded_ms']:.4f} ms)"
                  if "banded_ms" in rec else "")
        if "banded_device_ms" in rec:
            banded += (f", device {rec['device_ms']:.4f} ms (banded "
                       f"{rec['banded_device_ms']:.4f} ms)")
        elif "host_ms" in rec:
            banded += ", " + k6_times_text(rec)
        phase("kernels", f"{name} at {MAIN_SHAPE}: kernel {rec['ms']:.4f} ms"
              f"{banded}, plain {rec['plain_ms']:.4f} ms, bound "
              f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}); card {CARD}")


def adjoint_checks(record, phi, sgn, mm_phi, dx, h, h1, main, label=""):
    """K5 at (phi, sign source sgn) and K6 at mm_phi against their plain
    versions (K5 relative to max |cot|, K6's field bitwise) and against a
    second launch of themselves (bitwise), with a standard-normal
    cotangent; K6 also with a solve's buffers."""
    import torch
    from levelsetfortran_tpu_torch.ops import minmax_cuda as mc
    from levelsetfortran_tpu_torch.ops import weno_cuda as wc

    g = torch.tensor(np.random.default_rng(7).standard_normal(phi.shape),
                     dtype=torch.float32, device="cuda")
    cells = phi.numel()
    cases = (
        ("reinit_step_vjp", "K5", ADJ_TOL["K5"],
         lambda: wc.reinit_step_vjp(phi, sgn, g, dx, h),
         lambda: wc.reinit_step_vjp_plain(phi, sgn, g, dx, h), 3,
         bound(20 * cells, OPS["reinit_vjp"] * cells)),
        ("minmax_step_vjp", "K6", None,
         lambda: mc.minmax_step_vjp(mm_phi, g, dx, h1),
         lambda: mc.minmax_step_vjp_plain(mm_phi, g, dx, h1), 10,
         bound(12 * cells, OPS["minmax_vjp_band"] * band_cells(mm_phi, dx)
               + OPS["minmax_vjp"] * cells)))
    for name, kid, tol, kern, plain, reps, bnd in cases:
        k, k2, p = kern(), kern(), plain()
        check(all(torch.equal(a, b) for a, b in zip(k, k2)),
              f"{kid} {phi.shape}: two launches differ")
        nf = len(k) - 2                      # the field cotangents
        rels = [err(a, b) / max(float(b.abs().max()), 1e-30)
                for a, b in zip(k[:nf], p[:nf])]
        srel = max(abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)
                   for a, b in zip(k[nf:], p[nf:]))
        e = max(err(a, b) for a, b in zip(k[:nf], p[:nf]))
        exact = all(bitwise(a, b) for a, b in zip(k[:nf], p[:nf]))
        check((exact if tol is None else max(rels) <= tol)
              and srel <= ADJ_TOL["scalars"],
              f"{kid} {phi.shape}: rel errors {rels}, bitwise {exact}, "
              f"scalars {srel:.3g}")
        rec = record[name]
        rec["max_abs_err"] = max(rec["max_abs_err"], e)
        gate = "bitwise" if tol is None else f"tol {tol:g} of max|cot|"
        if kid == "K6":
            bufs = k6_bufs_holds(f"{tuple(phi.shape)}", lambda b: (
                mc.minmax_step_vjp(mm_phi, g, dx, h1, bufs=b)), lambda: (
                mc.VjpBuffers(mm_phi, dx, h1)), k)
            gate += ("; with a solve's buffers the same field and the sums "
                     "added up on the device")
        if main:
            rec["ms"] = median_ms(kern, 20)
            rec["plain_ms"] = median_ms(plain, reps)
            rec.update(bnd)
            if kid == "K6":
                rec["device_ms"] = device_ms(kern)
                k6_host_times(rec, lambda b: mc.minmax_step_vjp(
                    mm_phi, g, dx, h1, bufs=b), bufs)
        phase("kernels", f"{kid} {tuple(phi.shape)}{label}: field "
              f"cotangents rel "
              f"err {', '.join(f'{r:.3g}' for r in rels)} ({gate}), "
              f"max_abs_err {e:.3g}, scalars rel {srel:.3g} (tol "
              f"{ADJ_TOL['scalars']:g}), two launches bitwise equal")


def near_surface_errors(path, truth_fn):
    import torch
    from levelsetfortran_tpu_torch.io.vti import read_vti
    phi, grid = read_vti(path)
    pts = grid.coords(dtype=torch.float64).numpy()
    truth = truth_fn(pts)
    near = np.abs(truth) < 0.2
    return np.abs(phi - truth)[near]


def run_phase(label, mesh, truth_fn, dx, extra_args, tmp):
    """Phase 3: one run through the CLI and one through run()."""
    import torch
    from levelsetfortran_tpu_torch import LevelSetConfig, write_stl
    from levelsetfortran_tpu_torch.ops import minmax_cuda as mc
    from levelsetfortran_tpu_torch.ops import weno_cuda as wc
    from levelsetfortran_tpu_torch.pipeline.cli import (build_parser,
                                                        config_from_args)
    from levelsetfortran_tpu_torch.pipeline.run import run

    stl = os.path.join(tmp, f"{label}.stl")
    write_stl(stl, mesh)
    cli_dir = os.path.join(tmp, f"{label}_cli")
    args = [stl, "--dx", str(dx), "--out-dir", cli_dir, *extra_args]
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "levelsetfortran_tpu_torch", *args],
        cwd=HERE, capture_output=True, text=True, timeout=900)
    check(proc.returncode == 0,
          f"run {label} CLI failed:\n{proc.stdout}\n{proc.stderr[-4000:]}")
    cli_s = time.perf_counter() - t0
    for f in ("signedDistanceFunction.vti", "smoothedDistanceFunction.vti",
              f"{label}.s3d"):
        check(os.path.exists(os.path.join(cli_dir, f)),
              f"run {label}: CLI wrote no {f}")

    cfg = config_from_args(build_parser().parse_args(args))
    check(cfg.reinit_iters == LevelSetConfig().reinit_iters
          and cfg.minmax_iters == LevelSetConfig().minmax_iters,
          "default iteration caps")
    counters = (wc.reinit_step, mc.minmax_step, mc.minmax_fusedk,
                wc.reinit_step_block, mc.minmax_step_block)
    for c in counters:
        c.launches = 0
    res = run(stl, cfg, out_dir=os.path.join(tmp, f"{label}_py"))
    launches = {c.__name__: c.launches for c in counters}

    e_sdf = near_surface_errors(
        os.path.join(cli_dir, "signedDistanceFunction.vti"), truth_fn)
    e_smooth = near_surface_errors(
        os.path.join(cli_dir, "smoothedDistanceFunction.vti"), truth_fn)
    adv = np.abs(truth_fn(res.advected))
    finite = all(np.isfinite(f).all() for f in
                 (res.phi_init, res.phi_smoothed, res.phi_final,
                  res.advected))
    phase(f"run {label}", f"grid {res.grid.shape}, reinit_iters "
          f"{res.reinit_iters}, minmax_iters {res.minmax_iters}, "
          f"asymptotic_error {res.asymptotic_error:.4g}, sdf near-surface "
          f"max err {e_sdf.max():.4g}, smoothed median err "
          f"{np.median(e_smooth):.4g}, advected max |sdf| {adv.max():.4g} "
          f"(dx {dx}), launches {launches}, CLI {cli_s:.1f} s, "
          f"timers {json.dumps({k: round(v, 3) for k, v in res.timers.items()})}")
    t = res.timers
    phase(f"run {label}", f"stages: reinit "
          f"{t['initialization'] - t['search']:.4f} s, min/max "
          f"{t['minmax'] - t['initialization']:.4f} s; card {CARD}")
    check((res.reinit_iters, res.minmax_iters) == EXPECTED_ITERS[label],
          f"run {label}: iterations {res.reinit_iters} / "
          f"{res.minmax_iters}, expected {EXPECTED_ITERS[label]}")
    check(e_sdf.max() < 5e-3, f"run {label}: sdf error {e_sdf.max()}")
    # min/max flow rounds corners, so the smoothed field is gated by its
    # median; the JAX package's own pipeline measures 5.01e-3 on mesh A
    # (CPU, float32), hence 6e-3 rather than the nominal ~5e-3
    check(np.median(e_smooth) < 6e-3, f"run {label}: smoothed median error")
    check(adv.max() <= 1.5 * dx, f"run {label}: advected |sdf| {adv.max()}")
    check(res.reinit_iters < cfg.reinit_iters, f"run {label}: reinit cap")
    check(finite and not res.reinit_diverged and not res.minmax_diverged,
          f"run {label}: diverged or non-finite")
    if "--mesh-shape" in extra_args:
        want = ("reinit_step_block", "minmax_step_block")
    elif "off" in extra_args:
        want = ("reinit_step", "minmax_step")
    else:
        want = ("reinit_step", "minmax_fusedk")
    for name in want:
        check(launches[name] > 0, f"run {label}: {name} never launched")
    if "--mesh-shape" in extra_args:
        check(all(v == 0 for n, v in launches.items() if n not in want),
              f"run {label}: solo kernels launched under a mesh {launches}")
    return launches, res


def run_a_fused(res, mesh, dx=0.05):
    """K4 against 4 K3 launches at run A's grid (262x42x42) on its own
    phi_init, with the step and the band mask of its banded min/max
    solve."""
    import torch
    from levelsetfortran_tpu_torch import LevelSetConfig
    from levelsetfortran_tpu_torch.grid import grid as gridmod
    from levelsetfortran_tpu_torch.ops import weno_cuda as wc
    cfg = LevelSetConfig()
    phi = torch.tensor(res.phi_init, dtype=torch.float32, device="cuda")
    h1 = cfg.minmax_cfl * dx / gridmod.surface_diag(mesh.vertices)
    act = wc.tile_activity(phi, dx, cfg.band_radius, window="owned")
    fused_against_k3("run A", phi, dx, h1, act)


def cube_grid(vertices, n):
    """``bench.py:_cube40_grid``: n^3 points spanning 1.2x the largest
    extent of the bounding box, centred on it."""
    from levelsetfortran_tpu_torch.grid.grid import Grid3D
    lo, hi = vertices.min(0), vertices.max(0)
    span = float((hi - lo).max()) * 1.2
    origin = tuple(float(c) for c in (lo + hi) / 2 - span / 2)
    return Grid3D(shape=(n, n, n), origin=origin, dx=span / (n - 1))


def sync_time(fn):
    import torch

    def sync():
        for d in range(torch.cuda.device_count()):
            torch.cuda.synchronize(d)

    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def run_d_phase(ball, card, record, n=256):
    """Phase 4: one pixels -> vertices gradient at full size."""
    import torch
    from levelsetfortran_tpu_torch import image_loss_and_vertex_grad
    from levelsetfortran_tpu_torch.ops import minmax_cuda as mc
    from levelsetfortran_tpu_torch.ops import reverse
    from levelsetfortran_tpu_torch.ops import weno_cuda as wc
    from levelsetfortran_tpu_torch.ops.init_sign import build_init_culling

    grid = cube_grid(ball.vertices, n)
    t0 = time.perf_counter()
    cull = build_init_culling(grid, ball.vertices, ball.elements, block=16)
    t_build = time.perf_counter() - t0
    v = torch.tensor(ball.vertices, dtype=torch.float32, device="cuda")
    kw = dict(eye=(0.0, -3.0, 0.0), target=(0.0, 0.0, 0.0), reinit_steps=50,
              minmax_steps=20, height=64, width=64, culling=cull)
    target = torch.zeros((64, 64), device="cuda")
    counters = (wc.reinit_step, mc.minmax_step, mc.minmax_fusedk,
                wc.reinit_step_vjp, mc.minmax_step_vjp)
    reverse.last_branch.clear()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0
    (loss, grad), wall = sync_time(lambda: image_loss_and_vertex_grad(
        v, ball.elements, grid, target, **kw))
    launches = {c.__name__: c.launches for c in counters}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    branches = dict(reverse.last_branch)
    gmax = float(grad.abs().max())
    check(bool(torch.isfinite(loss)) and bool(torch.isfinite(grad).all()),
          "run D: non-finite loss or gradient")
    check(gmax > 0.0, "run D: zero vertex gradient")
    for name in ("reinit_step", "minmax_step", "reinit_step_vjp",
                 "minmax_step_vjp"):
        check(launches[name] > 0, f"run D: {name} never launched")
    check(branches == {"reinit_fixed": "sqrtn",
                       "minmax_flow_fixed": "flat"},
          f"run D: reverse branches {branches}")
    phase("run D", f"grid {grid.shape} dx {grid.dx:.6g}, {ball.n_elems} "
          f"triangles, reinit 50 / min/max 20 steps, 64x64 image: loss "
          f"{float(loss):.6g}, max|grad| {gmax:.6g}, launches {launches}, "
          f"branches {branches}, peak {peak:.2f} GiB, forward+backward wall "
          f"{wall:.3f} s (culling build {t_build:.3f} s on the host before "
          f"it); card {card}")

    split = stage_split(v, ball.elements, grid, target, kw)
    lrel = abs(float(split["loss"]) - float(loss)) / abs(float(loss))
    gerr = float((split["grad"] - grad).abs().max())
    check(lrel <= 1e-6 and gerr <= 1e-4 * gmax,
          f"run D stages: loss rel {lrel:.3g}, grad max err {gerr:.3g}")
    t, b, pk = split["fwd"], split["bwd"], split["peak"]
    phase("run D", "each stage alone, forward recording its graph / "
          "backward (backward peak): " + ", ".join(
              f"{s} {t[s]:.3f} / {b[s]:.3f} s ({pk[s]:.2f} GiB)"
              for s in ("init", "reinit", "minmax", "render"))
          + f"; {split['hits']} rays hit; the chained gradient equals the "
          f"main path's (loss rel {lrel:.3g}, grad max err {gerr:.3g}, "
          f"gate 1e-4 of max|grad|); card {card}")

    # K5 and K6 on the inputs run D gives them: K5 at the last reinit step
    # (phi after 49 K1 steps, the sign source phi0), K6 at the first
    # min/max step (the reinit output)
    dx, phi0 = grid.dx, split["phi0"]
    p = phi0
    for _ in range(kw["reinit_steps"] - 1):
        p = wc.reinit_step(p, phi0, dx, 0.1 * dx)
    adjoint_checks(record, p, phi0, split["phi1"], dx, 0.1 * dx,
                   0.01 * dx * dx, False, label=" run D's inputs")
    del p, split["phi1"]
    torch.cuda.empty_cache()
    return launches, {"loss": loss, "grad": grad, "wall": wall, "peak": peak,
                      "phi0": phi0, "grid": grid, "kw": kw}


def stage_split(v, elements, grid, target, kw):
    """Run D's gradient one stage at a time: each stage's forward
    (recording its graph) on the detached output of the one before, then
    each backward, last stage first, fed the cotangent the stage after it
    produced, so the chain computes the main path's gradient."""
    import torch
    from levelsetfortran_tpu_torch.ops.init_sign import signed_distance_init
    from levelsetfortran_tpu_torch.render.sphere_trace import (camera_rays,
                                                               render)
    from levelsetfortran_tpu_torch.solvers.minmax_flow import \
        minmax_flow_fixed
    from levelsetfortran_tpu_torch.solvers.reinit import reinit_fixed

    # torch.autograd.backward imports sympy on its first call with a tensor
    # cotangent (seconds on a cold host); pay that before the clock starts
    w = torch.zeros(2, device=v.device, requires_grad=True)
    torch.autograd.backward(2.0 * w, torch.ones_like(w))
    dx, fwd, bwd, peak = grid.dx, {}, {}, {}
    vv = v.detach().requires_grad_(True)
    phi0, fwd["init"] = sync_time(lambda: signed_distance_init(
        grid, vv, elements, dtype=vv.dtype, device=vv.device,
        culling=kw["culling"]))
    x0 = phi0.detach().requires_grad_(True)
    phi1, fwd["reinit"] = sync_time(lambda: reinit_fixed(
        x0, dx, 0.1 * dx, kw["reinit_steps"]))
    x1 = phi1.detach().requires_grad_(True)
    phi2, fwd["minmax"] = sync_time(lambda: minmax_flow_fixed(
        x1, dx, 0.01 * dx * dx, kw["minmax_steps"]))
    x2 = phi2.detach().requires_grad_(True)

    def render_loss():
        origins, dirs = camera_rays(kw["height"], kw["width"], eye=kw["eye"],
                                    target=kw["target"], dtype=x2.dtype,
                                    device=x2.device)
        out = render(x2, grid, origins, dirs, n_steps=64, hit_tol=0.25 * dx)
        return out, 0.5 * torch.sum((out.image - target) ** 2)

    (out, loss), fwd["render"] = sync_time(render_loss)
    for stage, y, x in (("render", loss, None), ("minmax", phi2, x2),
                        ("reinit", phi1, x1), ("init", phi0, x0)):
        torch.cuda.reset_peak_memory_stats()
        _, bwd[stage] = sync_time(partial(
            torch.autograd.backward, y, None if x is None else x.grad))
        peak[stage] = torch.cuda.max_memory_allocated() / 2 ** 30
    return {"fwd": fwd, "bwd": bwd, "peak": peak, "loss": loss.detach(),
            "grad": vv.grad, "hits": int(out.hit.sum()),
            "phi0": phi0.detach(), "phi1": phi1.detach()}


def small_holds(device="cuda"):
    """The 24^3 octahedron on the card against the CPU plain path, and the
    directional finite-difference gate of tests/test_render.py on CUDA."""
    import torch
    from levelsetfortran_tpu_torch import image_loss_and_vertex_grad
    from levelsetfortran_tpu_torch.grid.grid import Grid3D
    from levelsetfortran_tpu_torch.ops.init_sign import signed_distance_init
    from levelsetfortran_tpu_torch.render.sphere_trace import (camera_rays,
                                                               trace_depth)
    from levelsetfortran_tpu_torch.solvers.reinit import reinit_fixed

    v = 0.7 * np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                        [0, 0, 1], [0, 0, -1]], np.float32)
    f = np.array([[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4],
                  [2, 0, 5], [1, 2, 5], [3, 1, 5], [0, 3, 5]], np.int32)
    n, half = 24, 1.2
    grid = Grid3D(shape=(n, n, n), origin=(-half,) * 3,
                  dx=2 * half / (n - 1))
    kw = dict(eye=(0.0, -3.0, 0.0), target=(0.0, 0.0, 0.0), reinit_steps=5,
              minmax_steps=3, height=12, width=12, n_march_steps=48)
    res = {}
    for dev in (device, "cpu"):
        res[dev] = image_loss_and_vertex_grad(
            torch.tensor(v, device=dev), f, grid,
            torch.zeros((12, 12), device=dev), **kw)
    (lg, gg), (lc, gc) = res[device], res["cpu"]
    lrel = abs(float(lg) - float(lc)) / abs(float(lc))
    gerr = float((gg.cpu() - gc).abs().max())
    check(lrel <= 1e-4 and torch.allclose(gg.cpu(), gc, atol=1e-4,
                                          rtol=1e-3) and gc.abs().max() > 0,
          f"octahedron: loss rel {lrel:.3g}, grad max err {gerr:.3g}")

    origins, dirs = camera_rays(8, 8, eye=(0.0, -3.0, 0.0),
                                target=(0.0, 0.0, 0.0), device=device)

    def loss(vv):
        phi0 = signed_distance_init(grid, vv, f)
        phi = reinit_fixed(phi0, grid.dx, 0.1 * grid.dx, 3)
        t = trace_depth(phi, grid, origins, dirs, 200, 0.01 * grid.dx, 10.0)
        return torch.sum(t[3:5, 3:5] ** 2)

    rng = np.random.default_rng(0)
    d = torch.tensor(rng.standard_normal(v.shape), dtype=torch.float32,
                     device=device)
    d = 0.3 * d / torch.linalg.vector_norm(d)
    vt = torch.tensor(v, device=device, requires_grad=True)
    loss(vt).backward()
    ana = float(torch.sum(vt.grad * d))
    base, eps = torch.tensor(v, device=device), 1e-3
    with torch.no_grad():
        num = (float(loss(base + eps * d)) - float(loss(base - eps * d))) \
            / (2 * eps)
    fd = abs(ana - num) / max(1.0, abs(num))
    check(fd < 0.15, f"finite difference: analytic {ana}, numeric {num}")
    phase("run D", f"octahedron 24^3 on the card vs the CPU plain path: "
          f"loss {float(lg):.7g} vs {float(lc):.7g} (rel {lrel:.3g}, tol "
          f"1e-4), grad max abs err {gerr:.3g} (atol 1e-4, rtol 1e-3); "
          f"finite difference {num:.5g} vs analytic {ana:.5g} (rel "
          f"{fd:.3g}, gate 0.15)")


def packed_inputs(shape, dx):
    """B spheres of growing radius on (nx, ny, nz): phi (the SDF doubled,
    so a reinit step has work), a sign source 10% larger (it differs from
    phi in sign and value), and per-geometry h and h1 rounded once in
    float32; every geometry but FROZEN live."""
    import torch
    radii = [0.25 * (min(shape) - 1) * dx * (1.0 + 0.1 * b)
             for b in range(PACK_B)]
    phi = torch.stack([2.0 * sphere(shape, dx, r) for r in radii])
    sgn = torch.stack([sphere(shape, dx, 1.1 * r) for r in radii])
    h = np.float32(0.1 * dx) / (1.0 + 0.25 * np.arange(PACK_B,
                                                      dtype=np.float32))
    live = torch.ones(PACK_B, dtype=torch.int32, device="cuda")
    live[FROZEN] = 0
    return phi, sgn, h, np.float32(0.01) * h, live


def packed_holds(name, kern, plain, solo, phi, live):
    """One pack kernel against a second launch (bitwise), each live
    geometry's solo launch (bitwise, fields and sums), the frozen geometry
    (a copy, sum 0) and its plain version (max_abs_err, sums rel)."""
    import torch
    (k, kd), (k2, kd2) = kern(live), kern(live)
    check(torch.equal(k, k2) and torch.equal(kd, kd2),
          f"{name} {tuple(phi.shape)}: two launches differ")
    for b in range(phi.shape[0]):
        if b == FROZEN:
            check(torch.equal(k[b], phi[b]) and float(kd[b]) == 0.0,
                  f"{name}: frozen geometry {b} changed")
            continue
        s, sd = solo(b)
        check(torch.equal(k[b], s) and float(kd[b]) == float(sd),
              f"{name} {tuple(phi.shape)}: geometry {b} differs from its "
              f"solo launch ({err(k[b], s):.3g}, dsq {float(kd[b])!r} vs "
              f"{float(sd)!r})")
    p, pd = plain(live)
    e = err(k, p)
    rel = float(((kd - pd).abs() / pd.clamp_min(1e-30)).max())
    check(e == 0.0 and rel <= 1e-5,
          f"{name} {tuple(phi.shape)}: max_abs_err {e:.3g} vs plain, dsq "
          f"rel {rel:.3g}")
    return k, e, rel


def packed_phase(record, run_e_shape):
    """Phase 2b: the pack modes of K1 and K3 at (B, 64^3) and at run E's
    own shape, each against a second launch, B solo launches and its plain
    version; one packed launch timed against B solo launches."""
    import torch
    from levelsetfortran_tpu_torch.ops import minmax_cuda as mc
    from levelsetfortran_tpu_torch.ops import weno_cuda as wc

    for shape, dx in (((64, 64, 64), 0.03), (run_e_shape, RUN_E_DX)):
        main = shape == run_e_shape
        phi, sgn, h, h1, live = packed_inputs(shape, dx)
        all_live = torch.ones_like(live)
        hv = torch.tensor(h, device="cuda")
        h1v = torch.tensor(h1, device="cuda")
        cells = phi[0].numel()

        def k1(lv):
            return wc.reinit_step_packed(phi, sgn, dx, hv, lv, with_rms=True)

        def k1_solo(b):
            return wc.reinit_step(phi[b], sgn[b], dx, float(h[b]),
                                  with_rms=True)

        mm_phi, e1, rel1 = packed_holds(
            "K1 pack", k1, lambda lv: wc.reinit_step_packed_plain(
                phi, sgn, dx, h, lv, with_rms=True), k1_solo, phi, live)

        def k3(lv):
            return mc.minmax_step_packed(mm_phi, dx, h1v, lv, with_rms=True)

        def k3_solo(b):
            return mc.minmax_step(mm_phi[b], dx, float(h1[b]), with_rms=True)

        _, e3, rel3 = packed_holds(
            "K3 pack", k3, lambda lv: mc.minmax_step_packed_plain(
                mm_phi, dx, h1, lv, with_rms=True), k3_solo, mm_phi, live)

        # timed with every geometry live, as in run E's first steps: the
        # packed launch, the B solo launches, the plain version and the
        # bound all do the same work
        for rname, kern, solo, plain, e, rel, nbytes, ops in (
                ("reinit_step_packed", k1, k1_solo,
                 lambda: wc.reinit_step_packed_plain(phi, sgn, dx, h,
                                                     all_live, with_rms=True),
                 e1, rel1, 12 * PACK_B * cells,
                 OPS["reinit"] * PACK_B * cells),
                ("minmax_step_packed", k3, k3_solo,
                 lambda: mc.minmax_step_packed_plain(mm_phi, dx, h1, all_live,
                                                     with_rms=True),
                 e3, rel3, 8 * PACK_B * cells,
                 OPS["minmax_band"] * sum(band_cells(mm_phi[b], dx)
                                          for b in range(PACK_B))
                 + OPS["rms"] * PACK_B * cells)):
            rec = record[rname]
            rec["max_abs_err"] = max(rec["max_abs_err"], e)
            t_pack = median_ms(lambda: kern(all_live), 20)
            t_solo = median_ms(lambda: [solo(b) for b in range(PACK_B)], 20)
            if main:
                rec.update(ms=t_pack, solo_ms=t_solo,
                           device_ms=device_ms(lambda: kern(all_live)),
                           plain_ms=median_ms(plain, 3), **bound(nbytes, ops))
            phase("kernels", f"{rname} {(PACK_B, *shape)}, geometry "
                  f"{FROZEN} frozen: every live geometry bitwise equal to "
                  f"its solo launch (field and dsq), the frozen one "
                  f"unchanged with dsq 0, two launches bitwise equal, "
                  f"max_abs_err vs plain {e:.3g} (tol 0), dsq rel {rel:.3g} "
                  f"(tol 1e-5); all {PACK_B} live: one packed launch "
                  f"{t_pack:.4f} ms vs {PACK_B} solo launches "
                  f"{t_solo:.4f} ms; card {CARD}")
        del phi, sgn, mm_phi
        torch.cuda.empty_cache()
    for rname in ("reinit_step_packed", "minmax_step_packed"):
        rec = record[rname]
        phase("kernels", f"{rname} at {(PACK_B, *run_e_shape)}, all live: "
              f"kernel "
              f"{rec['ms']:.4f} ms (device {rec['device_ms']:.4f} ms), "
              f"{PACK_B} solo launches "
              f"{rec['solo_ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, "
              f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}); card "
              f"{CARD}")


def in_grid_cells(pad, geom):
    """Cells of a padded block that lie inside the global grid: the cells a
    block-mode launch reads (halo cells past a global face are never)."""
    n = 1
    for p, o, g in zip(pad.shape, geom.origin, geom.gshape):
        n *= min(o + p, g) - max(o, 0)
    return n


def written_cells(step, pad):
    """Cells a dense K1 block-mode launch ``step(out)`` writes: the in-grid
    cells whose stencil stays inside the array, which k steps per exchange
    need stepped.  Counted from a launch into an output of NaNs (the input
    is finite)."""
    import torch
    out = torch.full_like(pad, float("nan"))
    step(out)
    return int((~torch.isnan(out)).sum())


def block_phase(record):
    """Phase 2c: the block modes of K1 and K3 on the card."""
    import torch
    from levelsetfortran_tpu_torch.ops import minmax_cuda as mc
    from levelsetfortran_tpu_torch.ops import weno_cuda as wc
    from levelsetfortran_tpu_torch.parallel import sharded as sh
    from levelsetfortran_tpu_torch.parallel.halo import crop, halo_exchange
    from levelsetfortran_tpu_torch.parallel.mesh import (gather_blocks,
                                                         make_mesh,
                                                         split_blocks)

    for shape, mshape, dx, radius in ((MAIN_SHAPE, (2, 2, 1), 0.01, 1.0),
                                      ((66, 46, 38), (2, 2, 2), 0.05, 0.6)):
        main = shape == MAIN_SHAPE
        mesh = make_mesh(mshape, ["cuda"])
        phi, sgn = sphere(shape, dx, radius), sphere(shape, dx, 1.1 * radius)
        h, h1 = 0.1 * dx / 3.0, 0.01 * dx / 3.0
        blocks, sblocks = split_blocks(mesh, phi), split_blocks(mesh, sgn)

        def gather(bl):
            return gather_blocks(mesh, bl)

        # K1: every block against its plain version over the whole padded
        # output, the gathered field and the summed owned-range sums
        # against the solo kernel on the whole grid
        w = sh.sharded_widths(mesh, sh.HALO)
        geoms = sh.reinit_geoms(mesh, shape, w)
        pads = [p.contiguous() for p in halo_exchange(blocks, w, mesh)]
        spads = [p.contiguous() for p in halo_exchange(sblocks, w, mesh)]
        e1, eb, owned, sums, frozen = 0.0, 0.0, [], [], [0, 0]
        for p, sp, g in zip(pads, spads, geoms):
            check(twice_equal(lambda: wc.reinit_step_block(
                p, sp, dx, h, g, with_rms=True)),
                f"K1 block {shape}: two launches differ")
            k, kd = wc.reinit_step_block(p, sp, dx, h, g, with_rms=True)
            q, qd = wc.reinit_step_block_plain(p, sp, dx, h, g,
                                               with_rms=True)
            e1 = max(e1, err(k, q))
            check(abs(float(kd) - float(qd)) <= 1e-5 * float(qd),
                  f"K1 block {shape}: dsq {float(kd)} vs plain {float(qd)}")
            owned.append(crop(k, w))
            sums.append(float(kd))
            # banded: a real mask from the exchanged block; against the
            # plain version, and against the dense launch on active bricks
            act = wc.tile_activity(p, dx, 8.1, h / dx, window="band4",
                                   geom=g)
            frozen[0] += int(act.numel() - act.sum())
            frozen[1] += act.numel()
            kb = wc.reinit_step_block(p, sp, dx, h, g, active=act)
            eb = max(eb, err(kb, wc.reinit_step_block_plain(
                p, sp, dx, h, g, active=act)))
            live = wc.brick_cells(act, p.shape, g.brick_origin)
            check(torch.equal(kb[live], k[live]),
                  f"K1 block {shape}: banded differs from dense on active "
                  f"bricks")
        solo, sd = wc.reinit_step(phi, sgn, dx, h, with_rms=True)
        rel1 = abs(sum(sums) - float(sd)) / float(sd)
        check(e1 <= 1e-6 and eb <= 1e-6, f"K1 block {shape}: max_abs_err "
              f"{e1:.3g} dense, {eb:.3g} banded")
        check(torch.equal(gather(owned), solo),
              f"K1 block {shape}: gathered field differs from the solo "
              f"kernel ({err(gather(owned), solo):.3g})")
        check(rel1 <= 1e-12, f"K1 block {shape}: owned sums rel {rel1:.3g}")
        check(not main or 0 < frozen[0] < frozen[1], "K1 block: mask skips")

        # two steps: k = 1, k = 2 and the overlapped step, all bitwise the
        # solo kernel's two steps; one overlapped step against the plain
        # block step
        two = wc.reinit_step(solo, sgn, dx, h)
        rms = {}
        for label, kw in (("k=1", {}), ("k=2", {"steps_per_exchange": 2}),
                          ("overlap", {"overlap": True})):
            s = sh.ShardedLevelSet(mesh, shape, dx, **kw)
            check(label != "overlap" or s.use_overlap,
                  f"K1 block {shape}: no interior bricks to overlap")
            out, n, rms[label] = s.reinit(blocks, h, 2, 0.0,
                                          sign_src=sblocks)
            check(n == 2 and torch.equal(gather(out), two),
                  f"K1 block {shape} {label}: two steps differ from the "
                  f"solo kernel's ({err(gather(out), two):.3g})")
        one = s.reinit_step(blocks, sblocks, h)
        plain1 = sh.reinit_step_local(blocks, sblocks, dx, h, gshape=shape,
                                      mesh=mesh)
        e_ov = err(gather(one), gather(plain1))
        check(e_ov <= 1e-6 and torch.equal(gather(one), solo),
              f"K1 block {shape}: overlapped step vs plain block step "
              f"{e_ov:.3g}")
        rec = record["reinit_step_block"]
        rec["max_abs_err"] = max(rec["max_abs_err"], e1, eb, e_ov)
        if main:
            p, sp, g = pads[0], spads[0], geoms[0]
            buf = torch.zeros_like(p)
            # the halo is read and not stepped: bytes over the in-grid
            # cells (phi and the sign source) and the written cells,
            # operations over the written cells only
            cells = in_grid_cells(p, g)
            stepped = written_cells(lambda o: wc.reinit_step_block(
                p, sp, dx, h, g, out=o), p)
            check(blocks[0].numel() <= stepped < cells,
                  f"K1 block: {stepped} cells written of {cells} in the grid")
            rec["ms"] = median_ms(lambda: wc.reinit_step_block(
                p, sp, dx, h, g, out=buf, with_rms=True), 20)
            rec["device_ms"] = device_ms(lambda: wc.reinit_step_block(
                p, sp, dx, h, g, out=buf, with_rms=True))
            rec["plain_ms"] = median_ms(lambda: wc.reinit_step_block_plain(
                p, sp, dx, h, g, out=buf, with_rms=True), 3)
            rec["shape"] = list(p.shape)
            rec["cells"] = (cells, stepped, blocks[0].numel())
            rec.update(bound(8 * cells + 4 * stepped,
                             OPS["reinit"] * stepped
                             + OPS["rms"] * blocks[0].numel()))
            t4 = median_ms(lambda: [wc.reinit_step_block(
                a, b, dx, h, c, out=buf, with_rms=True)
                for a, b, c in zip(pads, spads, geoms)], 20)
            t1 = median_ms(lambda: wc.reinit_step(phi, sgn, dx, h,
                                                  with_rms=True), 20)
            rec["all_blocks_ms"], rec["solo_ms"] = t4, t1
        phase("kernels", f"K1 block {shape} on {mshape}, padded blocks "
              f"{tuple(pads[0].shape)}: two launches bitwise equal, "
              f"max_abs_err vs plain {e1:.3g} dense, "
              f"{eb:.3g} banded ({frozen[0]}/{frozen[1]} bricks frozen; "
              f"equal to dense on active bricks), tol 1e-6; gathered field "
              f"bitwise equal to the solo kernel; owned sums rel {rel1:.3g} "
              f"(tol 1e-12); two steps with k=1, k=2 and overlapped bitwise "
              f"equal to the solo kernel's (rms {rms['k=1']:.9g} / "
              f"{rms['k=2']:.9g} / {rms['overlap']:.9g}); overlapped step "
              f"vs plain block step {e_ov:.3g}")
        del pads, spads, owned, solo, two, out, one, plain1
        torch.cuda.empty_cache()

        # K3: a halo of one cell; on a field after one K1 step
        mphi = wc.reinit_step(phi, sgn, dx, h)
        mblocks = split_blocks(mesh, mphi)
        w1 = sh.sharded_widths(mesh, 1)
        mgeoms = sh.minmax_geoms(mesh, shape, w1)
        mpads = [p.contiguous() for p in halo_exchange(mblocks, w1, mesh)]
        acts = sh.minmax_tile_activity_local(mblocks, dx, 4.1)
        e3, owned, banded, sums = 0.0, [], [], []
        for p, g, a in zip(mpads, mgeoms, acts):
            check(twice_equal(lambda: mc.minmax_step_block(
                p, dx, h1, g, with_rms=True)),
                f"K3 block {shape}: two launches differ")
            k, kd = mc.minmax_step_block(p, dx, h1, g, with_rms=True)
            q, qd = mc.minmax_step_block_plain(p, dx, h1, g, with_rms=True)
            kb = mc.minmax_step_block(p, dx, h1, g, active=a)
            e3 = max(e3, err(k, q), err(kb, mc.minmax_step_block_plain(
                p, dx, h1, g, active=a)))
            check(abs(float(kd) - float(qd)) <= 1e-5 * float(qd),
                  f"K3 block {shape}: dsq {float(kd)} vs plain {float(qd)}")
            owned.append(crop(k, w1))
            banded.append(crop(kb, w1))
            sums.append(float(kd))
        solo, sd = mc.minmax_step(mphi, dx, h1, with_rms=True)
        rel3 = abs(sum(sums) - float(sd)) / float(sd)
        nfrozen = sum(int(a.numel() - a.sum()) for a in acts)
        check(e3 <= 1e-7, f"K3 block {shape}: max_abs_err {e3:.3g}")
        check(torch.equal(gather(owned), solo)
              and torch.equal(gather(banded), solo),
              f"K3 block {shape}: gathered field differs from the solo "
              f"kernel ({err(gather(owned), solo):.3g} dense, "
              f"{err(gather(banded), solo):.3g} banded)")
        check(rel3 <= 1e-12, f"K3 block {shape}: owned sums rel {rel3:.3g}")
        check(not main or nfrozen > 0, "K3 block: mask skips")
        s = sh.ShardedLevelSet(mesh, shape, dx, narrow_band=True)
        out, n, _ = s.minmax_flow(mblocks, h1, 3, 0.0)
        q = mphi
        for _ in range(3):
            q = mc.minmax_step(q, dx, h1)
        check(n == 3 and torch.equal(gather(out), q),
              f"K3 block {shape}: three banded sharded steps differ from "
              f"the solo kernel's ({err(gather(out), q):.3g})")
        rec = record["minmax_step_block"]
        rec["max_abs_err"] = max(rec["max_abs_err"], e3)
        if main:
            p, g = mpads[0], mgeoms[0]
            buf = torch.zeros_like(p)
            rec["ms"] = median_ms(lambda: mc.minmax_step_block(
                p, dx, h1, g, out=buf, with_rms=True), 20)
            rec["device_ms"] = device_ms(lambda: mc.minmax_step_block(
                p, dx, h1, g, out=buf, with_rms=True))
            rec["plain_ms"] = median_ms(lambda: mc.minmax_step_block_plain(
                p, dx, h1, g, out=buf, with_rms=True), 10)
            rec["shape"] = list(p.shape)
            # the width-1 halo is read; the owned cells are written
            cells, stepped = in_grid_cells(p, g), mblocks[0].numel()
            rec["cells"] = (cells, stepped, stepped)
            rec.update(bound(4 * cells + 4 * stepped,
                             # owned in-band cells (those on a global face
                             # are far outside the band on this field)
                             OPS["minmax_band"] * band_cells(p, dx)
                             + OPS["rms"] * mblocks[0].numel()))
            rec["all_blocks_ms"] = median_ms(lambda: [mc.minmax_step_block(
                a, dx, h1, c, out=buf, with_rms=True)
                for a, c in zip(mpads, mgeoms)], 20)
            rec["solo_ms"] = median_ms(lambda: mc.minmax_step(
                mphi, dx, h1, with_rms=True), 20)
        phase("kernels", f"K3 block {shape} on {mshape}, padded blocks "
              f"{tuple(mpads[0].shape)}: two launches bitwise equal, "
              f"max_abs_err vs plain {e3:.3g} (tol "
              f"1e-7), gathered field bitwise equal to the solo kernel, "
              f"dense and banded ({nfrozen} bricks frozen); owned sums rel "
              f"{rel3:.3g} (tol 1e-12); three banded sharded steps bitwise "
              f"equal to the solo kernel's")
        del mpads, owned, banded, solo, out, q, phi, sgn, mphi
        torch.cuda.empty_cache()
    for name in ("reinit_step_block", "minmax_step_block"):
        rec = record[name]
        phase("kernels", f"{name}, one padded block {tuple(rec['shape'])} "
              f"of {MAIN_SHAPE} on (2, 2, 1): kernel {rec['ms']:.4f} ms "
              f"(device {rec['device_ms']:.4f} ms), "
              f"plain {rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.4f} "
              f"ms ({rec['bound_by']}; {rec['cells'][0]} in-grid cells read, "
              f"{rec['cells'][1]} stepped, {rec['cells'][2]} owned); the 4 "
              f"blocks {rec['all_blocks_ms']:.4f}"
              f" ms vs one solo launch on the whole grid "
              f"{rec['solo_ms']:.4f} ms; card {CARD}")


def run_f_phase(ball, ball_sdf, res_b, card, tmp):
    """Phase 6: run B's mesh through the domain-decomposed pipeline."""
    import logging

    import torch
    from levelsetfortran_tpu_torch import LevelSetConfig
    from levelsetfortran_tpu_torch.ops.init_sign import \
        signed_distance_init_sharded
    from levelsetfortran_tpu_torch.parallel import sharded as sh
    from levelsetfortran_tpu_torch.parallel.mesh import (gather_blocks,
                                                         make_mesh)
    from levelsetfortran_tpu_torch.solvers.minmax_flow import minmax_flow
    from levelsetfortran_tpu_torch.solvers.reinit import reinit
    from levelsetfortran_tpu_torch.utils.logging import logger

    dx, logged = 0.01, []

    class Keep(logging.Handler):
        def emit(self, rec):
            logged.append(json.loads(rec.getMessage()))

    handler = Keep()
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        launches, res = run_phase("F", ball, ball_sdf, dx,
                                  ["--mesh-shape", "2,2,1"], tmp)
    finally:
        logger.removeHandler(handler)
    check(res.grid.shape == res_b.grid.shape, "run F: grid differs from B's")
    # where the run says it put its shards: round-robin over every visible
    # card (all four blocks on the one card when there is one)
    events = [r for r in logged if r["stage"] == "grid"]
    devices = [f"cuda:{i}" for i in range(min(4, torch.cuda.device_count()))]
    check(len(events) == 1 and events[0]["mesh"] == [2, 2, 1]
          and events[0]["devices"] == devices
          and events[0]["narrow_band"] and not events[0]["overlap"],
          f"run F: grid event {events}")
    cfg = LevelSetConfig(dx=dx)
    diag = float(np.sqrt(((ball.vertices.max(0)
                           - ball.vertices.min(0)) ** 2).sum()))
    h, h1 = cfg.reinit_cfl * dx / diag, cfg.minmax_cfl * dx / diag
    band = np.abs(res_b.phi_init) < cfg.stencil_band_radius * dx
    d_init = np.abs(res.phi_init - res_b.phi_init)[band].max()
    d_smooth = np.abs(res.phi_smoothed - res_b.phi_smoothed)[band].max()
    d_adv = np.abs(res.advected - res_b.advected).max()
    # the two runs stop on other checks (the sharded solvers read the RMS
    # every exchange, the solo banded ones every chunk): a reinit step moves
    # a cell by at most h, a min/max step past its stop by at most
    # tol * sqrt(cells)
    dr = abs(res.reinit_iters - res_b.reinit_iters)
    dm = abs(res.minmax_iters - res_b.minmax_iters)
    cells = float(np.prod([n - 1 for n in res.grid.shape]))
    gate_init = 1.05 * h * max(1, dr)
    gate_smooth = gate_init + dm * cfg.minmax_tol * np.sqrt(cells)
    t = res.timers
    stages = {"init": t["search"], "reinit": t["initialization"] - t["search"],
              "minmax": t["minmax"] - t["initialization"],
              "advect": t["advect"] - t["minmax"],
              "final reinit": t["total"] - t["advect"]}
    tb = res_b.timers
    block = tuple(n // m for n, m in zip(res.grid.shape, (2, 2, 1)))
    phase("run F", f"mesh (2, 2, 1) on {len(devices)} card(s) "
          f"{events[0]['devices']}, blocks {block}: reinit_iters {res.reinit_iters} (run "
          f"B {res_b.reinit_iters}), minmax_iters {res.minmax_iters} (run B "
          f"{res_b.minmax_iters}); against run B in the band: phi_init max "
          f"diff {d_init:.3g} (gate {gate_init:.3g}), phi_smoothed "
          f"{d_smooth:.3g} (gate {gate_smooth:.3g}), advected nodes "
          f"{d_adv:.3g}; stage walls " + ", ".join(
              f"{k} {v:.3f} s" for k, v in stages.items())
          + f", total {t['total']:.3f} s (run B total {tb['total']:.3f} s, "
          f"init {tb['search']:.3f} s, advect "
          f"{tb['advect'] - tb['minmax']:.3f} s); card {card}")
    check(d_init <= gate_init, f"run F: phi_init differs from B {d_init}")
    check(d_smooth <= gate_smooth, f"run F: phi_smoothed differs {d_smooth}")

    # the solver stages once more on run F's init (built again, on run F's
    # devices), at run F's counts with the stop test off: dense, two steps
    # per exchange and overlapped, bitwise equal to each other and to the
    # solo dense solvers
    mesh = make_mesh((2, 2, 1), devices)
    shape = res.grid.shape
    blocks = signed_distance_init_sharded(
        res.grid, ball.vertices, ball.elements, mesh, dtype=cfg.dtype,
        cull_block=cfg.init_cull_block)
    check({str(b.device) for b in blocks} == set(devices)
          and all(tuple(b.shape) == block for b in blocks),
          "run F: the init's blocks are not on the mesh's devices")
    whole = gather_blocks(mesh, blocks)
    n_r = res.reinit_iters + res.reinit_iters % 2
    n_m = res.minmax_iters
    ref_r, t_sr = sync_time(lambda: reinit(whole, dx, h, n_r, 0.0))
    ref_m, t_sm = sync_time(lambda: minmax_flow(ref_r.phi, dx, h1, n_m, 0.0))
    walls = {}
    for label, kw in (("dense", {}), ("k=2", {"steps_per_exchange": 2}),
                      ("overlap", {"overlap": True})):
        s = sh.ShardedLevelSet(mesh, shape, dx, **kw)
        check(label != "overlap" or s.use_overlap, "run F: no overlap")
        (pr, nr, _), t_r = sync_time(lambda: s.reinit(blocks, h, n_r, 0.0))
        (pm, nm, _), t_m = sync_time(lambda: s.minmax_flow(pr, h1, n_m, 0.0))
        check(nr == n_r and torch.equal(gather_blocks(mesh, pr), ref_r.phi),
              f"run F {label}: sharded reinit differs from the solo solver")
        check(nm == n_m and torch.equal(gather_blocks(mesh, pm), ref_m.phi),
              f"run F {label}: sharded min/max differs from the solo solver")
        walls[label] = (t_r, t_m)
    phase("run F", f"solver stages on run F's init on {len(devices)} "
          f"card(s) at fixed counts (reinit "
          f"{n_r}, min/max {n_m} steps, stop test off): sharded dense, k=2 "
          f"and overlapped fields bitwise equal to the solo dense solvers'; "
          f"reinit / min/max walls " + ", ".join(
              f"{k} {a:.4f} / {b:.4f} s" for k, (a, b) in walls.items())
          + f", solo {t_sr:.4f} / {t_sm:.4f} s; card {card}")
    return launches


def owned_near(geom, reach):
    """Cells of the global grid within ``reach`` of ``geom``'s owned box:
    the cells whose stencil cotangents a block-mode K5 evaluates (reach 3),
    or the owned cells (reach 0)."""
    box, n = geom.box(), 1
    for a, g in enumerate(geom.gshape):
        n *= min(box[2 * a + 1] + reach, g) - max(box[2 * a] - reach, 0)
    return n


def band_cells_owned(block, geom, dx, radius=4.1):
    """Owned cells of a block that a min/max step updates: in band and
    inside the global grid's faces."""
    from levelsetfortran_tpu_torch.ops.stencil import global_interior_mask
    origin = tuple(geom.box()[2 * a] for a in range(3))
    band = block.abs() < float(np.float32(radius) * np.float32(dx))
    return int((band & global_interior_mask(block.shape, origin, geom.gshape,
                                             1, block.device)).sum())


def rel_errs(k, p, nf):
    """Field cotangents relative to the plain version's max |cot|, the
    scalars relative to themselves."""
    fields = [err(a, b) / max(float(b.abs().max()), 1e-30)
              for a, b in zip(k[:nf], p[:nf])]
    scalars = [abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)
               for a, b in zip(k[nf:], p[nf:])]
    return fields, max(scalars)


def block_adjoint_holds(kid, mesh, shape, fields, width, geoms, kern, plain,
                        solo, tol):
    """One block-mode adjoint on every shard: against a second launch
    (bitwise) and its plain version (relative to max|cot|, or bitwise when
    ``tol`` is None, and its max_abs_err), the gathered owned cotangents
    against the solo kernel on the whole grid (bitwise) and the shards'
    scalar sums, added in shard order, against the solo ones.  Returns
    (max_abs_err, scalar rel vs solo, pads)."""
    import torch
    from levelsetfortran_tpu_torch.parallel.halo import halo_exchange
    from levelsetfortran_tpu_torch.parallel.mesh import (gather_blocks,
                                                         split_blocks)
    pads = [halo_exchange(split_blocks(mesh, f), width, mesh) for f in fields]
    e, outs = 0.0, []
    nf = len(solo) - 2
    for args in zip(*pads, geoms):
        k, k2, p = kern(*args), kern(*args), plain(*args)
        check(all(torch.equal(a, b) for a, b in zip(k, k2)),
              f"{kid} block {shape}: two launches differ")
        rels, srel = rel_errs(k, p, nf)
        exact = all(bitwise(a, b) for a, b in zip(k[:nf], p[:nf]))
        check((exact if tol is None else max(rels) <= tol)
              and srel <= ADJ_TOL["scalars"],
              f"{kid} block {shape}: rel errors {rels}, bitwise {exact}, "
              f"scalars {srel:.3g} against the plain version")
        e = max(e, *(err(a, b) for a, b in zip(k[:nf], p[:nf])))
        outs.append(k)
    for i in range(nf):
        whole = gather_blocks(mesh, [o[i] for o in outs])
        check(torch.equal(whole, solo[i]),
              f"{kid} block {shape}: gathered field cotangent {i} differs "
              f"from the solo kernel's ({err(whole, solo[i]):.3g})")
    srel = 0.0
    for i in range(nf, len(solo)):
        total = 0.0
        for o in outs:
            total += float(o[i])
        srel = max(srel, abs(total - float(solo[i]))
                   / max(abs(float(solo[i])), 1e-30))
    check(srel <= 1e-9, f"{kid} block {shape}: shard sums rel {srel:.3g}")
    return e, srel, pads


def adjoint_mode_phase(record):
    """Phase 2d: the block and banded modes of K5 and K6 on the card.
    Block: the bench sphere (256^3) cut (2,2,1) and (66,46,38) cut (2,2,2),
    each shard against its plain version and a second launch, the gathered
    owned cotangents against the solo kernel, bitwise.  Banded: the bench
    sphere with a real mask, against the plain version and (K6) the dense
    kernel, bitwise."""
    import torch
    from levelsetfortran_tpu_torch.ops import minmax_cuda as mc
    from levelsetfortran_tpu_torch.ops import weno_cuda as wc
    from levelsetfortran_tpu_torch.parallel import sharded as sh
    from levelsetfortran_tpu_torch.parallel.mesh import make_mesh

    for shape, mshape, dx in (((BENCH_N,) * 3, (2, 2, 1), BENCH_DX),
                              ((66, 46, 38), (2, 2, 2), 0.05)):
        main = shape[0] == BENCH_N
        mesh = make_mesh(mshape, ["cuda"])
        phi, sgn = sphere(shape, dx, BENCH_R), sphere(shape, dx,
                                                      1.1 * BENCH_R)
        h, h1 = 0.1 * dx, 0.01 * dx * dx
        g = torch.tensor(np.random.default_rng(7).standard_normal(shape),
                         dtype=torch.float32, device="cuda")
        mphi = wc.reinit_step(phi, sgn, dx, h)
        w5, w6 = (sh.sharded_widths(mesh, wc.VJP_HALO[k])
                  for k in ("reinit", "minmax"))
        g5, g6 = sh.reinit_geoms(mesh, shape, w5), sh.minmax_geoms(
            mesh, shape, w6)
        e5, s5, p5 = block_adjoint_holds(
            "K5", mesh, shape, (phi, sgn, g), w5, g5,
            lambda a, b, c, ge: wc.reinit_step_block_vjp(a, b, c, dx, h, ge),
            lambda a, b, c, ge: wc.reinit_step_block_vjp_plain(
                a, b, c, dx, h, ge),
            wc.reinit_step_vjp(phi, sgn, g, dx, h), ADJ_TOL["K5"])
        solo_bufs = mc.VjpBuffers(mphi, dx, h1)
        e6, s6, p6 = block_adjoint_holds(
            "K6", mesh, shape, (mphi, g), w6, g6,
            lambda a, c, ge: mc.minmax_step_block_vjp(a, c, dx, h1, ge),
            lambda a, c, ge: mc.minmax_step_block_vjp_plain(a, c, dx, h1,
                                                            ge),
            mc.minmax_step_vjp(mphi, g, dx, h1), None)
        record["reinit_step_block_vjp"]["max_abs_err"] = max(
            record["reinit_step_block_vjp"]["max_abs_err"], e5)
        record["minmax_step_block_vjp"]["max_abs_err"] = max(
            record["minmax_step_block_vjp"]["max_abs_err"], e6)
        phase("kernels", f"K5 block / K6 block {shape} on {mshape}, padded "
              f"blocks {tuple(p5[0][0].shape)} / {tuple(p6[0][0].shape)}: "
              f"max_abs_err vs plain {e5:.3g} / {e6:.3g} (tol "
              f"{ADJ_TOL['K5']:g} of max|cot| / bitwise), two "
              f"launches bitwise equal, gathered owned cotangents bitwise "
              f"equal to the solo kernel's, shard sums rel {s5:.3g} / "
              f"{s6:.3g} (tol 1e-9)")
        if main:
            scratch = torch.empty_like(p5[0][0])
            a5 = [x[0] for x in p5] + [g5[0]]
            b5 = [[x[i] for x in p5] + [g5[i]] for i in range(len(g5))]
            rec = record["reinit_step_block_vjp"]
            rec["ms"] = median_ms(lambda: wc.reinit_step_block_vjp(
                *a5[:3], dx, h, a5[3], scratch=scratch), 20)
            rec["plain_ms"] = median_ms(lambda: wc.reinit_step_block_vjp_plain(
                *a5[:3], dx, h, a5[3]), 3)
            rec["all_blocks_ms"] = median_ms(lambda: [
                wc.reinit_step_block_vjp(*b[:3], dx, h, b[3], scratch=scratch)
                for b in b5], 20)
            rec["solo_ms"] = median_ms(lambda: wc.reinit_step_vjp(
                phi, sgn, g, dx, h), 20)
            near, own = owned_near(g5[0], 3), owned_near(g5[0], 0)
            rec["shape"], rec["cells"] = list(p5[0][0].shape), (near, own)
            rec.update(bound(12 * in_grid_cells(p5[0][0], g5[0]) + 8 * own,
                             OPS["reinit_vjp"] * near))
            a6 = [x[0] for x in p6] + [g6[0]]
            b6 = [[x[i] for x in p6] + [g6[i]] for i in range(len(g6))]
            rec = record["minmax_step_block_vjp"]
            rec["ms"] = median_ms(lambda: mc.minmax_step_block_vjp(
                *a6[:2], dx, h1, a6[2]), 20)
            rec["plain_ms"] = median_ms(lambda: mc.minmax_step_block_vjp_plain(
                *a6[:2], dx, h1, a6[2]), 10)
            rec["all_blocks_ms"] = median_ms(lambda: [
                mc.minmax_step_block_vjp(*b[:2], dx, h1, b[2]) for b in b6],
                20)
            rec["solo_ms"] = median_ms(lambda: mc.minmax_step_vjp(
                mphi, g, dx, h1), 20)
            rec["device_ms"] = device_ms(lambda: mc.minmax_step_block_vjp(
                *a6[:2], dx, h1, a6[2]))
            bb = [k6_bufs_holds(f"block {i}", lambda b, x=x: (
                mc.minmax_step_block_vjp(*x[:2], dx, h1, x[2], bufs=b)),
                lambda x=x: mc.VjpBuffers(x[0], dx, h1, geom=x[2]),
                mc.minmax_step_block_vjp(*x[:2], dx, h1, x[2]))
                for i, x in enumerate(b6)]
            k6_host_times(rec, lambda b: mc.minmax_step_block_vjp(
                *a6[:2], dx, h1, a6[2], bufs=b), bb[0])
            rec["all_blocks_bufs_ms"] = median_ms(lambda: [
                mc.minmax_step_block_vjp(*x[:2], dx, h1, x[2], bufs=b)
                for x, b in zip(b6, bb)], 20)
            rec["solo_bufs_ms"] = median_ms(lambda: mc.minmax_step_vjp(
                mphi, g, dx, h1, bufs=solo_bufs), 20)
            own = owned_near(g6[0], 0)
            owned_block = p6[0][0][tuple(
                slice(w, w + n) for w, n in zip(w6, mesh.block_shape(shape)))]
            rec["shape"], rec["cells"] = list(p6[0][0].shape), (own, own)
            rec.update(bound(8 * in_grid_cells(p6[0][0], g6[0]) + 4 * own,
                             OPS["minmax_vjp_band"] * band_cells_owned(
                                 owned_block, g6[0], dx)
                             + OPS["minmax_vjp"] * own))
            del scratch, a5, b5, a6, b6, bb
            banded_adjoint_checks(record, phi, sgn, mphi, g, dx, h, h1)
        del p5, p6, phi, sgn, mphi, g
        torch.cuda.empty_cache()
    for name in ("reinit_step_block_vjp", "minmax_step_block_vjp"):
        rec = record[name]
        k6 = ""
        if "host_ms" in rec:
            k6 = (f"; {k6_times_text(rec)}; with the buffers the 4 blocks "
                  f"{rec['all_blocks_bufs_ms']:.4f} ms vs one solo launch "
                  f"{rec['solo_bufs_ms']:.4f} ms")
        phase("kernels", f"{name}, one padded block {tuple(rec['shape'])} "
              f"of {(BENCH_N,) * 3} on (2, 2, 1): kernel {rec['ms']:.4f} ms, "
              f"plain {rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.4f} "
              f"ms ({rec['bound_by']}; {rec['cells'][0]} cells evaluated, "
              f"{rec['cells'][1]} owned); the 4 blocks "
              f"{rec['all_blocks_ms']:.4f} ms vs one solo launch on the "
              f"whole grid {rec['solo_ms']:.4f} ms{k6}; card {CARD}")
    for name in ("reinit_step_vjp_banded", "minmax_step_vjp_banded"):
        rec = record[name]
        k6 = ""
        if "host_ms" in rec:
            k6 = (f"; {k6_times_text(rec)}, dense device "
                  f"{rec['dense_device_ms']:.4f} ms")
        phase("kernels", f"{name} at {(BENCH_N,) * 3}: kernel "
              f"{rec['ms']:.4f} ms (dense {rec['dense_ms']:.4f} ms), plain "
              f"{rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
              f"({rec['bound_by']}; {rec['active_cells']} cells in active "
              f"bricks){k6}; card {CARD}")


def banded_adjoint_checks(record, phi, sgn, mphi, g, dx, h, h1):
    """The banded K5 and K6 at the bench's setting (``bench.py:328-363``):
    K5 with the band4 mask of a chunk of 5 steps (band radius 8.1, margin
    5 h / dx), K6 with the band4 mask of its own input; each against its
    plain version (K6 bitwise) and a second launch, K6 also against the
    dense kernel, bitwise (fields and sums), and with a solve's buffers."""
    import torch
    from levelsetfortran_tpu_torch.ops import minmax_cuda as mc
    from levelsetfortran_tpu_torch.ops import weno_cuda as wc

    act5 = wc.tile_activity(phi, dx, 8.1, 5 * h / dx, window="band4")
    act6 = wc.tile_activity(mphi, dx, 4.1, window="band4")
    cells = phi.numel()
    for name, kid, act, kern, dense, plain, nf, tol in (
            ("reinit_step_vjp_banded", "K5", act5,
             lambda: wc.reinit_step_vjp_banded(phi, sgn, g, dx, h, act5),
             lambda: wc.reinit_step_vjp(phi, sgn, g, dx, h),
             lambda: wc.reinit_step_vjp_plain(phi, sgn, g, dx, h,
                                              active=act5), 2, ADJ_TOL["K5"]),
            ("minmax_step_vjp_banded", "K6", act6,
             lambda: mc.minmax_step_vjp_banded(mphi, g, dx, h1, act6),
             lambda: mc.minmax_step_vjp(mphi, g, dx, h1),
             lambda: mc.minmax_step_vjp_plain(mphi, g, dx, h1, active=act6),
             1, None)):
        frozen = int(act.numel() - act.sum())
        check(0 < frozen < act.numel(), f"{kid} banded: the mask skips "
              f"nothing or everything ({frozen}/{act.numel()})")
        k, k2, p = kern(), kern(), plain()
        check(all(torch.equal(a, b) for a, b in zip(k, k2)),
              f"{kid} banded: two launches differ")
        rels, srel = rel_errs(k, p, nf)
        e = max(err(a, b) for a, b in zip(k[:nf], p[:nf]))
        exact = all(bitwise(a, b) for a, b in zip(k[:nf], p[:nf]))
        check((exact if tol is None else max(rels) <= tol)
              and srel <= ADJ_TOL["scalars"],
              f"{kid} banded: rel errors {rels}, bitwise {exact}, scalars "
              f"{srel:.3g}")
        same = ""
        rec = record[name]
        if kid == "K6":
            check(all(bitwise(a, b) for a, b in zip(k, dense())),
                  "K6 banded differs from the dense kernel")
            same = (", bitwise equal to the plain version and the dense "
                    "kernel (field and sums), the same with a solve's "
                    "buffers")
            bufs = k6_bufs_holds("banded", lambda b: (
                mc.minmax_step_vjp_banded(mphi, g, dx, h1, act6, bufs=b)),
                lambda: mc.VjpBuffers(mphi, dx, h1), k)
            rec["device_ms"] = device_ms(kern)
            rec["dense_device_ms"] = device_ms(dense)
            k6_host_times(rec, lambda b: mc.minmax_step_vjp_banded(
                mphi, g, dx, h1, act6, bufs=b), bufs)
        live = int(wc.brick_cells(act, phi.shape).sum())
        rec["max_abs_err"] = max(rec["max_abs_err"], e)
        rec["ms"] = median_ms(kern, 20)
        rec["dense_ms"] = median_ms(dense, 20)
        rec["plain_ms"] = median_ms(plain, 3)
        rec["active_cells"] = live
        if kid == "K5":
            rec.update(bound(4 * cells + 8 * live + 8 * cells,
                             OPS["reinit_vjp"] * live))
        else:
            rec.update(bound(4 * cells + 4 * live + 4 * cells,
                             OPS["minmax_vjp_band"] * band_cells(mphi, dx)
                             + OPS["minmax_vjp"] * live))
        phase("kernels", f"{kid} banded {tuple(phi.shape)}: {frozen}/"
              f"{act.numel()} bricks frozen; rel errors "
              f"{', '.join(f'{r:.3g}' for r in rels)} ("
              f"{'bitwise' if tol is None else f'tol {tol:g} of max|cot|'}"
              f"), max_abs_err {e:.3g}, scalars rel {srel:.3g}, two "
              f"launches bitwise equal{same}")


def run_g_phase(ball, card, run_d):
    """Phase 4b, run G: run D's configuration with a (2,2,1) shard mesh on
    one card, against run D in the same call; then the two sharded solvers
    alone on run D's own init, against the solo solvers, bitwise."""
    import torch
    from levelsetfortran_tpu_torch import image_loss_and_vertex_grad
    from levelsetfortran_tpu_torch.ops import minmax_cuda as mc
    from levelsetfortran_tpu_torch.ops import reverse
    from levelsetfortran_tpu_torch.ops import weno_cuda as wc
    from levelsetfortran_tpu_torch.parallel.mesh import make_mesh

    grid = run_d["grid"]
    mesh = make_mesh((2, 2, 1), ["cuda"])
    kw = dict(run_d["kw"], culling="auto", mesh=mesh)
    v = torch.tensor(ball.vertices, dtype=torch.float32, device="cuda")
    target = torch.zeros((64, 64), device="cuda")
    solo = (wc.reinit_step, mc.minmax_step, mc.minmax_fusedk,
            wc.reinit_step_vjp, mc.minmax_step_vjp, wc.reinit_step_vjp_banded,
            mc.minmax_step_vjp_banded)
    blocky = (wc.reinit_step_block, mc.minmax_step_block,
              wc.reinit_step_block_vjp, mc.minmax_step_block_vjp)
    reverse.last_branch.clear()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for c in solo + blocky:
        c.launches = 0
    (loss, grad), wall = sync_time(lambda: image_loss_and_vertex_grad(
        v, ball.elements, grid, target, **kw))
    launches = {c.__name__: c.launches for c in solo + blocky}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    branches = dict(reverse.last_branch)
    gmax = float(grad.abs().max())
    check(bool(torch.isfinite(loss)) and bool(torch.isfinite(grad).all()),
          "run G: non-finite loss or gradient")
    check(gmax > 0.0, "run G: zero vertex gradient")
    check(all(launches[c.__name__] > 0 for c in blocky),
          f"run G: a block-mode kernel never launched {launches}")
    check(all(launches[c.__name__] == 0 for c in solo),
          f"run G: solo kernels launched under a mesh {launches}")
    check(branches == {"reinit_fixed_sharded": "flat",
                       "minmax_fixed_sharded": "flat"},
          f"run G: reverse branches {branches}")
    lrel = abs(float(loss) - float(run_d["loss"])) / abs(float(run_d["loss"]))
    gd = run_d["grad"]
    gerr = float((grad - gd).abs().max())
    dmax = float(gd.abs().max())
    check(lrel <= 1e-4 and torch.allclose(grad, gd, atol=1e-4 * dmax,
                                          rtol=1e-3),
          f"run G vs run D: loss rel {lrel:.3g}, grad max err {gerr:.3g}")
    blk = mesh.block_shape(grid.shape)
    mib = 4 * blk[0] * blk[1] * blk[2] / 2 ** 20
    phase("run G", f"run D with mesh (2, 2, 1) on 1 card, blocks {blk}: loss "
          f"{float(loss):.6g} (run D {float(run_d['loss']):.6g}, rel "
          f"{lrel:.3g}, tol 1e-4), max|grad| {gmax:.6g}, grad max err vs "
          f"run D {gerr:.3g} (atol 1e-4 of {dmax:.4g}, rtol 1e-3); launches "
          f"{launches}; reverse branches per shard ({mib:.1f} MiB blocks) "
          f"{branches}; peak {peak:.2f} GiB (run D {run_d['peak']:.2f}); "
          f"forward+backward wall {wall:.3f} s (run D {run_d['wall']:.3f} s; "
          f"the sharded init builds its culling per block inside it); card "
          f"{card}")

    sharded_solvers_holds(mesh, run_d["phi0"], grid.dx,
                          (kw["reinit_steps"], kw["minmax_steps"]),
                          "run D's init", card)
    return launches


def sharded_solvers_holds(mesh, phi0, dx, steps, what, card):
    """The two sharded solvers alone (``steps`` reinit and min/max steps,
    forward and backward for a normal cotangent) on ``mesh``, bitwise
    against the solo solvers on ``phi0``'s card."""
    import torch
    from levelsetfortran_tpu_torch.parallel import sharded as sh
    from levelsetfortran_tpu_torch.parallel.mesh import (gather_blocks,
                                                         split_blocks)
    from levelsetfortran_tpu_torch.solvers.minmax_flow import \
        minmax_flow_fixed
    from levelsetfortran_tpu_torch.solvers.reinit import reinit_fixed

    wgt = torch.tensor(np.random.default_rng(11).standard_normal(
        tuple(phi0.shape)), dtype=torch.float32, device=phi0.device)

    def solo_solve():
        x = phi0.clone().requires_grad_(True)
        p1 = reinit_fixed(x, dx, 0.1 * dx, steps[0])
        p2 = minmax_flow_fixed(p1, dx, 0.01 * dx * dx, steps[1])
        torch.sum(wgt * p2).backward()
        return p1.detach(), p2.detach(), x.grad

    def sharded_solve():
        xs = [b.requires_grad_(True) for b in split_blocks(mesh, phi0)]
        p1 = sh.reinit_fixed_sharded(mesh, xs, dx, 0.1 * dx, steps[0])
        p2 = sh.minmax_fixed_sharded(mesh, p1, dx, 0.01 * dx * dx, steps[1])
        w = wgt.to(mesh.devices[0])
        torch.sum(w * gather_blocks(mesh, p2)).backward()
        return tuple(gather_blocks(mesh, b, device=phi0.device) for b in (
            [p.detach() for p in p1], [p.detach() for p in p2],
            [x.grad for x in xs]))

    ref, t_solo = sync_time(solo_solve)
    got, t_sh = sync_time(sharded_solve)
    for i, name in enumerate(("reinit output", "min/max output",
                              "gradient")):
        check(torch.equal(got[i], ref[i]),
              f"run G solvers: sharded {name} differs from the solo "
              f"solvers' ({err(got[i], ref[i]):.3g})")
    cards = sorted({str(d) for d in mesh.devices})
    phase("run G", f"the sharded solvers alone on {what} "
          f"{tuple(phi0.shape)} ({steps[0]} reinit + {steps[1]} min/max "
          f"steps, a normal cotangent), mesh {mesh.shape} on {cards}: "
          f"reinit and min/max outputs and the gradient bitwise equal to "
          f"the solo reinit_fixed / minmax_flow_fixed on {phi0.device}; "
          f"forward+backward wall {t_sh:.3f} s vs solo {t_solo:.3f} s; card "
          f"{card}")


def banded_solves_phase(card):
    """Phase 4c: the differentiable narrow-band solves on the bench sphere
    (256^3): reinit_scan_banded (20 steps, masks every 5) beside the dense
    reinit_fixed, minmax_scan(banded=True) bitwise the dense one, and the
    banded sharded reinit on (2,2,1) bitwise the solo banded one."""
    import torch
    from levelsetfortran_tpu_torch.ops import minmax_cuda as mc
    from levelsetfortran_tpu_torch.ops import weno_cuda as wc
    from levelsetfortran_tpu_torch.parallel import sharded as sh
    from levelsetfortran_tpu_torch.parallel.mesh import (gather_blocks,
                                                         make_mesh,
                                                         split_blocks)
    from levelsetfortran_tpu_torch.solvers.reinit import reinit_fixed

    shape, dx = (BENCH_N,) * 3, BENCH_DX
    phi = sphere(shape, dx, BENCH_R)
    h, h1 = 0.1 * dx, 0.01 * dx * dx
    wgt = torch.tensor(np.random.default_rng(12).standard_normal(shape),
                       dtype=torch.float32, device="cuda")
    counters = (wc.reinit_step_vjp_banded, mc.minmax_step_vjp_banded,
                wc.reinit_step_block_vjp)
    for c in counters:
        c.launches = 0

    def timed(fn):
        """Forward (recording the graph) and backward walls, the output and
        the gradient."""
        x = phi.clone().requires_grad_(True)
        out, t_f = sync_time(lambda: fn(x))
        _, t_b = sync_time(lambda: torch.sum(wgt * out).backward())
        return out.detach(), x.grad, t_f, t_b

    rb = timed(lambda x: wc.reinit_scan_banded(x, dx, h, 20, band_radius=8.1,
                                               refresh_every=5))
    rd = timed(lambda x: reinit_fixed(x, dx, h, 20))
    check(all(bool(torch.isfinite(t).all()) for t in rb[:2])
          and float(rb[1].abs().max()) > 0, "banded reinit: gradient")
    act = wc.tile_activity(phi, dx, 8.1, 5 * h / dx, window="band4")
    frozen = int(act.numel() - act.sum())
    mb = timed(lambda x: mc.minmax_scan(x, dx, h1, 20, banded=True))
    md = timed(lambda x: mc.minmax_scan(x, dx, h1, 20))
    check(torch.equal(mb[0], md[0]) and torch.equal(mb[1], md[1]),
          f"banded min/max differs from dense: {err(mb[0], md[0]):.3g}, "
          f"gradient {err(mb[1], md[1]):.3g}")
    mesh = make_mesh((2, 2, 1), ["cuda"])

    def sharded(x):
        return gather_blocks(mesh, sh.reinit_fixed_sharded(
            mesh, split_blocks(mesh, x), dx, h, 20, band_radius=8.1,
            refresh_every=8))

    sb = timed(sharded)
    ob = timed(lambda x: wc.reinit_scan_banded(x, dx, h, 20, band_radius=8.1,
                                               refresh_every=8))
    check(torch.equal(sb[0], ob[0]) and torch.equal(sb[1], ob[1]),
          f"banded sharded reinit differs from the solo banded one: "
          f"{err(sb[0], ob[0]):.3g}, gradient {err(sb[1], ob[1]):.3g}")
    launches = {c.__name__: c.launches for c in counters}
    check(all(v > 0 for v in launches.values()),
          f"banded solves: a kernel never launched {launches}")
    phase("banded", f"{shape} sphere (bench.py:328-363), 20 steps, "
          f"forward / backward walls: reinit_scan_banded (masks every 5, "
          f"{frozen}/{act.numel()} bricks frozen at the start) {rb[2]:.3f} / "
          f"{rb[3]:.3f} s vs dense reinit_fixed {rd[2]:.3f} / {rd[3]:.3f} s; "
          f"minmax_scan banded {mb[2]:.3f} / {mb[3]:.3f} s vs dense "
          f"{md[2]:.3f} / {md[3]:.3f} s, values and gradient bitwise equal; "
          f"reinit_fixed_sharded(band_radius=8.1, refresh_every=8) on "
          f"(2, 2, 1) {sb[2]:.3f} / {sb[3]:.3f} s, values and gradient "
          f"bitwise equal to the solo reinit_scan_banded ({ob[2]:.3f} / "
          f"{ob[3]:.3f} s); launches {launches}; card {card}")
    return launches


def box_caps(v, half_extent):
    edge = np.isclose(np.abs(v), np.float32(half_extent)).sum(1) >= 2
    return np.where(edge, 2.0, 1.5) * RUN_E_DX


def run_e_meshes():
    """Run E's meshes, their analytic SDFs, names, and for each the cap on
    its nodes' advected |sdf| as a function of the nodes: 1.5 dx (runs
    A/B), 2 dx on a box's edges and corners, which min/max flow rounds.
    The JAX package's own run_batch rounds them as far on a CPU at this
    dx: box (0.8, 0.5, 0.3) edges 1.68 dx and corners 1.72 dx, face nodes
    0.02 dx (tests/test_torch_box_edges.py run as a script)."""
    from levelsetfortran_tpu_torch.models import analytic
    meshes, truths, names, caps = [], [], [], []
    for r in RUN_E_SPHERES:
        meshes.append(analytic.icosphere_mesh(radius=r, subdivisions=4))
        truths.append(partial(analytic.sdf_sphere, center=(0.0, 0.0, 0.0),
                              radius=r))
        names.append(f"ball{round(100 * r)}")
        caps.append(lambda v: np.full(len(v), 1.5 * RUN_E_DX))
    for e in RUN_E_BOXES:
        meshes.append(analytic.box_mesh(half_extent=e, subdivisions=4))
        truths.append(partial(analytic.sdf_box, center=(0.0, 0.0, 0.0),
                              half_extent=e))
        names.append("box" + "".join(str(round(10 * v)) for v in e))
        caps.append(partial(box_caps, half_extent=e))
    return meshes, truths, names, caps


def run_e_phase(card, tmp):
    """Phase 5: the batched serving path at full size.  Eight meshes
    through the CLI with eight inputs and in process through run_batch
    (its launch counters read around it), each geometry held to the run
    A/B gates; then the packed solver stages held against the solo dense
    solvers on the same init and h, bitwise."""
    import logging

    import torch
    from levelsetfortran_tpu_torch import write_stl
    from levelsetfortran_tpu_torch.io.vti import read_vti
    from levelsetfortran_tpu_torch.ops import minmax_cuda as mc
    from levelsetfortran_tpu_torch.ops import weno_cuda as wc
    from levelsetfortran_tpu_torch.pipeline import batch
    from levelsetfortran_tpu_torch.pipeline.cli import (build_parser,
                                                        config_from_args)
    from levelsetfortran_tpu_torch.solvers.minmax_flow import minmax_flow
    from levelsetfortran_tpu_torch.solvers.reinit import reinit
    from levelsetfortran_tpu_torch.utils.logging import StageTimer, logger

    meshes, truths, names, caps = run_e_meshes()
    paths = [os.path.join(tmp, f"{n}.stl") for n in names]
    for path, mesh in zip(paths, meshes):
        write_stl(path, mesh)
    cli_dir = os.path.join(tmp, "E_cli")
    args = [*paths, "--dx", str(RUN_E_DX), "--advect-iters",
            str(RUN_E_ADVECT_ITERS), "--out-dir", cli_dir]
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "levelsetfortran_tpu_torch", *args],
        cwd=HERE, capture_output=True, text=True, timeout=900)
    cli_s = time.perf_counter() - t0
    check(proc.returncode == 0,
          f"run E CLI failed:\n{proc.stdout}\n{proc.stderr[-4000:]}")
    lines = proc.stdout.strip().splitlines()
    check([ln.split("]")[0][1:] for ln in lines] == names,
          f"run E CLI printed {lines}")
    check('"strategy": "packed"' in proc.stderr, "run E CLI: not packed")

    cfg = config_from_args(build_parser().parse_args(args))
    inits, logged = [], []
    real_init = batch.signed_distance_init

    def keep(*a, **k):
        inits.append(real_init(*a, **k))
        return inits[-1]

    class Keep(logging.Handler):
        def emit(self, rec):
            logged.append(json.loads(rec.getMessage()))

    handler = Keep()
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    batch.signed_distance_init = keep
    counters = (wc.reinit_step_packed, mc.minmax_step_packed, wc.reinit_step,
                mc.minmax_step, mc.minmax_fusedk)
    for c in counters:
        c.launches = 0
    timer = StageTimer()
    try:
        items = batch.run_batch(paths, cfg, timer=timer)
    finally:
        batch.signed_distance_init = real_init
        logger.removeHandler(handler)
    launches = {c.__name__: c.launches for c in counters}
    strategy = [r["strategy"] for r in logged
                if r["stage"] == "batch_strategy"]
    check(strategy == ["packed"], f"run E: strategy {strategy}")
    check(launches["reinit_step_packed"] > 0
          and launches["minmax_step_packed"] > 0,
          f"run E: pack kernels not launched {launches}")
    check(all(launches[n] == 0 for n in ("reinit_step", "minmax_step",
                                         "minmax_fusedk")),
          f"run E: solo kernels launched in the batched stages {launches}")

    shape = items[0].grid.shape
    dx = cfg.dx
    for it, truth, name, cap_of in zip(items, truths, names, caps):
        pts = it.grid.coords(dtype=torch.float64).numpy()
        tv = truth(pts)
        near = np.abs(tv) < 0.2
        e_sdf = np.abs(it.phi_init - tv)[near]
        e_smooth = np.abs(it.phi_smoothed - tv)[near]
        adv = np.abs(truth(it.advected))
        cap = cap_of(it.mesh.vertices)
        cli_phi, _ = read_vti(os.path.join(cli_dir, name,
                                           "signedDistanceFunction.vti"))
        check(np.array_equal(cli_phi, it.phi_init),
              f"run E {name}: CLI and run_batch fields differ")
        check(os.path.exists(os.path.join(cli_dir, name, f"{name}.s3d")),
              f"run E {name}: CLI wrote no .s3d")
        finite = all(np.isfinite(f).all() for f in
                     (it.phi_init, it.phi_smoothed, it.advected))
        phase("run E", f"{name}: reinit_iters {it.reinit_iters}, "
              f"minmax_iters {it.minmax_iters}, asymptotic_error "
              f"{it.asymptotic_error:.4g}, sdf near-surface max err "
              f"{e_sdf.max():.4g}, smoothed median err "
              f"{np.median(e_smooth):.4g}, advected max |sdf| "
              f"{adv.max():.4g} = {adv.max() / dx:.3g} dx (cap "
              f"{cap.min() / dx:g}-{cap.max() / dx:g} dx)")
        check(e_sdf.max() < 5e-3, f"run E {name}: sdf error {e_sdf.max()}")
        check(np.median(e_smooth) < 6e-3,
              f"run E {name}: smoothed median error")
        check((adv <= cap).all(), f"run E {name}: advected {adv.max()}")
        check(it.reinit_iters < cfg.reinit_iters, f"run E {name}: cap")
        check(finite, f"run E {name}: non-finite output")
    marks = timer.marks
    stages = {"init": marks["search"],
              "reinit": marks["initialization"] - marks["search"],
              "minmax": marks["minmax"] - marks["initialization"],
              "advect": marks["advect"] - marks["minmax"],
              "outputs": marks["total"] - marks["advect"]}
    phase("run E", f"{len(items)} geometries on {shape} (dx {dx}, "
          f"{len(items) * int(np.prod(shape))} cells stacked, "
          f"{cfg.advect_iters} advection iterations), strategy packed, "
          f"launches {launches}; run_batch wall {marks['total']:.3f}"
          f" s: " + ", ".join(f"{k} {v:.3f} s" for k, v in stages.items())
          + f"; CLI {cli_s:.1f} s; card {card}")

    # the packed solver stages against the solo dense solvers, same init
    phi0 = torch.stack(inits)
    h_r, h_m = batch.step_sizes(meshes, cfg)
    rkw = dict(eps_scale=cfg.weno_eps_scale, eps_floor=cfg.eps_floor,
               quirk_y_p5_zero=cfg.quirks.weno_y_p5_zero)
    mkw = dict(band_radius=cfg.band_radius, threshold=cfg.minmax_threshold)
    rp, t_rp = sync_time(lambda: batch.reinit_batched_packed(
        phi0, dx, h_r, cfg.reinit_iters, cfg.reinit_tol, **rkw))
    rs, t_rs = sync_time(lambda: [
        reinit(phi0[b], dx, float(h_r[b]), cfg.reinit_iters, cfg.reinit_tol,
               **rkw) for b in range(len(meshes))])
    mp, t_mp = sync_time(lambda: batch.minmax_batched_packed(
        rp.phi, dx, h_m, cfg.minmax_iters, cfg.minmax_tol, **mkw))
    ms, t_ms = sync_time(lambda: [
        minmax_flow(rs[b].phi, dx, float(h_m[b]), cfg.minmax_iters,
                    cfg.minmax_tol, **mkw) for b in range(len(meshes))])
    for b, name in enumerate(names):
        check(rp.iterations[b] == rs[b].iterations == items[b].reinit_iters
              and torch.equal(rp.phi[b], rs[b].phi),
              f"run E {name}: packed reinit differs from the solo solver")
        check(mp.iterations[b] == ms[b].iterations == items[b].minmax_iters
              and torch.equal(mp.phi[b], ms[b].phi),
              f"run E {name}: packed min/max differs from the solo solver")
        check(np.array_equal(mp.phi[b].double().cpu().numpy(),
                             items[b].phi_smoothed),
              f"run E {name}: the solver stages differ from run_batch's")
    phase("run E", f"packed solver stages vs the solo dense solvers on the "
          f"same init and h: counts equal and fields bitwise equal for all "
          f"{len(names)} geometries; reinit {max(rp.iterations)} steps "
          f"packed {t_rp:.3f} s vs sequential {t_rs:.3f} s, min/max "
          f"{max(mp.iterations)} steps packed {t_mp:.3f} s vs sequential "
          f"{t_ms:.3f} s; card {card}")
    return launches


def start():
    """Phases 0 and 1: the card's line, TF32 on, the kernels built.
    Returns the card's name and power limit."""
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else \
        "nvidia-smi unavailable"
    print(card, flush=True)
    global CARD
    CARD = card
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    phase("device", f"{torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}; TF32 on")

    from levelsetfortran_tpu_torch import cuda_build
    t0 = time.perf_counter()
    cuda_build.library()
    phase("build", f"{time.perf_counter() - t0:.1f} s "
          f"({', '.join(s.name for s in cuda_build.sources())})")
    return card


def kernel_names():
    """Each kernel entry of the record: its source and the TPU kernel (file
    and line of its ``pallas_call`` function) it replaces."""
    csrc = "levelsetfortran_tpu_torch/csrc/"
    weno, mm = ("levelsetfortran_tpu/ops/weno_pallas.py:",
                "levelsetfortran_tpu/ops/minmax_pallas.py:")
    names = {
        "reinit_step": (csrc + "reinit_step.cu", weno + "1938"),
        "minmax_step": (csrc + "minmax_step.cu", mm + "309"),
        "minmax_fusedk": (csrc + "minmax_step.cu", mm + "647"),
        "reinit_step_vjp": (csrc + "reinit_bwd.cu", weno + "1850"),
        "minmax_step_vjp": (csrc + "minmax_bwd.cu", mm + "975"),
        "reinit_step_packed": (csrc + "reinit_step.cu",
                               weno + "1938 (pack)"),
        "minmax_step_packed": (csrc + "minmax_step.cu", mm + "309 (pack)"),
        "reinit_step_block": (
            csrc + "reinit_step.cu",
            weno + "1938 (offsets, rms_bounds, tile_range + out_init)"),
        "minmax_step_block": (csrc + "minmax_step.cu",
                              mm + "309 (offsets)"),
        "reinit_step_block_vjp": (csrc + "reinit_bwd.cu",
                                  weno + "1850 (offsets)"),
        "minmax_step_block_vjp": (csrc + "minmax_bwd.cu",
                                  mm + "975 (offsets)"),
        "reinit_step_vjp_banded": (csrc + "reinit_bwd.cu",
                                   weno + "1850 (active)"),
        "minmax_step_vjp_banded": (csrc + "minmax_bwd.cu",
                                   mm + "975 (active)"),
    }
    return names


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    card = start()
    from levelsetfortran_tpu_torch.models import analytic
    from levelsetfortran_tpu_torch.pipeline.batch import common_shape_grids

    names = kernel_names()
    record = {n: {"max_abs_err": 0.0, "library_ms": None} for n in names}
    kernel_phase(record)
    packed_phase(record, common_shape_grids(run_e_meshes()[0], RUN_E_DX,
                                            10)[0].shape)
    block_phase(record)
    adjoint_mode_phase(record)

    cubes = analytic.two_cubes_mesh()
    ball = analytic.icosphere_mesh(subdivisions=5)
    check(ball.n_elems == 20480, "icosphere triangles")

    def cubes_sdf(p):
        return analytic.sdf_two_cubes(p, spacing=10.0, size=1.0)

    def ball_sdf(p):
        return analytic.sdf_sphere(p, (0.0, 0.0, 0.0), 1.0)

    total = {n: 0 for n in names}

    def count(launches):
        for n, v in launches.items():
            total[n] += v

    with tempfile.TemporaryDirectory() as tmp:
        results = {}
        for label, mesh, truth, dx, extra in (
                ("A", cubes, cubes_sdf, 0.05, []),
                ("B", ball, ball_sdf, 0.01, []),
                ("C", cubes, cubes_sdf, 0.05, ["--narrow-band", "off"])):
            launches, results[label] = run_phase(label, mesh, truth, dx,
                                                 extra, tmp)
            count(launches)
        run_a_fused(results["A"], cubes)
        count(run_f_phase(ball, ball_sdf, results["B"], card, tmp))
        count(run_e_phase(card, tmp))
    launches, run_d = run_d_phase(ball, card, record)
    count(launches)
    count(run_g_phase(ball, card, run_d))
    del run_d
    count(banded_solves_phase(card))
    small_holds()

    kernels = []
    for n, (src, repl) in names.items():
        r = record[n]
        kernels.append({"name": n, "route": "cuda", "source": src,
                        "replaces": repl, "launches": total[n],
                        **{k: r[k] for k in (
                            "max_abs_err", "ms", "plain_ms", "bound_ms",
                            "bound_by", "library_ms")},
                        **{k: r[k] for k in ("solo_ms", "device_ms")
                           if k in r}})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
