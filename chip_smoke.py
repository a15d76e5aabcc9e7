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
     field (times taken here), its (2,1,1) split (run J's other mesh) and
     a (2,2,2) split of (66, 46, 38): against their plain
     versions over the whole padded output, the gathered field against the
     solo kernel on the whole grid (bitwise), the owned-range sums against
     the solo sum, two steps per exchange and the overlapped step against
     plain stepping (bitwise), the banded step against the dense one on
     active bricks; then run F, run B's mesh with ``--mesh-shape 2,2,1``
     through the CLI and ``run()``, held to run B's gates and against run
     B's fields, the block-mode counters read around it and the solo
     kernels' counters zero; then its solver stages once more at fixed
     counts, dense, with two steps per exchange and overlapped, bitwise
     equal to each other and to the solo dense solvers; then run L, run F
     through ``run()`` on two ranks that this script starts (two shards
     each, the backend chosen as for run J), every rank's iterations, RMS,
     asymptotic error and advected nodes bitwise run F's, rank 0's
     gathered fields and its .vti/.s3d bytes too, the other rank writing
     nothing, the block kernels launched on both ranks and no solo kernel,
     the stage walls beside run F's; run L again with checkpoints every
     100 steps, bitwise; the advection's per-iteration all-reduce timed
     alone; and phase 10's resumable sharded solvers across the same ranks
     (run H ranks), bitwise the uninterrupted solo solves;
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
     banded sharded reinit bitwise the solo banded one; then run G-ranks,
     run G's render on two ranks (two shards each): the image and loss
     bitwise run G's, the vertex gradient bitwise the same on both ranks
     and within 1e-6 of max|grad| of run G's, the block modes of
     K1/K3/K5/K6 launched on both and no solo kernel, the peak per rank;
  9. run H, the operations path: run C's configuration with
     ``--checkpoint-dir``, ``--checkpoint-chunk 100`` and
     ``--metrics-every 100``, through the CLI and in process with the
     launch counters read around it: phi_init and phi_smoothed bitwise run
     C's, 13 / 1064 iterations, at most 3 steps kept per stage, the metrics
     events of the JAX package's rule; then a run preempted after 500
     min/max steps and resumed on its directory (the converged reinit
     stage takes one more step, min/max resumes from 500), phi_smoothed
     bitwise run C's;
 10. the resumable solvers at 222^3 (the kernel phases' sphere), solo and
     on (2,2,1) blocks of one card, stopped after two chunks of 20 and
     resumed to 100 steps: bitwise the uninterrupted solo solves; save and
     restore times per call;
 11. run I, run B's mesh through ``run()`` with ``init_mode="reference"``
     (the dense initial reinit, banded min/max and final reinit) and a
     metrics event every 9 iterations: no wrong sign farther than 2 dx
     from the sphere, phi_init's near-surface error under 2 dx, the events
     at the banded cadences; then ``measure_cell_updates_per_sec`` on
     dense K1 at 256^3 (the JAX package's headline shape);
 12. run K (after run E), run E's eight meshes with ``--data-parallel 2``
     through the CLI and in process: two shares of four geometries, each
     its own pack launch per step (on two cards, or both on one), the
     fields, advected nodes and counts bitwise run E's, the outputs held to
     run E's gates;
 13. run J, ``ShardedLevelSet`` on two ranks that this script starts
     (``chip_smoke.py --rank ...``; NCCL with a card per rank, else gloo
     with both ranks on the one card and the slabs through host memory, a
     choice made before the run), on the kernel phases' 222^3 sphere cut
     (2,1,1) and (2,2,1): 50 reinit steps at tol 0 with k = 1, k = 2, the
     narrow band and the overlapped step, 50 min/max steps dense and
     banded; every rank's blocks (sha256 of their bytes), iterations and
     RMS bitwise the one-process solve here, the ranks' block-kernel
     launches added to the record, the wall per step beside the one
     process's; the ranks are killed after RANK_TIMEOUT seconds;
 14. ``parallel.dryrun(4)`` on the card(s), the kernels' counters read
     around it (the block modes of K1, K3 and K5 must launch);
 15. options: K4's block mode on the (2,2,1) split of the 222^3 sphere
     with a halo of 4 (every padded block bitwise its plain version and a
     second launch, the owned cells bitwise the global K4, one block timed
     beside its bound), then driven: 5 exchanges of 4 fused steps, its
     counter read around them, bitwise 5 global K4 launches; the
     solvers' non-default options (``use_true_curvature``,
     ``avg_halfwidth=2``, ``grad_fn``) at 222^3 for 50 steps, timed, no
     kernel launched, and at 64^3 on the card against the CPU;
     ``minmax_flow_fixed(use_true_curvature=True)`` and
     ``reinit_fixed(grad_fn=...)`` at run D's 256^3 and step counts (wall,
     peak, a finite gradient; at 24^3 the card against the CPU, run D's
     gate); ``minmax_fixed_sharded(avg_halfwidth=2)`` at 256^3 on (2,2,1)
     against the solo solve (values bitwise) and on two ranks, every rank
     bitwise the one-process run;
 16. dtypes: the JAX package's dtype routing on the card (float32 takes
     the kernels, bfloat16 and float64 their plain versions): (a)
     ``REFERENCE_PARITY`` (float64) on the twoCube10 twin against
     ``tests/golden/parity_twocube10.npz`` at
     ``tests/test_torch_parity_golden.py``'s gates; (b) run B's mesh
     through ``run()`` in float64 and in bfloat16 (the CLI's ``--dtype``
     parsed into the config), beside phase 3's float32 run B: walls,
     iterations, near-surface error, peak memory and no kernel launched,
     float64 held to run B's error gates, bfloat16 finite, converged and
     under BF16_RUN_B (the near-surface, smoothed-median and advected
     errors), and run B's mesh in bfloat16 at the spacings of BF16_JAX
     within BF16_VS_JAX of the JAX package's readings; (c) bfloat16
     reinit and min/max solves at 48^3, the
     card against the CPU; (d) the float64 gradient of the 24^3
     octahedron, the card against the CPU to rtol 1e-10; (e)
     ``run_batch`` of two icospheres in float64 and bfloat16, two
     data-parallel shares bitwise the undivided batch;
 17. init kernels: K7 (the init's selection scan) against its plain
     version on the card, each case run through ``signed_distance_init``
     on the K7 route and on the plain route: run B's mesh at 222^3 culled,
     the dense init on run A's grid, one block of run B's (2,2,1) mesh and
     run D's 256^3 with vertices that require grad (the vertex gradient of
     a seeded linear loss); the argmin of every point against the plain
     version on the same inputs (apart only at a tie of exact distances),
     the fields' magnitudes within INIT_TOL, their signs apart only under
     INIT_SIGN_BAND; K7 timed beside the plain version and the bound; run
     B's whole init under torch.profiler under INIT_KERNELS CUDA kernels;
     then K8 (the advection) on run B's and run E's smoothed fields and
     nodes, bitwise the plain loop and the runs' own advected nodes, timed
     beside the loop; then K10 (the init's culling on the card) at run
     B's and the run cell's grids (256^3 at dx 0.00855): its rows bitwise
     its plain version's on the card, a pair apart from the host build's
     only within CULL_NEAR_ULPS of its threshold, timed beside the plain
     version, the host build and the bound, and the init's field through
     it bitwise the field on the host-built culling.  Phases 3, 4, 5 and 6
     read K7's, K8's and K10's counters (under a mesh K8's block mode,
     ``run_blocks``, in place of K8) and print the init split into the
     culling build (K10 on the card), the selection and the exact
     re-evaluation;
 18. K8's block mode (the sharded advection): run B's smoothed field
     through the solo K8 (timed beside PERF.md's), then cut (2, 2, 1) with
     all four blocks on one card and one block per visible card, and the
     sphere's distance on the sharded cell's 512^3 grid cut the same two
     ways: every shard's sample bitwise its plain version, the advected
     positions and phi_surf bitwise the plain loop's on the same blocks
     (and equal to the solo K8's on run B), the stage, the rounds and the
     plain loop timed; one shard's sample timed alone; then the same
     advection on two or more ranks (one per card over NCCL, two on one
     card over gloo), every rank bitwise one process.
The second-to-last line is the kernels' JSON record, the last line the
device record.  Needs no network; starts one child process per CLI run and
one per rank of runs J, L and G-ranks and of the options phase's ranks,
and waits for each (a rank is
killed after RANK_TIMEOUT seconds, which fails the script).
"""

from __future__ import annotations

import contextlib
import json
import math
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
#: Per (point, candidate) pair, one evaluation of the selection scan's
#: pair (``ops/init_cuda.py:_select_scan``): the four dots (20), d1..d6
#: (6), va, vb, vc (9), the region tests (17), the region's distance and
#: its clamp (8), the running minimum (2), the tie test and term (8) — K7
#: evaluates each pair twice (its two passes).  Per node and iteration of
#: the advection (and once more for the final sample): the index, its
#: clamps and floor (21), four trilinear blends (84), |g|^2 (5), the
#: direction (4) and the move (10).  Per (row, triangle) pair of the
#: culling (K10, a parent against every triangle, a block against its
#: parent's survivors): the dot (5), * -2 and two sums (3), the clamp and
#: the square root (2), the radius (1), the running argmin or the test (1).
OPS = {"reinit": 452, "rms": 3, "minmax_band": 14, "reinit_vjp": 1600,
       "minmax_vjp_band": 19, "minmax_vjp": 16, "init_pair": 70,
       "advect_iter": 124, "cull_pair": 12}
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
#: Phase 16: the JAX package's own bfloat16 errors on run B's mesh (the
#: icosphere of 20,480 triangles, default config) at coarser spacings than
#: run B's, by ``tools/bf16_run_b_errors.py`` on the CPU (the JAX package
#: does not run on the card's machine, and run B's 222^3 is a full-size
#: run for a CPU): {dx: (sdf near-surface max, smoothed median, advected
#: max |sdf|)}.  All three shrink with dx (71 / 42 and 57 / 44
#: iterations).
BF16_JAX = {0.04: (0.021284, 0.0037105, 0.022008),
            0.02: (0.014391, 0.0028805, 0.018050)}
#: The port's bfloat16 errors at those spacings, on the card, at most this
#: many times the JAX package's (the port on the CPU and on the card:
#: 1.022, 1.095, 1.069 at dx 0.04; on the card 1.074, 1.003, 1.126 at dx
#: 0.02).
BF16_VS_JAX = 1.25
#: bfloat16 run B (dx 0.01): each error within BF16_VS_JAX of the JAX
#: package's reading at the finest spacing scanned, which bounds its
#: reading at run B's, the errors shrinking with dx in both packages.
BF16_RUN_B = tuple(BF16_VS_JAX * e for e in BF16_JAX[min(BF16_JAX)])
#: The card's name and power limit as nvidia-smi prints them (set by
#: start()), printed beside every time.
CARD = "nvidia-smi not read"


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


class Logged:
    """Collect the port's structured log records while the block runs."""

    def __enter__(self):
        import logging
        from levelsetfortran_tpu_torch.utils.logging import logger
        records = self.records = []

        class Keep(logging.Handler):
            def emit(self, rec):
                records.append(json.loads(rec.getMessage()))

        self._handler, self._level = Keep(), logger.level
        logger.addHandler(self._handler)
        logger.setLevel(logging.INFO)
        return self

    def __exit__(self, *exc):
        from levelsetfortran_tpu_torch.utils.logging import logger
        logger.removeHandler(self._handler)
        logger.setLevel(self._level)


def run_counters():
    """The launch counters of the kernels a pipeline run may launch."""
    from levelsetfortran_tpu_torch.ops import advect_cuda, cull_cuda, init_cuda
    from levelsetfortran_tpu_torch.ops import minmax_cuda as mc
    from levelsetfortran_tpu_torch.ops import weno_cuda as wc
    return (wc.reinit_step, mc.minmax_step, mc.minmax_fusedk,
            wc.reinit_step_block, mc.minmax_step_block,
            init_cuda.select_rows, advect_cuda.advect, cull_cuda.cull_rows,
            advect_cuda.run_blocks, advect_cuda.sample_block)


@contextlib.contextmanager
def init_split():
    """The exact init's stage times (``init_sign.stage_times``) over the
    block: yields the dict they are added to."""
    from levelsetfortran_tpu_torch.ops import init_sign
    init_sign.stage_times = times = {}
    try:
        yield times
    finally:
        init_sign.stage_times = None


def split_text(times):
    """The init split as a line's words: the culling build (K10 on the
    card), K7 (or its plain version) and the exact re-evaluation."""
    return ", ".join(f"{k} {times.get(k, 0.0):.3f} s"
                     for k in ("culling", "select", "exact"))


def sphere(shape, dx, radius, device="cuda", center=(0.0, 0.0, 0.0)):
    """Sphere SDF, centered in the box unless ``center`` moves it, on the
    device, float32."""
    import torch
    axes = [(np.arange(n) - (n - 1) / 2.0) * dx - c
            for n, c in zip(shape, center)]
    gx, gy, gz = np.meshgrid(*axes, indexing="ij")
    phi = np.sqrt(gx ** 2 + gy ** 2 + gz ** 2) - radius
    return torch.tensor(phi, dtype=torch.float32, device=device)


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
    from levelsetfortran_tpu_torch import LevelSetConfig, write_stl
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
    counters = run_counters()
    for c in counters:
        c.launches = 0
    with init_split() as split:
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
    phase(f"run {label}", f"stages: init {t['search']:.3f} s ("
          f"{split_text(split)}), reinit "
          f"{t['initialization'] - t['search']:.4f} s, min/max "
          f"{t['minmax'] - t['initialization']:.4f} s, advect "
          f"{t['advect'] - t['minmax']:.3f} s; card {CARD}")
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
        # the sharded advection in one process: K8's block mode in rounds
        want = ("reinit_step_block", "minmax_step_block", "select_rows",
                "cull_rows", "run_blocks")
    elif "off" in extra_args:
        want = ("reinit_step", "minmax_step", "select_rows", "advect",
                "cull_rows")
    else:
        want = ("reinit_step", "minmax_fusedk", "select_rows", "advect",
                "cull_rows")
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
    from levelsetfortran_tpu_torch.ops import init_cuda, reverse
    from levelsetfortran_tpu_torch.ops import weno_cuda as wc
    from levelsetfortran_tpu_torch.ops.init_sign import build_init_culling

    grid = cube_grid(ball.vertices, n)
    t0 = time.perf_counter()
    cull = build_init_culling(grid, ball.vertices, ball.elements, block=16)
    t_build = time.perf_counter() - t0
    v = torch.tensor(ball.vertices, dtype=torch.float32, device="cuda")
    kw = dict(RUN_D_KW, culling=cull)
    target = torch.zeros((64, 64), device="cuda")
    counters = (wc.reinit_step, mc.minmax_step, mc.minmax_fusedk,
                wc.reinit_step_vjp, mc.minmax_step_vjp, init_cuda.select_rows)
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
                 "minmax_step_vjp", "select_rows"):
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
          + f" (init: {split_text(split['split'])}); {split['hits']} rays "
          f"hit; the chained gradient equals the "
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
    with init_split() as split:
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
    return {"fwd": fwd, "bwd": bwd, "peak": peak, "split": split,
            "loss": loss.detach(),
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

    # (2, 1, 1) on the main shape is run J's other mesh: its padded blocks,
    # (119, 222, 222) for K1 and (113, 222, 222) for K3, are held here too;
    # the times are taken on (2, 2, 1)
    for shape, mshape, dx, radius in ((MAIN_SHAPE, (2, 2, 1), 0.01, 1.0),
                                      (MAIN_SHAPE, (2, 1, 1), 0.01, 1.0),
                                      ((66, 46, 38), (2, 2, 2), 0.05, 0.6)):
        main = (shape, mshape) == (MAIN_SHAPE, (2, 2, 1))
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
    """Phase 6: run B's mesh through the domain-decomposed pipeline.
    Returns the launches and what run L is held to: the in-process run's
    result, its solvers' ``[iterations, rms]``, its output directory, the
    STL and the CLI arguments."""
    import torch
    from levelsetfortran_tpu_torch import LevelSetConfig
    from levelsetfortran_tpu_torch.ops.init_sign import \
        signed_distance_init_sharded
    from levelsetfortran_tpu_torch.parallel import sharded as sh
    from levelsetfortran_tpu_torch.parallel.mesh import (gather_blocks,
                                                         make_mesh)
    from levelsetfortran_tpu_torch.solvers.minmax_flow import minmax_flow
    from levelsetfortran_tpu_torch.solvers.reinit import reinit

    dx = 0.01
    with Logged() as log, solver_rms() as rms:
        launches, res = run_phase("F", ball, ball_sdf, dx,
                                  ["--mesh-shape", "2,2,1"], tmp)
    check(res.grid.shape == res_b.grid.shape, "run F: grid differs from B's")
    # where the run says it put its shards: round-robin over every visible
    # card (all four blocks on the one card when there is one)
    events = [r for r in log.records if r["stage"] == "grid"]
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
    return launches, {"res": res, "rms": rms,
                      "dir": os.path.join(tmp, "F_py"),
                      "stl": os.path.join(tmp, "F.stl"),
                      "args": ["--dx", str(dx), "--mesh-shape", "2,2,1"]}


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
    alone on run D's own init, against the solo solvers, bitwise.  Returns
    the launches and what run G-ranks is held to."""
    import torch
    from levelsetfortran_tpu_torch.parallel.mesh import make_mesh

    grid = run_d["grid"]
    mesh = make_mesh((2, 2, 1), ["cuda"])
    kw = {k: v for k, v in run_d["kw"].items() if k != "culling"}
    run_g = render_run(ball, grid, kw, mesh)
    loss, grad, launches = run_g["loss"], run_g["grad"], run_g["launches"]
    peak, branches, wall = run_g["peak"], run_g["branches"], run_g["wall"]
    gmax = float(grad.abs().max())
    check(math.isfinite(loss) and bool(torch.isfinite(grad).all()),
          "run G: non-finite loss or gradient")
    check(gmax > 0.0, "run G: zero vertex gradient")
    mesh_kernels = BLOCK_KERNELS + SHARDED_INIT
    check(all(launches[k] > 0 for k in mesh_kernels),
          f"run G: a block-mode kernel never launched {launches}")
    check(all(v == 0 for k, v in launches.items() if k not in mesh_kernels),
          f"run G: solo kernels launched under a mesh {launches}")
    check(branches == {"reinit_fixed_sharded": "flat",
                       "minmax_fixed_sharded": "flat"},
          f"run G: reverse branches {branches}")
    lrel = abs(loss - float(run_d["loss"])) / abs(float(run_d["loss"]))
    gd = run_d["grad"]
    gerr = float((grad - gd).abs().max())
    dmax = float(gd.abs().max())
    check(lrel <= 1e-4 and torch.allclose(grad, gd, atol=1e-4 * dmax,
                                          rtol=1e-3),
          f"run G vs run D: loss rel {lrel:.3g}, grad max err {gerr:.3g}")
    blk = mesh.block_shape(grid.shape)
    mib = 4 * blk[0] * blk[1] * blk[2] / 2 ** 20
    launches = {k: v for k, v in launches.items() if v}
    phase("run G", f"run D with mesh (2, 2, 1) on 1 card, blocks {blk}: loss "
          f"{loss:.6g} (run D {float(run_d['loss']):.6g}, rel "
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
    return launches, dict(run_g, kw=kw)


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


def batch_run(label, card, tmp, extra=()):
    """Run E's eight meshes through the CLI with eight inputs and in process
    through run_batch (its launch counters read around it; ``extra``: more
    CLI flags), each geometry held to the run A/B gates.  Returns the
    launches, the items, the inits, the config and the walls."""
    import torch
    from levelsetfortran_tpu_torch import write_stl
    from levelsetfortran_tpu_torch.io.vti import read_vti
    from levelsetfortran_tpu_torch.ops import advect_cuda, init_cuda
    from levelsetfortran_tpu_torch.ops import minmax_cuda as mc
    from levelsetfortran_tpu_torch.ops import weno_cuda as wc
    from levelsetfortran_tpu_torch.pipeline import batch
    from levelsetfortran_tpu_torch.pipeline.cli import (build_parser,
                                                        config_from_args)
    from levelsetfortran_tpu_torch.utils.logging import StageTimer

    meshes, truths, names, caps = run_e_meshes()
    paths = [os.path.join(tmp, f"{n}.stl") for n in names]
    for path, mesh in zip(paths, meshes):
        write_stl(path, mesh)
    cli_dir = os.path.join(tmp, f"{label}_cli")
    args = [*paths, "--dx", str(RUN_E_DX), "--advect-iters",
            str(RUN_E_ADVECT_ITERS), "--out-dir", cli_dir, *extra]
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "levelsetfortran_tpu_torch", *args],
        cwd=HERE, capture_output=True, text=True, timeout=900)
    cli_s = time.perf_counter() - t0
    check(proc.returncode == 0,
          f"run {label} CLI failed:\n{proc.stdout}\n{proc.stderr[-4000:]}")
    lines = proc.stdout.strip().splitlines()
    check([ln.split("]")[0][1:] for ln in lines] == names,
          f"run {label} CLI printed {lines}")
    check('"strategy": "packed"' in proc.stderr, f"run {label} CLI: not "
          f"packed")

    cfg = config_from_args(build_parser().parse_args(args))
    dp = build_parser().parse_args(args).data_parallel
    inits = []
    real_init = batch.signed_distance_init

    def keep(*a, **k):
        inits.append(real_init(*a, **k))
        return inits[-1]

    batch.signed_distance_init = keep
    counters = (wc.reinit_step_packed, mc.minmax_step_packed, wc.reinit_step,
                mc.minmax_step, mc.minmax_fusedk, init_cuda.select_rows,
                advect_cuda.advect)
    for c in counters:
        c.launches = 0
    timer = StageTimer()
    try:
        with Logged() as log, init_split() as split:
            items = batch.run_batch(paths, cfg, timer=timer,
                                    data_parallel=dp)
    finally:
        batch.signed_distance_init = real_init
    launches = {c.__name__: c.launches for c in counters}
    strategy = [r["strategy"] for r in log.records
                if r["stage"] == "batch_strategy"]
    check(strategy == ["packed"], f"run {label}: strategy {strategy}")
    check(cfg.device != "cuda" or launches["reinit_step_packed"] > 0
          and launches["minmax_step_packed"] > 0,
          f"run {label}: pack kernels not launched {launches}")
    check(cfg.device != "cuda" or launches["select_rows"] >= len(names)
          and launches["advect"] >= len(names),
          f"run {label}: K7 / K8 not launched for every geometry "
          f"{launches}")
    check(all(launches[n] == 0 for n in ("reinit_step", "minmax_step",
                                         "minmax_fusedk")),
          f"run {label}: solo kernels launched in the batched stages "
          f"{launches}")
    shares = [r for r in log.records if r["stage"] == "batch_dp"]
    if dp:
        visible = ([f"cuda:{i}" for i in range(torch.cuda.device_count())]
                   if cfg.device == "cuda" else [cfg.device])
        cards = [visible[i % len(visible)] for i in range(dp)]
        check(len(shares) == 1 and shares[0]["devices"] == cards
              and sum(shares[0]["shares"]) == len(names),
              f"run {label}: shares {shares}")
        check(f'"devices": {json.dumps(cards)}' in proc.stderr,
              f"run {label} CLI: not on {cards}")
    else:
        check(not shares, f"run {label}: shares {shares}")

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
              f"run {label} {name}: CLI and run_batch fields differ")
        check(os.path.exists(os.path.join(cli_dir, name, f"{name}.s3d")),
              f"run {label} {name}: CLI wrote no .s3d")
        finite = all(np.isfinite(f).all() for f in
                     (it.phi_init, it.phi_smoothed, it.advected))
        phase(f"run {label}", f"{name}: reinit_iters {it.reinit_iters}, "
              f"minmax_iters {it.minmax_iters}, asymptotic_error "
              f"{it.asymptotic_error:.4g}, sdf near-surface max err "
              f"{e_sdf.max():.4g}, smoothed median err "
              f"{np.median(e_smooth):.4g}, advected max |sdf| "
              f"{adv.max():.4g} = {adv.max() / dx:.3g} dx (cap "
              f"{cap.min() / dx:g}-{cap.max() / dx:g} dx)")
        check(e_sdf.max() < 5e-3, f"run {label} {name}: sdf error "
              f"{e_sdf.max()}")
        check(np.median(e_smooth) < 6e-3,
              f"run {label} {name}: smoothed median error")
        check((adv <= cap).all(), f"run {label} {name}: advected "
              f"{adv.max()}")
        check(it.reinit_iters < cfg.reinit_iters, f"run {label} {name}: cap")
        check(finite, f"run {label} {name}: non-finite output")
    marks = timer.marks
    stages = {"init": marks["search"],
              "reinit": marks["initialization"] - marks["search"],
              "minmax": marks["minmax"] - marks["initialization"],
              "advect": marks["advect"] - marks["minmax"],
              "outputs": marks["total"] - marks["advect"]}
    where = (f"{dp} shares {shares[0]['shares']} on {shares[0]['devices']}"
             if dp else "one batch")
    phase(f"run {label}", f"{len(items)} geometries on {shape} (dx {dx}, "
          f"{len(items) * int(np.prod(shape))} cells stacked, "
          f"{cfg.advect_iters} advection iterations), strategy packed, "
          f"{where}, launches {launches}; run_batch wall "
          f"{marks['total']:.3f} s: " + ", ".join(
              f"{k} {v:.3f} s" for k, v in stages.items())
          + f" (init: {split_text(split)}); CLI {cli_s:.1f} s; card {card}")
    return launches, items, inits, cfg, (marks["total"], cli_s)


def run_e_phase(card, tmp):
    """Phase 5: the batched serving path at full size (:func:`batch_run`);
    then the packed solver stages held against the solo dense solvers on
    the same init and h, bitwise.  Returns the launches and the batch's
    items and walls (run K's reference)."""
    import torch
    from levelsetfortran_tpu_torch.pipeline import batch
    from levelsetfortran_tpu_torch.solvers.minmax_flow import minmax_flow
    from levelsetfortran_tpu_torch.solvers.reinit import reinit

    launches, items, inits, cfg, walls = batch_run("E", card, tmp)
    meshes, _, names, _ = run_e_meshes()
    dx = cfg.dx

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
    return launches, items, walls



def run_k_phase(card, tmp, run_e):
    """Phase 5b: run E with ``--data-parallel 2`` through the CLI and in
    process: two shares of four geometries, each its own pack launch per
    step (on two cards, or both on the one card), the solver fields, the
    advected nodes and the counts bitwise run E's."""
    items_e, (wall_e, cli_e) = run_e
    launches, items, _, _, (wall, cli_s) = batch_run(
        "K", card, tmp, ["--data-parallel", "2"])
    for a, b in zip(items, items_e):
        check((a.reinit_iters, a.minmax_iters) == (b.reinit_iters,
                                                    b.minmax_iters)
              and all(np.array_equal(getattr(a, f), getattr(b, f)) for f in
                      ("phi_init", "phi_smoothed", "advected")),
              f"run K {a.name}: differs from run E")
    phase("run K", f"counts equal and fields and advected nodes bitwise "
          f"run E's for all {len(items)} geometries; run_batch wall "
          f"{wall:.3f} s (run E {wall_e:.3f} s), CLI {cli_s:.1f} s (run E "
          f"{cli_e:.1f} s); card {card}")
    return launches


# --------------------------- several processes ---------------------------

#: Run J: two ranks on a mesh split across them, each case at tol 0 for
#: RUN_J_STEPS steps on the kernel phases' 222^3 sphere, against the
#: one-process solve.  Cases: (label, solver, ShardedLevelSet keywords).
RUN_J_MESHES = ((2, 1, 1), (2, 2, 1))
RUN_J_STEPS = 50
RUN_J_CASES = (("reinit k=1", "reinit", {}),
               ("reinit k=2", "reinit", {"steps_per_exchange": 2}),
               ("reinit banded", "reinit", {"narrow_band": True}),
               ("reinit overlap", "reinit", {"overlap": True}),
               ("minmax dense", "minmax", {}),
               ("minmax banded", "minmax", {"narrow_band": True}))
#: Seconds the ranks of one run may take before they are killed.
RANK_TIMEOUT = 600


def digest(t) -> str:
    """sha256 of a tensor's (or an array's) bytes: the ranks and the parent
    compare blocks bitwise through it without moving the fields."""
    import hashlib
    if hasattr(t, "detach"):
        t = t.detach().cpu().contiguous().numpy()
    return hashlib.sha256(np.ascontiguousarray(t).tobytes()).hexdigest()


def rank_cases(spec, phi, devices=None):
    """Every (mesh, case) of ``spec`` on ``phi`` with ShardedLevelSet at tol
    0, in this process (a mesh across the processes under a group): per
    solve the iterations, the RMS, each local block's digest and the wall
    per step (host clock, synchronised), after one warm-up solve."""
    import torch
    from levelsetfortran_tpu_torch.parallel import sharded as sh
    from levelsetfortran_tpu_torch.parallel.mesh import make_mesh

    def sync():
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    gshape, dx = tuple(phi.shape), spec["dx"]
    out = []
    for mesh_shape in spec["meshes"]:
        mesh = make_mesh(mesh_shape, devices)
        for warm, (label, kind, kw, steps, step) in (
                [(True, spec["cases"][0])]
                + [(False, c) for c in spec["cases"]]):
            s = sh.ShardedLevelSet(mesh, gshape, dx, **kw)
            check(not kw.get("overlap") or s.use_overlap,
                  f"{label}: the overlapped step did not engage")
            blocks = s.device_put(phi)
            sync()
            t0 = time.perf_counter()
            fn = s.reinit if kind == "reinit" else s.minmax_flow
            res, n, rms = fn(blocks, step, 2 if warm else steps, 0.0)
            sync()
            dt = time.perf_counter() - t0
            if warm:
                continue
            out.append({"mesh": list(mesh_shape), "case": label, "n": n,
                        "rms": rms, "step_ms": 1e3 * dt / steps,
                        "blocks": {str(i): digest(b)
                                   for i, b in enumerate(res)
                                   if b is not None}})
    return out


def rank_main(argv) -> int:
    """One rank of a run across processes (``chip_smoke.py --rank R --world
    W --port P --backend B --spec FILE --out FILE``): join the group, run
    the spec's cases, write the results and the block kernels' launch
    counts."""
    import argparse
    import torch
    from levelsetfortran_tpu_torch.ops import minmax_cuda as mc
    from levelsetfortran_tpu_torch.ops import weno_cuda as wc
    from levelsetfortran_tpu_torch.parallel import distributed
    p = argparse.ArgumentParser()
    for name in ("--rank", "--world", "--port"):
        p.add_argument(name, type=int, required=True)
    for name in ("--backend", "--spec", "--out"):
        p.add_argument(name, required=True)
    a = p.parse_args(argv)
    with open(a.spec) as f:
        spec = json.load(f)
    check(distributed.init_distributed(
        f"127.0.0.1:{a.port}", a.world, a.rank, backend=a.backend,
        device=spec["device"]), "no process group")
    devices = None if spec["device"] == "cuda" else [spec["device"]]
    if devices:
        torch.set_num_threads(1)      # ranks that share the host's cores
    kind = spec.get("kind", "cases")
    if kind == "cases":
        phi = torch.load(spec["field"])
        counters = (wc.reinit_step_block, mc.minmax_step_block)
        for c in counters:
            c.launches = 0
        out = {"results": rank_cases(spec, phi, devices),
               "launches": {c.__name__: c.launches for c in counters}}
    else:
        out = {"pipeline": rank_pipeline, "render": rank_render,
               "halfwidth": rank_halfwidth,
               "advect": rank_advect}[kind](spec, devices)
    dev = (f"cuda:{torch.cuda.current_device()}"
           if spec["device"] == "cuda" else "cpu")
    torch.distributed.destroy_process_group()
    with open(a.out, "w") as f:
        json.dump({"rank": a.rank, "device": dev, "backend": a.backend,
                   **out}, f)
    return 0


def rank_backend(world, device="cuda"):
    """NCCL when every rank has a card of its own, else gloo (two ranks on
    one card: NCCL refuses them, so their slabs pass through host memory).
    Chosen here, never after a failure."""
    import torch
    if device == "cuda" and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(spec, world, backend, tmp, tag):
    """Start ``world`` ranks of this script on ``spec``, wait for them
    (killed after RANK_TIMEOUT s), and return their results."""
    spec_path = os.path.join(tmp, f"{tag}_spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    port = free_port()
    procs, logs, outs = [], [], []
    for r in range(world):
        outs.append(os.path.join(tmp, f"{tag}_rank{r}.json"))
        logs.append(open(os.path.join(tmp, f"{tag}_rank{r}.log"), "w+"))
        env = dict(os.environ, LOCAL_RANK=str(r))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank", str(r),
             "--world", str(world), "--port", str(port), "--backend",
             backend, "--spec", spec_path, "--out", outs[-1]],
            cwd=HERE, env=env, stdout=logs[-1], stderr=subprocess.STDOUT))
    deadline = time.monotonic() + RANK_TIMEOUT
    try:
        for proc in procs:
            proc.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    texts = []
    for f in logs:
        f.seek(0)
        texts.append(f.read())
        f.close()
    for r, (proc, text) in enumerate(zip(procs, texts)):
        check(proc.returncode == 0, f"{tag} rank {r}: rc {proc.returncode} "
              f"(killed after {RANK_TIMEOUT} s if negative):\n"
              f"{text[-4000:]}")
    ranks = []
    for path in outs:
        with open(path) as f:
            ranks.append(json.load(f))
    return ranks


def ranks_against_one(tag, spec, phi, ranks, card):
    """Hold the ranks' results against the one-process solves in this
    process, bitwise (block digests, counts, RMS); print the walls.
    Returns the ranks' launches added up."""
    one = rank_cases(spec, phi, None if spec["device"] == "cuda"
                     else [spec["device"]])
    for k, ref in enumerate(one):
        got = [r["results"][k] for r in ranks]
        blocks = {}
        for g in got:
            check(g["case"] == ref["case"] and g["mesh"] == ref["mesh"],
                  f"{tag}: the ranks ran other cases")
            check(g["n"] == ref["n"] and g["rms"] == ref["rms"],
                  f"{tag} {ref['mesh']} {ref['case']}: iterations / RMS "
                  f"{g['n']} / {g['rms']!r} on rank {got.index(g)}, one "
                  f"process {ref['n']} / {ref['rms']!r}")
            blocks.update(g["blocks"])
        check(blocks == ref["blocks"],
              f"{tag} {ref['mesh']} {ref['case']}: the ranks' blocks "
              f"differ from the one-process solve")
    lines = [f"{tuple(ref['mesh'])} {ref['case']} "
             f"{max(r['results'][k]['step_ms'] for r in ranks):.3f} ms "
             f"(one process {ref['step_ms']:.3f})"
             for k, ref in enumerate(one)]
    phase(tag, f"{len(ranks)} ranks on {[r['device'] for r in ranks]} over "
          f"{ranks[0]['backend']}: every rank's blocks, the iterations and "
          f"the RMS bitwise the one-process ShardedLevelSet for "
          f"{len(one)} solves; wall per step (slowest rank): "
          + "; ".join(lines) + f"; card {card}")
    total = {}
    for r in ranks:
        for n, v in r["launches"].items():
            total[n] = total.get(n, 0) + v
    return total


def run_j_phase(card, tmp, device="cuda", shape=MAIN_SHAPE, dx=0.01,
                radius=1.0, steps=RUN_J_STEPS):
    """Phase 12: run J, ShardedLevelSet on two ranks started here, on the
    meshes (2,1,1) and (2,2,1) of the kernel phases' sphere (two shards
    per rank on (2,2,1): same-rank copies and cross-rank slabs), with k =
    1, k = 2, the narrow band and the overlapped step, and the min/max
    flow dense and banded: every rank's blocks and RMS bitwise the
    one-process solve.  Returns the ranks' block-kernel launches."""
    import torch
    backend = rank_backend(2, device)
    phi = sphere(shape, dx, radius, device="cpu")
    field = os.path.join(tmp, "J_field.pt")
    torch.save(phi, field)
    h, h1 = 0.1 * dx / 3.0, 0.01 * dx / 3.0
    spec = {"device": device, "field": field, "dx": dx,
            "meshes": [list(m) for m in RUN_J_MESHES],
            "cases": [[label, kind, kw, steps, h if kind == "reinit" else h1]
                      for label, kind, kw in RUN_J_CASES]}
    phase("run J", f"2 ranks on {shape} over {backend} "
          f"({torch.cuda.device_count() if device == 'cuda' else 0} "
          f"card(s) visible)")
    ranks = run_ranks(spec, 2, backend, tmp, "J")
    launches = ranks_against_one("run J", spec, phi.to(device), ranks, card)
    check(device != "cuda" or all(v > 0 for v in launches.values()) and all(
        r["launches"]["reinit_step_block"] > 0 for r in ranks),
          f"run J: block kernels not launched on every rank {launches}")
    return launches


def dryrun_phase(card, n=4, device="cuda"):
    """Phase 13: the sharded dry run of the JAX package's multi-chip hook
    on the card(s), every kernel's counter read around it.  Returns the
    launches; on the card the block modes of K1 and K3 and K5's block mode
    must be among them."""
    from levelsetfortran_tpu_torch.parallel import dryrun
    (_, launches), t = sync_time(lambda: counted(
        lambda: dryrun(n, device=device)))
    need = ("reinit_step_block", "minmax_step_block",
            "reinit_step_block_vjp")
    check(device != "cuda" or all(launches[k] > 0 for k in need),
          f"dryrun: a block kernel never launched {launches}")
    phase("dryrun", f"dryrun({n}) passed in {t:.2f} s; launches "
          f"{ {k: v for k, v in launches.items() if v} }; card {card}")
    return launches

# ---------------------- several processes: the rest ----------------------

#: Run D's render and solver steps (``bench.py:bench_e2e_pixgrad(256)``),
#: also runs G and G-ranks'.
RUN_D_KW = dict(eye=(0.0, -3.0, 0.0), target=(0.0, 0.0, 0.0),
                reinit_steps=50, minmax_steps=20, height=64, width=64)
#: Run L with checkpoints: run H's chunk.
RUN_L_CHUNK = 100
#: Kernels of the sharded paths: what runs L and G-ranks must launch.
BLOCK_KERNELS = ("reinit_step_block", "minmax_step_block",
                 "reinit_step_block_vjp", "minmax_step_block_vjp")
#: The sharded init's culling and scans: K10 and K7 run under a mesh too,
#: one build and one launch per block.
SHARDED_INIT = ("select_rows", "cull_rows")
#: The sharded advection across processes: K8's block mode, one sample
#: launch per shard and iteration before the all-reduce.
SHARDED_ADVECT = ("sample_block",)
#: Exchanges timed for the advection's per-iteration all-reduce.
EXCHANGE_REPS = 200


@contextlib.contextmanager
def solver_rms():
    """``[iterations, rms]`` of every ShardedLevelSet solve while the block
    runs."""
    from levelsetfortran_tpu_torch.parallel import sharded as sh
    seen = []
    real = {n: getattr(sh.ShardedLevelSet, n) for n in ("reinit",
                                                         "minmax_flow")}

    def wrap(fn):
        def solve(self, *a, **k):
            res = fn(self, *a, **k)
            seen.append([res[1], res[2]])
            return res
        return solve

    for n, fn in real.items():
        setattr(sh.ShardedLevelSet, n, wrap(fn))
    try:
        yield seen
    finally:
        for n, fn in real.items():
            setattr(sh.ShardedLevelSet, n, fn)


@contextlib.contextmanager
def keep_images():
    """The image of every render of the differentiable pipeline while the
    block runs."""
    from levelsetfortran_tpu_torch.pipeline import differentiable as diff
    real, images = diff.render, []

    def render(*a, **k):
        out = real(*a, **k)
        images.append(out.image.detach().clone())
        return out

    diff.render = render
    try:
        yield images
    finally:
        diff.render = real


def timed_checkpointer(times):
    """A FieldCheckpointer whose saves and restores append their walls to
    ``times["save"]`` / ``times["restore"]``."""
    from levelsetfortran_tpu_torch.utils.checkpoint import FieldCheckpointer

    class Timed(FieldCheckpointer):
        def save(self, *a, **k):
            t0 = time.perf_counter()
            out = super().save(*a, **k)
            times["save"].append(time.perf_counter() - t0)
            return out

        def restore(self, *a, **k):
            t0 = time.perf_counter()
            out = super().restore(*a, **k)
            if out is not None:
                times["restore"].append(time.perf_counter() - t0)
            return out

    return Timed


def counted(fn):
    """``(fn(), launches)``: every kernel's counter set to 0 before and
    read after."""
    counters = list(kernel_counters().values())
    for c in counters:
        c.launches = 0
    out = fn()
    return out, {c.__name__: c.launches for c in counters}


def rank_timed(fn):
    """``(fn(), seconds)`` on a rank: its own card synchronised around."""
    import torch

    def sync():
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def file_digests(directory):
    """sha256 of every file of ``directory`` ({} when there is none)."""
    import hashlib
    if not os.path.isdir(directory):
        return {}
    out = {}
    for name in sorted(os.listdir(directory)):
        with open(os.path.join(directory, name), "rb") as f:
            out[name] = hashlib.sha256(f.read()).hexdigest()
    return out


def pipeline_record(res, rms, out_dir):
    """What runs F and L are held to: counts, flags, the asymptotic error,
    the solvers' RMS, digests of the nodes, the gathered fields and the
    written files (JSON round-tripped, so exact floats compare equal)."""
    return json.loads(json.dumps({
        "iters": [res.reinit_iters, res.minmax_iters],
        "diverged": [res.reinit_diverged, res.minmax_diverged],
        "asym": res.asymptotic_error, "rms": rms,
        "advected": digest(res.advected),
        "fields": {f: digest(getattr(res, f)) for f in (
            "phi_init", "phi_smoothed", "phi_final")
            if getattr(res, f) is not None},
        "files": file_digests(out_dir)}))


def stage_walls(timers):
    t = timers
    return {"init": t["search"], "reinit": t["initialization"] - t["search"],
            "minmax": t["minmax"] - t["initialization"],
            "advect": t["advect"] - t["minmax"],
            "final reinit": t["total"] - t["advect"]}


def rank_pipeline(spec, devices):
    """One rank of runs L (run F's configuration through ``run()``, this
    rank's blocks, the outputs written) and L with checkpoints, then the
    advection's exchange alone, then phase 10's resumable solvers on the
    same mesh across the ranks."""
    import torch
    import torch.distributed as dist
    from levelsetfortran_tpu_torch.parallel.distributed import comm_device
    from levelsetfortran_tpu_torch.parallel.mesh import make_mesh
    from levelsetfortran_tpu_torch.parallel.sharded import ShardedLevelSet
    from levelsetfortran_tpu_torch.pipeline.cli import (build_parser,
                                                        config_from_args)
    from levelsetfortran_tpu_torch.pipeline.run import run
    from levelsetfortran_tpu_torch.solvers import checkpointed as ck
    rank = dist.get_rank()
    runs = {}
    for label, extra in (
            ("L", []),
            ("L checkpointed", ["--checkpoint-dir",
                                os.path.join(spec["tmp"], "L_ckpt"),
                                "--checkpoint-chunk", str(RUN_L_CHUNK)])):
        out_dir = os.path.join(spec["tmp"],
                               f"{label.replace(' ', '_')}_rank{rank}")
        cfg = config_from_args(build_parser().parse_args(
            [spec["stl"], *spec["args"], *extra]))
        with solver_rms() as rms:
            (res, launches), wall = rank_timed(lambda: counted(
                lambda: run(spec["stl"], cfg, out_dir=out_dir)))
        runs[label] = dict(pipeline_record(res, rms, out_dir),
                           launches=launches, wall=wall,
                           stages=stage_walls(res.timers))
        n_nodes = res.advected.shape[0]
    # the advection's exchange alone: one all-reduce of (n_nodes, 4)
    # samples, staged through the host under gloo
    buf = torch.zeros((n_nodes, 4),
                      device="cuda" if devices is None else devices[0])

    def exchange():
        b = buf.to(comm_device(buf))
        dist.all_reduce(b)
        return b.to(buf.device)

    exchange()
    _, t_ex = rank_timed(lambda: [exchange() for _ in range(EXCHANGE_REPS)])

    n, dx = spec["resumable"]
    phi0 = sphere((n, n, n), dx, 1.0,
                  "cuda" if devices is None else devices[0])
    solver = ShardedLevelSet(make_mesh((2, 2, 1), devices), phi0.shape, dx)
    blocks = solver.device_put(phi0)
    del phi0
    chunk, total = RUN_H_FULL_CHUNK, RUN_H_FULL_ITERS
    resumable = {}
    for name, fn, h in (
            ("reinit", ck.reinit_resumable_sharded, 0.1 * dx / 3.0),
            ("minmax", ck.minmax_resumable_sharded, 0.01 * dx / 3.0)):
        times = {"save": [], "restore": []}
        Timed = timed_checkpointer(times)
        d = os.path.join(spec["tmp"], f"H_ranks_{name}")
        (part, first), t_part = rank_timed(lambda: counted(lambda: fn(
            solver, blocks, h, 2 * chunk, 0.0, ckpt=Timed(d), chunk=chunk)))
        (res, launches), t_res = rank_timed(lambda: counted(lambda: fn(
            solver, blocks, h, total, 0.0, ckpt=Timed(d), chunk=chunk)))
        launches = {k: v + first[k] for k, v in launches.items()}
        resumable[name] = {
            "iters": [part.iterations, res.iterations, res.resumed_from,
                      res.diverged],
            "blocks": {str(i): digest(b) for i, b in enumerate(res.phi)
                       if b is not None},
            "launches": launches, "wall": t_part + t_res, **times}
    return {"runs": runs, "exchange_ms": 1e3 * t_ex / EXCHANGE_REPS,
            "nodes": n_nodes, "resumable": resumable}


def run_l_phase(card, tmp, run_f, world=2, device="cuda",
                resumable=(MAIN_SHAPE[0], 0.01)):
    """Phase 6b: runs L and L with checkpoints, run F across ``world``
    ranks started here (``rank_pipeline``), and phase 10 across the same
    ranks.  Every rank's counts, RMS, asymptotic error and nodes are
    bitwise run F's, rank 0's gathered fields and files too, and rank 1
    wrote none; the block kernels launched on every rank and no solo
    kernel; the resumed solves bitwise the uninterrupted solo solves here.
    Returns the ranks' launches."""
    import torch
    from levelsetfortran_tpu_torch.parallel.mesh import (make_mesh,
                                                         split_blocks)
    from levelsetfortran_tpu_torch.solvers.minmax_flow import minmax_flow
    from levelsetfortran_tpu_torch.solvers.reinit import reinit
    backend = rank_backend(world, device)
    spec = {"kind": "pipeline", "device": device, "stl": run_f["stl"],
            "args": run_f["args"], "tmp": tmp,
            "resumable": list(resumable)}
    ranks = run_ranks(spec, world, backend, tmp, "L")
    want = pipeline_record(run_f["res"], run_f["rms"], run_f["dir"])
    total = {}
    for label in ("L", "L checkpointed"):
        for r in ranks:
            got = r["runs"][label]
            mine = want if r["rank"] == 0 else dict(want, fields={},
                                                    files={})
            # a checkpointed stage calls the solver once per chunk: its
            # RMS list is per chunk, its stop decisions in the iterations
            diff = [k for k in mine if got[k] != mine[k]
                    and not (k == "rms" and label != "L")]
            check(not diff, f"run {label}: rank {r['rank']} differs from "
                  f"run F in {diff}: {[(got[k], mine[k]) for k in diff]}")
            ln = got["launches"]
            kernels = BLOCK_KERNELS[:2] + SHARDED_INIT + SHARDED_ADVECT
            check(device != "cuda" or all(ln[k] > 0 for k in kernels)
                  and all(v == 0 for k, v in ln.items()
                          if k not in kernels),
                  f"run {label}: rank {r['rank']} launches {ln}")
            for k, v in ln.items():
                total[k] = total.get(k, 0) + v
        phase(f"run {label}", f"run F on {world} ranks "
              f"{[r['device'] for r in ranks]} over {backend}: every rank's "
              f"iterations {want['iters']}, "
              + ("RMS, " if label == "L" else "") + f"asymptotic error "
              f"{want['asym']!r} and advected nodes bitwise run F's, rank "
              f"0's gathered fields and files {sorted(want['files'])} "
              f"byte-equal, the other ranks wrote none; launches per rank "
              f"{[{k: v for k, v in r['runs'][label]['launches'].items() if v} for r in ranks]}; "
              f"stage walls per rank (a stage's first exchange waits for "
              f"the slowest rank's previous stage) " + "; ".join(
                  f"rank {r['rank']} " + ", ".join(
                      f"{k} {v:.3f}" for k, v in r["runs"][label][
                          "stages"].items())
                  + f", wall {r['runs'][label]['wall']:.3f} s"
                  for r in ranks) + "; run F " + ", ".join(
                  f"{k} {v:.3f} s" for k, v in stage_walls(
                      run_f["res"].timers).items())
              + f", total {run_f['res'].timers['total']:.3f} s; card {card}")
    phase("run L", f"the advection's exchange alone: one all-reduce of "
          f"({ranks[0]['nodes']}, 4) float32 per iteration, "
          + ", ".join(f"rank {r['rank']} {r['exchange_ms']:.4f} ms"
                      for r in ranks) + f" over {backend}; card {card}")

    # phase 10 across the ranks, against the uninterrupted solo solves
    n, dx = resumable
    phi0 = sphere((n, n, n), dx, 1.0, device)
    one = make_mesh((2, 2, 1), [device])
    lines = []
    for name, plain, h in (("reinit", reinit, 0.1 * dx / 3.0),
                           ("minmax", minmax_flow, 0.01 * dx / 3.0)):
        ref = plain(phi0, dx, h, RUN_H_FULL_ITERS, 0.0).phi
        ref = {str(i): digest(b) for i, b in enumerate(split_blocks(one,
                                                                    ref))}
        got, saves, restores = {}, [], []
        for r in ranks:
            g = r["resumable"][name]
            check(g["iters"] == [2 * RUN_H_FULL_CHUNK, RUN_H_FULL_ITERS,
                                 2 * RUN_H_FULL_CHUNK, False],
                  f"run H ranks {name}: rank {r['rank']} {g['iters']}")
            check(device != "cuda" or g["launches"][
                "reinit_step_block" if name == "reinit"
                else "minmax_step_block"] > 0,
                f"run H ranks {name}: no block launch {g['launches']}")
            got.update(g["blocks"])
            saves += g["save"]
            restores += g["restore"]
            for k, v in g["launches"].items():
                total[k] = total.get(k, 0) + v
        check(got == ref, f"run H ranks {name}: the resumed blocks differ "
              f"from the uninterrupted solo solve")
        lines.append(
            f"{name} {max(r['resumable'][name]['wall'] for r in ranks):.3f}"
            f" s, save {1e3 * np.median(saves):.1f} ms (max "
            f"{1e3 * max(saves):.1f}, {len(saves)} calls over the ranks), "
            f"restore {1e3 * np.median(restores):.1f} ms")
    del phi0
    phase("run H ranks", f"resumable sharded solvers at {(n,) * 3} on "
          f"(2, 2, 1) across {world} ranks, {RUN_H_FULL_ITERS} steps in "
          f"chunks of {RUN_H_FULL_CHUNK}, stopped after two chunks and "
          f"resumed: bitwise the uninterrupted solo solves; "
          + "; ".join(lines) + f"; card {card}")
    return total


def render_run(ball, grid, kw, mesh, device="cuda"):
    """``image_loss_and_vertex_grad`` of ``ball`` on ``grid`` (zero target)
    with every kernel counted: loss, gradient, the image's digest,
    launches, wall, peak GiB and the reverse sweeps' branches."""
    import torch
    from levelsetfortran_tpu_torch import image_loss_and_vertex_grad
    from levelsetfortran_tpu_torch.ops import reverse
    v = torch.tensor(ball.vertices, dtype=torch.float32, device=device)
    target = torch.zeros((kw["height"], kw["width"]), device=device)
    reverse.last_branch.clear()
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    with keep_images() as images:
        ((loss, grad), launches), wall = rank_timed(lambda: counted(
            lambda: image_loss_and_vertex_grad(
                v, ball.elements, grid, target, culling="auto", mesh=mesh,
                **kw)))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else 0.0
    return {"loss": float(loss), "grad": grad, "image": digest(images[-1]),
            "launches": launches, "wall": wall, "peak": peak,
            "branches": dict(reverse.last_branch)}


def rank_render(spec, devices):
    """One rank of run G-ranks: run G's render on this rank's blocks of
    the (2, 2, 1) mesh across the ranks; the gradient saved to a file."""
    import torch
    from levelsetfortran_tpu_torch.models import analytic
    from levelsetfortran_tpu_torch.parallel.mesh import make_mesh
    ball = analytic.icosphere_mesh(subdivisions=spec["subdivisions"])
    out = render_run(ball, cube_grid(ball.vertices, spec["n"]), spec["kw"],
                     make_mesh((2, 2, 1), devices),
                     "cuda" if devices is None else devices[0])
    path = os.path.join(spec["tmp"],
                        f"G_grad_rank{torch.distributed.get_rank()}.pt")
    torch.save(out.pop("grad").cpu(), path)
    return dict(out, grad=path)


def run_g_ranks_phase(card, tmp, run_g, world=2, device="cuda", n=256,
                      subdivisions=5):
    """Phase 8b: run G-ranks, run G's render across ``world`` ranks started
    here (``rank_render``): the image and loss bitwise run G's, the vertex
    gradient bitwise the same on every rank and within 1e-6 of max|grad|
    of run G's (bitwise where the card's accumulation order allows), the
    block modes of K1/K3/K5/K6 launched on every rank and no solo kernel.
    Returns the ranks' launches."""
    import torch
    backend = rank_backend(world, device)
    spec = {"kind": "render", "device": device, "tmp": tmp, "n": n,
            "subdivisions": subdivisions, "kw": run_g["kw"]}
    ranks = run_ranks(spec, world, backend, tmp, "G")
    grads = [torch.load(r["grad"]) for r in ranks]
    ref = run_g["grad"].cpu()
    gmax = float(ref.abs().max())
    gerr = float((grads[0] - ref).abs().max())
    total = {}
    for r, g in zip(ranks, grads):
        check(r["loss"] == run_g["loss"] and r["image"] == run_g["image"],
              f"run G-ranks: rank {r['rank']} loss {r['loss']!r} / image "
              f"differ from run G's {run_g['loss']!r}")
        check(torch.equal(g, grads[0]), f"run G-ranks: rank {r['rank']}'s "
              f"gradient differs from rank 0's")
        ln = r["launches"]
        kernels = BLOCK_KERNELS + SHARDED_INIT
        check(device != "cuda" or all(ln[k] > 0 for k in kernels)
              and all(v == 0 for k, v in ln.items() if k not in kernels),
              f"run G-ranks: rank {r['rank']} launches {ln}")
        for k, v in ln.items():
            total[k] = total.get(k, 0) + v
    check(gerr <= 1e-6 * gmax, f"run G-ranks: gradient max err {gerr:.3g} "
          f"against run G's (max|grad| {gmax:.4g})")
    phase("run G-ranks", f"run G on {world} ranks "
          f"{[r['device'] for r in ranks]} over {backend}: loss "
          f"{run_g['loss']!r} and the image bitwise run G's, the gradient "
          f"bitwise equal on every rank, against run G's "
          + ("bitwise" if gerr == 0 else f"max err {gerr:.3g}")
          + f" (gate 1e-6 of {gmax:.4g}); launches per rank "
          f"{[{k: v for k, v in r['launches'].items() if v} for r in ranks]}"
          f"; branches {ranks[0]['branches']}; peak per rank "
          f"{[round(r['peak'], 2) for r in ranks]} GiB (run G "
          f"{run_g['peak']:.2f} GiB in one process); wall per rank "
          f"{[round(r['wall'], 3) for r in ranks]} s (run G "
          f"{run_g['wall']:.3f} s); card {card}")
    return total


# ----------------------------- operations -----------------------------

#: Run H: run C's configuration with checkpoints every RUN_H_CHUNK
#: iterations and a metrics event every RUN_H_METRICS; at full size the
#: resumable solvers at 222^3 in chunks of RUN_H_FULL_CHUNK, stopped after
#: two chunks and resumed to RUN_H_FULL_ITERS (stop test off).
RUN_H_CHUNK, RUN_H_METRICS = 100, 100
RUN_H_FULL_CHUNK, RUN_H_FULL_ITERS = 20, 100
#: Run I: run B's mesh with the reference-mode init and a metrics event
#: every 9 iterations (the banded cadences: 9-step reinit chunks, 20-step
#: min/max chunks); its near-surface gate on phi_init, in units of dx.
RUN_I_METRICS, RUN_I_NEAR_DX = 9, 2.0


class Stream:
    """A fresh metrics sink while the block runs: ``.events`` as
    (stage, iteration) pairs, ``.raw`` the events themselves."""

    def __enter__(self):
        from levelsetfortran_tpu_torch.utils import metrics
        self._old = metrics.get_stream()
        self._new = metrics.set_stream(metrics.MetricsStream(log=False))
        return self

    def __exit__(self, *exc):
        from levelsetfortran_tpu_torch.utils import metrics
        metrics.set_stream(self._old)
        self.raw = list(self._new.events)
        self.events = [(e["stage_name"], e["iteration"]) for e in self.raw]


def ckpt_steps(directory):
    """The complete steps of each stage's checkpoint directory."""
    return {stage: sorted(int(n) for n in os.listdir(
        os.path.join(directory, stage)) if n.isdigit())
        for stage in ("reinit", "minmax")}


def run_h_phase(mesh, res_c, card, tmp, device="cuda"):
    """Phase 9, run H: run C's configuration (dense) with checkpoints and
    the metrics stream, through the CLI and in process (its launch
    counters read around it); every field bitwise run C's.  Then a run
    preempted after 500 min/max steps and resumed on its directory."""
    import torch
    from levelsetfortran_tpu_torch import write_stl
    from levelsetfortran_tpu_torch.grid import grid as gridmod
    from levelsetfortran_tpu_torch.io.vti import read_vti
    from levelsetfortran_tpu_torch.pipeline.cli import (build_parser,
                                                        config_from_args)
    from levelsetfortran_tpu_torch.pipeline.run import run
    from levelsetfortran_tpu_torch.solvers.reinit import reinit

    dx = 0.05
    stl = os.path.join(tmp, "H.stl")
    write_stl(stl, mesh)

    def args(name):
        return [stl, "--dx", str(dx), "--narrow-band", "off",
                "--checkpoint-dir", os.path.join(tmp, f"H_{name}_ck"),
                "--checkpoint-chunk", str(RUN_H_CHUNK), "--metrics-every",
                str(RUN_H_METRICS), "--device", device, "--out-dir",
                os.path.join(tmp, f"H_{name}")]

    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "levelsetfortran_tpu_torch", *args("cli")],
        cwd=HERE, capture_output=True, text=True, timeout=900)
    cli_s = time.perf_counter() - t0
    check(proc.returncode == 0,
          f"run H CLI failed:\n{proc.stdout}\n{proc.stderr[-4000:]}")
    it_c = EXPECTED_ITERS["C"]
    check(f"reinit_iters={it_c[0]} minmax_iters={it_c[1]}" in proc.stdout,
          f"run H CLI printed {proc.stdout!r}")
    cli_out = os.path.join(tmp, "H_cli")
    for f, ref in (("signedDistanceFunction.vti", res_c.phi_init),
                   ("smoothedDistanceFunction.vti", res_c.phi_smoothed)):
        check(np.array_equal(read_vti(os.path.join(cli_out, f))[0], ref),
              f"run H CLI: {f} differs from run C's")

    cfg = config_from_args(build_parser().parse_args(args("py")))
    for c in run_counters():
        c.launches = 0
    with Stream() as stream:
        res, wall = sync_time(lambda: run(stl, cfg, out_dir=os.path.join(
            tmp, "H_py")))
    launches = {c.__name__: c.launches for c in run_counters()}
    check(np.array_equal(res.phi_init, res_c.phi_init)
          and np.array_equal(res.phi_smoothed, res_c.phi_smoothed),
          "run H: phi_init / phi_smoothed differ from run C's")
    check((res.reinit_iters, res.minmax_iters) == it_c,
          f"run H: iterations {res.reinit_iters} / {res.minmax_iters}")
    check(not (res.reinit_diverged or res.minmax_diverged),
          "run H: diverged")
    check(device != "cuda" or launches["reinit_step"] > 0
          and launches["minmax_step"] > 0
          and launches["minmax_fusedk"] == 0
          and launches["reinit_step_block"] == 0
          and launches["minmax_step_block"] == 0,
          f"run H: launches {launches}")
    kept = {d: ckpt_steps(os.path.join(tmp, f"H_{d}_ck"))
            for d in ("cli", "py")}
    check(all(len(v) <= 3 for k in kept.values() for v in k.values())
          and kept["py"] == {"reinit": [it_c[0]],
                             "minmax": [900, 1000, it_c[1]]}
          and kept["cli"] == kept["py"], f"run H: checkpoints kept {kept}")
    # JAX's rule: the chunked stages emit nothing, the final reinit (dense
    # here) an event every RUN_H_METRICS steps; its count from the same
    # solve on run C's phi_smoothed, whose field is the run's phi_final
    dxx = dx / gridmod.surface_diag(mesh.vertices)
    rf = reinit(torch.tensor(res.phi_smoothed, dtype=torch.float32,
                             device=device),
                dx, cfg.final_reinit_cfl * dxx, cfg.final_reinit_iters,
                cfg.reinit_tol, eps_scale=cfg.weno_eps_scale,
                eps_floor=cfg.eps_floor)
    check(np.array_equal(rf.phi.double().cpu().numpy(), res.phi_final),
          "run H: the final reinit's count could not be read back")
    want = [("reinit", k) for k in range(RUN_H_METRICS, rf.iterations + 1,
                                         RUN_H_METRICS)]
    check(stream.events == want,
          f"run H: metrics events {stream.events}, want {want}")
    t, tc = res.timers, res_c.timers
    phase("run H", f"run C's configuration with --checkpoint-dir, "
          f"--checkpoint-chunk {RUN_H_CHUNK}, --metrics-every "
          f"{RUN_H_METRICS}: CLI and run() phi_init / phi_smoothed bitwise "
          f"run C's, iterations {res.reinit_iters} / {res.minmax_iters}, "
          f"steps kept {kept['py']}, metrics events {len(stream.events)} "
          f"(the final reinit took {rf.iterations} steps), launches "
          f"{launches}; walls: CLI {cli_s:.1f} s, run() {wall:.3f} s, "
          f"stages reinit {t['initialization'] - t['search']:.4f} s / "
          f"min/max {t['minmax'] - t['initialization']:.4f} s (run C "
          f"{tc['initialization'] - tc['search']:.4f} / "
          f"{tc['minmax'] - tc['initialization']:.4f} s); card {card}")

    # preempted after 500 min/max steps, then the full run on its directory
    ck = os.path.join(tmp, "H_resume_ck")
    with Logged() as log:
        (cut, again), t_res = sync_time(lambda: (
            run(stl, cfg.replace(checkpoint_dir=ck, minmax_iters=500),
                write_outputs=False),
            run(stl, cfg.replace(checkpoint_dir=ck), write_outputs=False)))
    resumes = [(r["stage"], r["step"]) for r in log.records
               if r.get("event") == "resume"]
    check(cut.minmax_iters == 500 and np.array_equal(cut.phi_init,
                                                     res_c.phi_init),
          f"run H preempted: {cut.reinit_iters} / {cut.minmax_iters}")
    check(resumes == [("reinit", it_c[0]), ("minmax", 500)],
          f"run H resumed: resume events {resumes}")
    check((again.reinit_iters, again.minmax_iters) == (it_c[0] + 1, it_c[1])
          and np.array_equal(again.phi_smoothed, res_c.phi_smoothed),
          f"run H resumed: iterations {again.reinit_iters} / "
          f"{again.minmax_iters}, or phi_smoothed differs from run C's")
    phase("run H", f"preempted after 500 min/max steps, then resumed on "
          f"the same directory: resumed {resumes} (the converged reinit "
          f"stage takes one more step, {again.reinit_iters}, as in the JAX "
          f"package), min/max {again.minmax_iters}, phi_smoothed bitwise "
          f"run C's; both calls {t_res:.3f} s; card {card}")
    return launches


def run_h_full_phase(card, tmp, device="cuda", n=MAIN_SHAPE[0], dx=0.01):
    """Phase 10: the resumable solvers at the kernels' main shape (the
    kernel phases' sphere, 222^3), solo and on (2,2,1) blocks of one card:
    stopped after two chunks, resumed from a fresh checkpointer, bitwise
    an uninterrupted solo solve; save and restore timed per call."""
    from levelsetfortran_tpu_torch.parallel.mesh import (gather_blocks,
                                                         make_mesh)
    from levelsetfortran_tpu_torch.parallel.sharded import ShardedLevelSet
    from levelsetfortran_tpu_torch.solvers import checkpointed as ck
    from levelsetfortran_tpu_torch.solvers.minmax_flow import minmax_flow
    from levelsetfortran_tpu_torch.solvers.reinit import reinit

    times = {"save": [], "restore": []}
    Timed = timed_checkpointer(times)

    phi0 = sphere((n, n, n), dx, 1.0, device)
    mesh = make_mesh((2, 2, 1), [device])
    solver = ShardedLevelSet(mesh, phi0.shape, dx)
    blocks = solver.device_put(phi0)
    chunk, total = RUN_H_FULL_CHUNK, RUN_H_FULL_ITERS
    h = {"reinit": 0.1 * dx / 3.0, "minmax": 0.01 * dx / 3.0}
    cases = (
        ("reinit", reinit, lambda x, **k: ck.reinit_resumable(
            phi0, dx, h["reinit"], x, 0.0, **k)),
        ("minmax", minmax_flow, lambda x, **k: ck.minmax_resumable(
            phi0, dx, h["minmax"], x, 0.0, **k)),
        ("reinit sharded", reinit, lambda x, **k: ck.reinit_resumable_sharded(
            solver, blocks, h["reinit"], x, 0.0, **k)),
        ("minmax sharded", minmax_flow,
         lambda x, **k: ck.minmax_resumable_sharded(
             solver, blocks, h["minmax"], x, 0.0, **k)))
    lines = []
    for name, plain, solve in cases:
        ref, t_plain = sync_time(lambda: plain(
            phi0, dx, h[name.split()[0]], total, 0.0))
        d = os.path.join(tmp, "H_full_" + name.replace(" ", "_"))
        times["save"].clear()
        times["restore"].clear()
        part, t_part = sync_time(lambda: solve(2 * chunk, ckpt=Timed(d),
                                               chunk=chunk))
        res, t_res = sync_time(lambda: solve(total, ckpt=Timed(d),
                                             chunk=chunk))
        got = gather_blocks(mesh, res.phi) if "sharded" in name else res.phi
        check(part.iterations == 2 * chunk and res.resumed_from == 2 * chunk
              and res.iterations == total and not res.diverged,
              f"run H 222^3 {name}: {part.iterations}, {res.iterations}, "
              f"resumed from {res.resumed_from}, diverged {res.diverged}")
        check(bitwise(got, ref.phi), f"run H 222^3 {name}: the resumed "
              f"solve differs from the uninterrupted solo one by "
              f"{err(got, ref.phi):.3g}")
        lines.append(
            f"{name} {t_part + t_res:.3f} s against {t_plain:.3f} s "
            f"uninterrupted (save {1e3 * np.median(times['save']):.1f} ms "
            f"x {len(times['save'])}, restore "
            f"{1e3 * np.median(times['restore']):.1f} ms)")
    mb = phi0.numel() * phi0.element_size() / 1e6
    phase("run H 222^3", f"resumable solvers, {total} steps in chunks of "
          f"{chunk} (stop test off), stopped after two chunks and resumed: "
          f"bitwise the uninterrupted solo solves, solo and on (2, 2, 1) "
          f"blocks; {mb:.1f} MB per save; " + "; ".join(lines)
          + f"; card {card}")


def run_i_phase(mesh, truth_fn, res_b, card, tmp, device="cuda", dx=0.01):
    """Phase 11, run I: run B's mesh through run() with the reference-mode
    init (dense initial reinit, banded min/max and final reinit) and the
    metrics stream, its launch counters read around it."""
    import torch
    from levelsetfortran_tpu_torch import LevelSetConfig, write_stl
    from levelsetfortran_tpu_torch.pipeline.run import run

    stl = os.path.join(tmp, "I.stl")
    write_stl(stl, mesh)
    cfg = LevelSetConfig(dx=dx, init_mode="reference",
                         metrics_every=RUN_I_METRICS, device=device)
    for c in run_counters():
        c.launches = 0
    with Stream() as stream:
        res, wall = sync_time(lambda: run(stl, cfg, write_outputs=False))
    launches = {c.__name__: c.launches for c in run_counters()}
    truth = truth_fn(res.grid.coords(dtype=torch.float64).numpy())
    phi = res.phi_init
    finite = all(np.isfinite(f).all() for f in
                 (res.phi_init, res.phi_smoothed, res.phi_final,
                  res.advected))
    far = np.abs(truth) > 2 * dx
    wrong = int((np.sign(phi[far]) != np.sign(truth[far])).sum())
    near = np.abs(truth) < 0.2
    e_near = float(np.abs(phi - truth)[near].max())
    by = {}
    for stage, it in stream.events:
        by.setdefault(stage, []).append(it)
    chunk_m = 4 * (1 + 2 * ((cfg.minmax_nb_refresh_every // 4) // 2))
    chunk_r = 1 + 2 * (cfg.nb_refresh_every // 2)
    every_m = chunk_m * max(1, RUN_I_METRICS // chunk_m)
    every_r = chunk_r * max(1, RUN_I_METRICS // chunk_r)
    want_r = list(range(RUN_I_METRICS, res.reinit_iters + 1, RUN_I_METRICS))
    want_m = list(range(every_m, res.minmax_iters + 1, every_m))
    final = by.get("reinit_narrowband", [])
    bands = [e.get("band_tiles", 0) for e in stream.raw
             if e["stage_name"].endswith("narrowband")]
    counts = {k: len(v) for k, v in by.items()}
    t, tb = res.timers, res_b.timers

    def stages(tt):
        return (f"init {tt['search']:.3f} s, reinit "
                f"{tt['initialization'] - tt['search']:.4f} s, min/max "
                f"{tt['minmax'] - tt['initialization']:.4f} s, advect "
                f"{tt['advect'] - tt['minmax']:.3f} s, final reinit "
                f"{tt['total'] - tt['advect']:.4f} s")

    phase("run I", f"icosphere {mesh.n_elems} triangles, dx {dx}, grid "
          f"{res.grid.shape}, init_mode reference, metrics every "
          f"{RUN_I_METRICS}: reinit_iters {res.reinit_iters} (dense, cap "
          f"{cfg.reinit_iters}), minmax_iters {res.minmax_iters}; phi_init "
          f"sign wrong at {wrong} of {int(far.sum())} points with |truth| > "
          f"2 dx, near-surface max err {e_near:.4g} "
          f"({e_near / dx:.3f} dx, gate {RUN_I_NEAR_DX} dx); events "
          f"{counts}, banded events' "
          f"band_tiles {min(bands, default=0)}-{max(bands, default=0)}; "
          f"launches {launches}; wall {wall:.3f} s: {stages(t)} (run B: "
          f"{stages(tb)}); card {card}")
    check(finite and not (res.reinit_diverged or res.minmax_diverged),
          "run I: diverged or non-finite")
    check(wrong == 0, f"run I: phi_init takes the wrong sign at {wrong} "
          f"points farther than 2 dx from the surface")
    check(e_near < RUN_I_NEAR_DX * dx,
          f"run I: near-surface error {e_near} >= {RUN_I_NEAR_DX} dx")
    check(by.get("reinit", []) == want_r and by.get(
        "minmax_narrowband", []) == want_m and final == list(
        range(every_r, every_r * len(final) + 1, every_r))
          and set(by) <= {"reinit", "minmax_narrowband",
                          "reinit_narrowband"} and min(bands, default=1) > 0,
          f"run I: metrics events {by}")
    # (the counters count kernel launches: none off the card)
    check(device != "cuda" or launches["reinit_step"] > 0
          and launches["minmax_fusedk"] > 0
          and launches["reinit_step_block"] == 0
          and launches["minmax_step_block"] == 0,
          f"run I: launches {launches}")
    return launches


def throughput_line(card, device="cuda", n=BENCH_N):
    """``utils/profiling.measure_cell_updates_per_sec`` on dense K1 at the
    shape of the JAX package's headline ``bench.py:920``
    (``weno5_reinit_cell_updates_per_sec_2563``: the bench sphere, h = 0.1
    dx, a step scan of ``reinit_fixed``'s forward)."""
    import torch
    from levelsetfortran_tpu_torch.ops import weno_cuda as wc
    from levelsetfortran_tpu_torch.utils.profiling import \
        measure_cell_updates_per_sec

    xs = np.linspace(-1.0, 1.0, n)
    gx, gy, gz = np.meshgrid(xs, xs, xs, indexing="ij")
    phi0 = torch.tensor(np.sqrt(gx ** 2 + gy ** 2 + gz ** 2) - BENCH_R,
                        dtype=torch.float32, device=device)
    dx = 2.0 / (n - 1)

    def scan(steps):
        def go(p):
            bufs = (torch.empty_like(p), torch.empty_like(p))
            q = p
            for s in range(steps):
                q = wc.reinit_step(q, p, dx, 0.1 * dx, out=bufs[s % 2])
            return q
        return go

    out = measure_cell_updates_per_sec(scan, phi0)
    phase("profiling", f"dense K1 at {n}^3, two-point protocol (5 and 40 "
          f"steps): {out['cell_updates_per_sec']:.4g} cell-updates/s, "
          f"{1e3 * out['seconds_per_step']:.4f} ms per step; card {card}")
    return out


# ---------------------------- solver options ----------------------------

#: The options phase: K4's block mode driven for K4_BLOCK_ROUNDS exchanges
#: of 4 fused steps; the full-width solves take OPTIONS_STEPS steps at the
#: kernel phases' 222^3 sphere and are held against the CPU at
#: OPTIONS_CPU_N^3; the differentiable options at run D's 256^3 take run
#: D's step counts and are held against the CPU at 24^3 (run D's gate).
K4_BLOCK_ROUNDS = 5
OPTIONS_STEPS = 50
OPTIONS_CPU_N = 64
#: Card against CPU for the same plain float32 tensor ops: their rounding
#: agrees but for the math library's (the true curvature's cube and
#: square roots), so the fields are held to 1e-5 after 50 steps.
OPTIONS_CPU_TOL = 1e-5


def fusedk_block_phase(record, card, device="cuda", shape=MAIN_SHAPE,
                       dx=0.01, radius=1.0, rounds=K4_BLOCK_ROUNDS):
    """K4's block mode (``minmax_fusedk_block``) on the (2, 2, 1) split of
    the kernel phases' sphere with a halo of 4: every padded block against
    its plain version (dense and banded, with the sum) and a second launch,
    bitwise; the gathered owned cells against the global K4, bitwise; one
    block timed beside its bound and its plain version.  Then its drive:
    ``rounds`` halo exchanges, each followed by one launch per block, the
    counters set to 0 around it, the gathered field bitwise ``rounds``
    global K4 launches.  Returns the drive's launches."""
    import torch
    from levelsetfortran_tpu_torch.ops import minmax_cuda as mc
    from levelsetfortran_tpu_torch.ops import weno_cuda as wc
    from levelsetfortran_tpu_torch.parallel import sharded as sh
    from levelsetfortran_tpu_torch.parallel.halo import crop, halo_exchange
    from levelsetfortran_tpu_torch.parallel.mesh import (gather_blocks,
                                                         make_mesh,
                                                         split_blocks)
    K = 4
    mesh = make_mesh((2, 2, 1), [device])
    phi = sphere(shape, dx, radius, device)
    h1 = 0.01 * dx / 3.0
    w = sh.sharded_widths(mesh, K)
    geoms = sh.minmax_geoms(mesh, shape, w)
    blocks = split_blocks(mesh, phi)
    pads = halo_exchange(blocks, w, mesh)
    acts = [wc.tile_activity(b, dx, 4.1, window="owned") for b in blocks]
    rel, frozen = 0.0, [0, 0]
    for p, g, a in zip(pads, geoms, acts):
        frozen[0] += int(a.numel() - a.sum())
        frozen[1] += a.numel()
        for act in (None, a):
            k, kd = mc.minmax_fusedk_block(p, dx, h1, g, ksteps=K,
                                           active=act, with_rms=True)
            q, qd = mc.minmax_fusedk_block_plain(p, dx, h1, g, ksteps=K,
                                                 active=act, with_rms=True)
            check(bitwise(k, q), f"K4 block {tuple(p.shape)}: differs from "
                  f"its plain version ({err(k, q):.3g})")
            rel = max(rel, abs(float(kd) - float(qd)) / float(qd))
        check(twice_equal(lambda: mc.minmax_fusedk_block(
            p, dx, h1, g, ksteps=K, active=a, with_rms=True)),
            "K4 block: two launches differ")
    check(rel <= 1e-12, f"K4 block: sums rel {rel:.3g} against the plain")
    check(0 < frozen[0] < frozen[1], "K4 block: the masks skip nothing")
    for act_g, acts_b in ((None, [None] * len(pads)),
                          (wc.tile_activity(phi, dx, 4.1, window="owned"),
                           acts)):
        glob = mc.minmax_fusedk(phi, dx, h1, ksteps=K, active=act_g)
        owned = [crop(mc.minmax_fusedk_block(p, dx, h1, g, ksteps=K,
                                             active=a), w)
                 for p, g, a in zip(pads, geoms, acts_b)]
        check(torch.equal(gather_blocks(mesh, owned), glob),
              f"K4 block: the owned cells differ from the global K4 "
              f"(banded {act_g is not None})")
    p, g = pads[0], geoms[0]
    rec = record["minmax_fusedk_block"]

    def launch():
        return mc.minmax_fusedk_block(p, dx, h1, g, ksteps=K, with_rms=True)

    rec["ms"] = median_ms(launch, 20)
    rec["device_ms"] = device_ms(launch)
    rec["plain_ms"] = median_ms(lambda: mc.minmax_fusedk_block_plain(
        p, dx, h1, g, ksteps=K, with_rms=True), 5)
    rec.update(bound(8 * p.numel(), K * OPS["minmax_band"] * band_cells(
        p, dx) + OPS["rms"] * p.numel()))
    ref = phi
    for _ in range(rounds):
        ref = mc.minmax_fusedk(ref, dx, h1, ksteps=K)

    def drive():
        bl = blocks
        for _ in range(rounds):
            bl = [crop(mc.minmax_fusedk_block(pd, dx, h1, gm, ksteps=K),
                       w).contiguous()
                  for pd, gm in zip(halo_exchange(bl, w, mesh), geoms)]
        return bl

    (out, launches), wall = sync_time(lambda: counted(drive))
    check(torch.equal(gather_blocks(mesh, out), ref),
          f"K4 block drive: {rounds} rounds differ from the global K4 "
          f"({err(gather_blocks(mesh, out), ref):.3g})")
    n = len(pads) * rounds
    check(device != "cuda" or launches == {
        k: (n if k == "minmax_fusedk_block" else 0) for k in launches},
          f"K4 block drive: launches {launches}")
    phase("options", f"K4 block {tuple(p.shape)} of {shape} on (2, 2, 1), "
          f"halo {K}: every block bitwise its plain version (dense and "
          f"banded, {frozen[0]}/{frozen[1]} bricks frozen; sums rel "
          f"{rel:.3g}) and a second launch, the owned cells bitwise the "
          f"global K4 (dense and banded); kernel {rec['ms']:.4f} ms, device "
          f"{rec['device_ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, "
          f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}); drive: "
          f"{rounds} exchanges of {K} fused steps, {n} launches, bitwise "
          f"{rounds} global K4 launches, {wall:.3f} s; card {card}")
    return launches


def option_solves(device, n, dx, radius=1.0, steps=OPTIONS_STEPS):
    """The three full-width solves with non-default options at ``n``^3,
    stop test off: ``{name: (result, wall, launches)}``."""
    from levelsetfortran_tpu_torch.pipeline.run import gradient_magnitude
    from levelsetfortran_tpu_torch.solvers.minmax_flow import minmax_flow
    from levelsetfortran_tpu_torch.solvers.reinit import reinit
    phi = sphere((n,) * 3, dx, radius, device)
    h, h1 = 0.1 * dx, 0.05 * dx * dx
    solves = {
        "minmax_flow(use_true_curvature=True)": lambda: minmax_flow(
            phi, dx, h1, steps, 0.0, use_true_curvature=True),
        "minmax_flow(avg_halfwidth=2)": lambda: minmax_flow(
            phi, dx, h1, steps, 0.0, avg_halfwidth=2),
        "reinit(grad_fn=gradient_magnitude)": lambda: reinit(
            1.5 * phi, dx, h, steps, 0.0,
            grad_fn=lambda q: gradient_magnitude(q, dx))}
    out = {}
    for name, solve in solves.items():
        solve()                                     # warm-up
        (res, launches), wall = sync_time(lambda: counted(solve))
        out[name] = (res, wall, launches)
    return out


def option_solves_phase(card, device="cuda", n=MAIN_SHAPE[0], dx=0.01,
                        n_cpu=OPTIONS_CPU_N):
    """The solvers' non-default options at full width: each solve's
    ``OPTIONS_STEPS`` steps at ``n``^3 timed, no kernel launched (the
    route follows the options, as in the JAX package), and the same solve
    at ``n_cpu``^3 on the card against the CPU."""
    small_dx = 2.52 / (n_cpu - 1)
    big = option_solves(device, n, dx)
    card_small = option_solves(device, n_cpu, small_dx)
    cpu_small = option_solves("cpu", n_cpu, small_dx)
    lines = []
    for name, (res, wall, launches) in big.items():
        check(not any(launches.values()),
              f"options: {name} launched kernels {launches}")
        check(res.iterations == OPTIONS_STEPS and math.isfinite(
            res.final_rms), f"options: {name} {res.iterations} steps, rms "
            f"{res.final_rms}")
        e = err(card_small[name][0].phi.cpu(), cpu_small[name][0].phi)
        check(e <= OPTIONS_CPU_TOL, f"options: {name} at {n_cpu}^3 differs "
              f"from the CPU by {e:.3g}")
        lines.append(f"{name} {wall:.3f} s (rms {res.final_rms:.4g}; at "
                     f"{n_cpu}^3 card vs CPU max err {e:.3g})")
    phase("options", f"{OPTIONS_STEPS} steps at {(n,) * 3}, no kernel "
          f"launched (tol {OPTIONS_CPU_TOL:g} against the CPU): "
          + "; ".join(lines) + f"; card {card}")


def fixed_options_run(device, n, dx, radius, which):
    """One differentiable solve with a non-default option on the ``n``^3
    sphere: loss mean(out^2) and its gradients in phi0, dx and h (h1).
    The sphere sits off the grid's symmetry planes: on a symmetric field
    the grid corners take |grad phi| = 0 exactly after the ghost BC, and
    the square root in ``gradient_magnitude`` then gives NaN gradients
    there, in the JAX package as here (ROADMAP H21)."""
    import torch
    from levelsetfortran_tpu_torch.pipeline.run import gradient_magnitude
    from levelsetfortran_tpu_torch.solvers.minmax_flow import \
        minmax_flow_fixed
    from levelsetfortran_tpu_torch.solvers.reinit import reinit_fixed
    p = sphere((n,) * 3, dx, radius, device,
               center=(0.013, -0.021, 0.007)).requires_grad_(True)
    sc = [torch.tensor(v, device=device, requires_grad=True)
          for v in ((dx, 0.05 * dx * dx) if which == "minmax"
                    else (dx, 0.1 * dx))]
    if which == "minmax":
        out = minmax_flow_fixed(p, *sc, RUN_D_KW["minmax_steps"],
                                use_true_curvature=True)
    else:
        out = reinit_fixed(p, *sc, RUN_D_KW["reinit_steps"],
                           grad_fn=lambda q: gradient_magnitude(q, dx))
    loss = torch.mean(out * out)
    loss.backward()
    return float(loss.detach()), [p.grad] + [t.grad for t in sc]


def fixed_options_phase(card, device="cuda", n=BENCH_N):
    """The differentiable options at run D's size (run D's step counts):
    wall, peak and a finite gradient; the same at 24^3 on the card against
    the CPU (loss rtol 1e-4, gradients atol 1e-4 / rtol 1e-3)."""
    import torch
    names = {"minmax": "minmax_flow_fixed(use_true_curvature=True) x "
                       f"{RUN_D_KW['minmax_steps']}",
             "reinit": "reinit_fixed(grad_fn=gradient_magnitude) x "
                       f"{RUN_D_KW['reinit_steps']}"}
    lines = []
    for which, name in names.items():
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        ((loss, grads), launches), wall = sync_time(lambda: counted(
            lambda: fixed_options_run(device, n, 2.0 / (n - 1), 0.6,
                                      which)))
        check(not any(launches.values()),
              f"options: {name} launched kernels {launches}")
        peak = (torch.cuda.max_memory_allocated() / 2 ** 30
                if device == "cuda" else float("nan"))
        check(math.isfinite(loss) and all(bool(torch.isfinite(g).all())
                                          for g in grads)
              and float(grads[0].abs().max()) > 0,
              f"options: {name} at {n}^3: loss {loss}, gradient not finite")
        a = fixed_options_run(device, 24, 2.4 / 23, 0.6, which)
        b = fixed_options_run("cpu", 24, 2.4 / 23, 0.6, which)
        check(abs(a[0] - b[0]) <= 1e-4 * abs(b[0]) and all(
            torch.allclose(x.cpu(), y, atol=1e-4, rtol=1e-3)
            for x, y in zip(a[1], b[1])),
            f"options: {name} at 24^3: the card differs from the CPU "
            f"(loss {a[0]!r} / {b[0]!r})")
        lines.append(f"{name}: loss {loss:.6g}, max|grad| "
                     f"{float(grads[0].abs().max()):.4g}, d/d dx "
                     f"{float(grads[1]):.4g}, wall {wall:.3f} s, peak "
                     f"{peak:.2f} GiB; at 24^3 loss rel "
                     f"{abs(a[0] - b[0]) / abs(b[0]):.3g} vs the CPU")
    phase("options", f"differentiable options at {(n,) * 3}: "
          + "; ".join(lines) + f"; card {card}")


def halfwidth_case(mesh, phi, dx, device, steps=RUN_D_KW["minmax_steps"]):
    """``minmax_fixed_sharded(avg_halfwidth=2)`` on ``mesh`` with loss
    mean(out^2): this process's blocks and block gradients (tensors, None
    for another rank's), the scalar gradients and the wall."""
    import torch
    from levelsetfortran_tpu_torch.parallel import sharded as sh
    from levelsetfortran_tpu_torch.parallel.mesh import split_blocks
    blocks = [None if b is None else b.requires_grad_(True)
              for b in split_blocks(mesh, phi)]
    sc = [torch.tensor(v, device=device, requires_grad=True)
          for v in (dx, 0.05 * dx * dx)]

    def solve():
        outs = sh.minmax_fixed_sharded(mesh, blocks, *sc, steps,
                                       avg_halfwidth=2)
        loss = sum(torch.sum(o * o) for o in outs if o is not None)
        loss.backward()
        return outs

    outs, wall = rank_timed(solve)
    return {"out": [None if o is None else o.detach() for o in outs],
            "grad": [None if b is None else b.grad for b in blocks],
            "scalars": [float(t.grad) for t in sc], "wall": wall}


def rank_halfwidth(spec, devices):
    """One rank of the sharded half-width-2 run: this rank's blocks and
    gradients as digests, the scalar gradients."""
    import torch
    from levelsetfortran_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh((2, 2, 1), devices)
    dev = "cuda" if devices is None else devices[0]
    res = halfwidth_case(mesh, torch.load(spec["field"]).to(dev),
                         spec["dx"], dev)
    return {"blocks": {f"{k}.{i}": digest(t) for k in ("out", "grad")
                       for i, t in enumerate(res[k]) if t is not None},
            "scalars": res["scalars"], "wall": res["wall"]}


def halfwidth_phase(card, tmp, device="cuda", n=BENCH_N, world=2):
    """``minmax_fixed_sharded(avg_halfwidth=2)`` at ``n``^3 on (2, 2, 1) in
    one process against the solo ``minmax_flow_fixed(avg_halfwidth=2)``
    (the values bitwise: the same per-cell float32 ops; the gradients
    within 1e-5 of max|grad| and the scalars 1e-4 relative: the exchange's
    transpose and the shards' sums add in another order), then on
    ``world`` ranks over gloo or NCCL, every rank bitwise the one-process
    run."""
    import torch
    from levelsetfortran_tpu_torch.parallel.mesh import (gather_blocks,
                                                         make_mesh)
    from levelsetfortran_tpu_torch.solvers.minmax_flow import \
        minmax_flow_fixed
    dx = 2.0 / (n - 1)
    phi = sphere((n,) * 3, dx, 0.6, device)
    mesh = make_mesh((2, 2, 1), [device])
    (one, launches) = counted(lambda: halfwidth_case(mesh, phi, dx, device))
    check(not any(launches.values()), f"options: the sharded half-width 2 "
          f"launched kernels {launches}")
    p = phi.clone().requires_grad_(True)
    sc = [torch.tensor(v, device=device, requires_grad=True)
          for v in (dx, 0.05 * dx * dx)]
    solo, wall = sync_time(lambda: minmax_flow_fixed(
        p, *sc, RUN_D_KW["minmax_steps"], avg_halfwidth=2))
    torch.sum(solo * solo).backward()
    check(bitwise(gather_blocks(mesh, one["out"]), solo.detach()),
          "options: the sharded half-width 2 differs from the solo solve")
    gmax = float(p.grad.abs().max())
    gerr = err(gather_blocks(mesh, one["grad"]), p.grad)
    check(gmax > 0 and gerr <= 1e-5 * gmax, f"options: sharded gradient err "
          f"{gerr:.3g} (max {gmax:.4g})")
    srel = [abs(a - float(t.grad)) / abs(float(t.grad))
            for a, t in zip(one["scalars"], sc)]
    check(max(srel) <= 1e-4, f"options: sharded scalar gradients {srel}")
    field = os.path.join(tmp, "halfwidth_field.pt")
    torch.save(phi.cpu(), field)
    backend = rank_backend(world, device)
    ranks = run_ranks({"kind": "halfwidth", "device": device,
                       "field": field, "dx": dx}, world, backend, tmp, "HW")
    want = {f"{k}.{i}": digest(t) for k in ("out", "grad")
            for i, t in enumerate(one[k])}
    got = {}
    for r in ranks:
        check(r["scalars"] == one["scalars"], f"options: rank {r['rank']} "
              f"scalar gradients {r['scalars']} vs {one['scalars']}")
        got.update(r["blocks"])
    check(got == want, "options: the ranks' blocks or gradients differ from "
          "the one-process run")
    phase("options", f"minmax_fixed_sharded(avg_halfwidth=2) x "
          f"{RUN_D_KW['minmax_steps']} at {(n,) * 3} on (2, 2, 1): values "
          f"bitwise the solo minmax_flow_fixed(avg_halfwidth=2), gradient "
          f"max err {gerr:.3g} of {gmax:.4g}, scalars rel "
          f"{max(srel):.3g}; forward + backward {one['wall']:.3f} s (solo "
          f"forward {wall:.3f} s); {world} ranks on "
          f"{[r['device'] for r in ranks]} over {backend}: blocks, "
          f"gradients and scalars bitwise the one-process run, wall per "
          f"rank {[round(r['wall'], 3) for r in ranks]} s; card {card}")


def options_phase(card, record, tmp, device="cuda"):
    """Phase 15: K4's block mode, then the solvers' non-default options.
    Returns the launches of K4's block drive."""
    launches = fusedk_block_phase(record, card, device)
    option_solves_phase(card, device)
    fixed_options_phase(card, device)
    halfwidth_phase(card, tmp, device)
    return launches


def kernel_counters():
    """Every kernel wrapper of the record, by name: their launch
    counters."""
    from levelsetfortran_tpu_torch.ops import advect_cuda, cull_cuda, init_cuda
    from levelsetfortran_tpu_torch.ops import minmax_cuda as mc
    from levelsetfortran_tpu_torch.ops import weno_cuda as wc
    mods = (wc, mc, init_cuda, advect_cuda, cull_cuda)
    return {n: next(getattr(m, n) for m in mods if hasattr(m, n))
            for n in kernel_names()}


@contextlib.contextmanager
def no_kernel(what):
    """Zero every launch counter, and fail if the block launched a
    kernel of csrc/ on the field: K10, the init's culling, builds the
    candidate lists on the card whatever the field's dtype (they do not
    depend on it), so it does not count."""
    counters = kernel_counters()
    del counters["cull_rows"]
    for c in counters.values():
        c.launches = 0
    yield
    launched = {n: c.launches for n, c in counters.items() if c.launches}
    check(not launched, f"{what}: kernels launched {launched}")


def parity_on_card(card, device="cuda"):
    """Phase 16a: ``REFERENCE_PARITY`` on the card (its default device)
    against the golden of the JAX package's parity run, at the CPU test's
    gates."""
    from levelsetfortran_tpu_torch.config import REFERENCE_PARITY
    from levelsetfortran_tpu_torch.models.analytic import two_cubes_mesh
    from levelsetfortran_tpu_torch.pipeline.run import run_mesh
    g = np.load(os.path.join(HERE, "tests", "golden",
                             "parity_twocube10.npz"))
    check(REFERENCE_PARITY.device == "cuda", "parity config on the card")
    cfg = REFERENCE_PARITY.replace(device=device)
    with no_kernel("REFERENCE_PARITY"):
        res, wall = sync_time(lambda: run_mesh(two_cubes_mesh(), cfg))
    iters = (res.reinit_iters, res.minmax_iters)
    check(iters == (int(g["reinit_iters"]), int(g["minmax_iters"])),
          f"parity iterations {iters}")
    e_smooth = float(np.abs(res.phi_smoothed - g["phi_smoothed"]).max())
    h8 = np.abs(g["phi_init"]) <= 1.5e-6
    d_init = np.abs(res.phi_init - g["phi_init"])
    e_init, off = float(d_init[~h8].max()), int((d_init[h8] > 1e-5).sum())
    dist = np.linalg.norm(g["advected"][:, None, :]
                          - res.advected[None, :, :], axis=-1)
    match = dist.argmin(axis=1)
    e_nodes = float(dist[np.arange(len(match)), match].max())
    check(int(h8.sum()) == 4802 and e_smooth <= 1e-5 and e_init <= 1e-5
          and off <= 14 and len(set(match.tolist())) == len(match)
          and e_nodes <= 1e-6,
          f"parity: phi_smoothed {e_smooth:.3g}, phi_init {e_init:.3g}, "
          f"H8 cells off {off}, nodes {e_nodes:.3g}")
    t = res.timers
    phase("dtypes", f"(a) REFERENCE_PARITY (float64) on {device}, "
          f"{res.grid.shape}: iterations {iters[0]} / {iters[1]} (golden "
          f"13 / 1064), phi_smoothed max err {e_smooth:.3g}, phi_init "
          f"{e_init:.3g} off the H8 cells (atol 1e-5), {off} of 4802 H8 "
          f"cells off (<= 14), nodes {e_nodes:.3g} (1e-6), no kernel "
          f"launched; wall {wall:.2f} s (init {t['search']:.2f}, reinit "
          f"{t['initialization'] - t['search']:.2f}, min/max "
          f"{t['minmax'] - t['initialization']:.2f} s); card {card}")


def dtype_run_b(stl, truth_fn, dtype, tmp, dx=0.01, device="cuda"):
    """Phase 16b: run B's configuration through ``run()`` in ``dtype`` on
    the card, the config parsed from the CLI's ``--dtype``."""
    import torch
    from levelsetfortran_tpu_torch.pipeline.cli import (build_parser,
                                                        config_from_args)
    from levelsetfortran_tpu_torch.pipeline.run import run
    extra = [] if device == "cuda" else ["--device", device]
    cfg = config_from_args(build_parser().parse_args(
        [stl, "--dx", str(dx), "--dtype", dtype, *extra]))
    check(cfg.dtype == getattr(torch, dtype) and cfg.device == device,
          f"--dtype {dtype}")
    out = os.path.join(tmp, f"B_{dtype}_{dx}")
    on_card = device == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    with no_kernel(f"run B {dtype}"):
        res, wall = sync_time(lambda: run(stl, cfg, out_dir=out))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 if on_card else 0.0
    e_sdf = near_surface_errors(
        os.path.join(out, "signedDistanceFunction.vti"), truth_fn)
    e_smooth = near_surface_errors(
        os.path.join(out, "smoothedDistanceFunction.vti"), truth_fn)
    adv = np.abs(truth_fn(res.advected))
    finite = all(np.isfinite(f).all() for f in
                 (res.phi_init, res.phi_smoothed, res.phi_final,
                  res.advected))
    return dict(res=res, wall=wall, peak=peak, e_sdf=float(e_sdf.max()),
                e_smooth=float(np.median(e_smooth)), adv=float(adv.max()),
                finite=finite, cap=cfg.reinit_iters,
                minmax_cap=cfg.minmax_iters)


def run_text(r):
    t = r["res"].timers
    return (f"iterations {r['res'].reinit_iters} / {r['res'].minmax_iters}, "
            f"sdf near-surface max err {r['e_sdf']:.4g}, smoothed median "
            f"{r['e_smooth']:.4g}, advected max |sdf| {r['adv']:.4g}, "
            f"asymptotic_error {r['res'].asymptotic_error:.4g}, wall "
            f"{r['wall']:.1f} s (init {t['search']:.2f}, reinit "
            f"{t['initialization'] - t['search']:.2f}, min/max "
            f"{t['minmax'] - t['initialization']:.2f}, advect "
            f"{t['advect'] - t['minmax']:.2f}, final "
            f"{t['total'] - t['advect']:.2f} s), peak {r['peak']:.2f} GiB")


def dtype_batches(card, device="cuda", dx=0.03):
    """Phase 16e: ``run_batch`` of two icospheres in float64 and in
    bfloat16 (auto: the sequential strategy on the plain versions),
    undivided and in two data-parallel shares, which must agree
    bitwise."""
    import torch
    from levelsetfortran_tpu_torch import LevelSetConfig, run_batch
    from levelsetfortran_tpu_torch.models import analytic
    meshes = [analytic.icosphere_mesh(radius=r, subdivisions=3)
              for r in (0.5, 0.6)]
    notes = []
    for d in (torch.float64, torch.bfloat16):
        cfg = LevelSetConfig(dtype=d, dx=dx, device=device)
        with no_kernel(f"run_batch {d}"):
            items, wall = sync_time(lambda: run_batch(meshes, cfg))
            halves = run_batch(meshes, cfg, data_parallel=2)
        check(all(np.isfinite(f).all() for it in items for f in (
            it.phi_init, it.phi_smoothed, it.advected)),
            f"run_batch {d}: not finite")
        check(all((a.reinit_iters, a.minmax_iters) == (
            b.reinit_iters, b.minmax_iters) and all(
            np.array_equal(getattr(a, f), getattr(b, f))
            for f in ("phi_init", "phi_smoothed", "advected"))
            for a, b in zip(items, halves)),
            f"run_batch {d}: two shares differ from the undivided batch")
        notes.append(f"{str(d).split('.')[-1]} iterations "
                     f"{[(it.reinit_iters, it.minmax_iters) for it in items]}"
                     f" in {wall:.2f} s")
    phase("dtypes", f"(e) run_batch of two icospheres (1,280 triangles) at "
          f"dx {dx}, grid {items[0].grid.shape}: {'; '.join(notes)}; "
          f"data_parallel=2 bitwise the undivided batch; no kernel "
          f"launched; card {card}")


def bf16_card_vs_cpu(card, n=48, dx=0.05, radius=0.6, device="cuda"):
    """Phase 16c: bfloat16 reinit and min/max solves of a 48^3 sphere, the
    card against the CPU: the same iterations and the fields bitwise or
    within one bfloat16 ulp of |phi|."""
    import torch
    from levelsetfortran_tpu_torch.solvers.minmax_flow import minmax_flow
    from levelsetfortran_tpu_torch.solvers.reinit import reinit
    phi = sphere((n,) * 3, dx, radius, device="cpu").to(torch.bfloat16)
    h, h1 = 0.1 * dx, 0.01 * dx * dx
    out = {}
    for dev in (device, "cpu"):
        p = phi.to(dev)
        with no_kernel(f"bfloat16 solves on {dev}"):
            r = reinit(p, dx, h, 200, 1e-5)
            m = minmax_flow(r.phi, dx, h1, 200, 1e-7)
        out[dev] = (r.iterations, m.iterations, r.phi.cpu().float(),
                    m.phi.cpu().float())
    (rg, mg, pg, qg), (rc, mc_, pc, qc) = out[device], out["cpu"]
    notes = []
    for what, a, b in (("reinit", pg, pc), ("min/max", qg, qc)):
        d = (a - b).abs()
        ulp = torch.exp2(torch.floor(torch.log2(
            torch.maximum(a.abs(), b.abs()).clamp_min(2.0 ** -126))) - 7)
        worst = float((d / ulp).max())
        check(worst <= 1.0, f"bfloat16 {what}: card vs CPU {worst} ulps")
        notes.append(f"{what} " + ("bitwise" if worst == 0 else
                                   f"{int((d > 0).sum())} cells off, at "
                                   f"most {worst:g} ulp"))
    check((rg, mg) == (rc, mc_), f"bfloat16 iterations card {(rg, mg)} "
          f"vs CPU {(rc, mc_)}")
    phase("dtypes", f"(c) bfloat16 at {(n,) * 3}, the card against the "
          f"CPU: iterations {rg} / {mg} on both, {', '.join(notes)} (tol "
          f"one bfloat16 ulp of |phi|); no kernel launched")


def f64_gradient_card_vs_cpu(card, device="cuda"):
    """Phase 16d: the float64 pixels -> vertices gradient of the 24^3
    octahedron, the card against the CPU."""
    import torch
    from levelsetfortran_tpu_torch import image_loss_and_vertex_grad
    from levelsetfortran_tpu_torch.grid.grid import Grid3D
    v = 0.7 * np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                        [0, 0, 1], [0, 0, -1]], np.float64)
    f = np.array([[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4],
                  [2, 0, 5], [1, 2, 5], [3, 1, 5], [0, 3, 5]], np.int32)
    n, half = 24, 1.2
    grid = Grid3D(shape=(n, n, n), origin=(-half,) * 3,
                  dx=2 * half / (n - 1))
    kw = dict(eye=(0.0, -3.0, 0.0), target=(0.0, 0.0, 0.0), reinit_steps=5,
              minmax_steps=3, height=12, width=12, n_march_steps=48)
    res = {}
    for dev in (device, "cpu"):
        with no_kernel(f"float64 gradient on {dev}"):
            res[dev] = image_loss_and_vertex_grad(
                torch.tensor(v, device=dev), f, grid,
                torch.zeros((12, 12), dtype=torch.float64, device=dev), **kw)
    (lg, gg), (lc, gc) = res[device], res["cpu"]
    lrel = abs(float(lg) - float(lc)) / abs(float(lc))
    grel = float((gg.cpu() - gc).abs().max() / gc.abs().max())
    check(gg.dtype == torch.float64 and lrel <= 1e-10 and grel <= 1e-10,
          f"float64 gradient: loss rel {lrel:.3g}, grad rel {grel:.3g}")
    phase("dtypes", f"(d) float64 octahedron 24^3 on the card vs the CPU: "
          f"loss {float(lg):.15g} (rel {lrel:.3g}), grad max err "
          f"{grel:.3g} of max |grad| {float(gc.abs().max()):.4g} (rtol "
          f"1e-10); no kernel launched")


def dtypes_phase(card, tmp, ball, ball_sdf, run_b=None, device="cuda",
                 dx=0.01):
    """Phase 16: the dtype routing on the card.  ``run_b``: phase 3's
    float32 run B (its launches and result), printed beside."""
    from levelsetfortran_tpu_torch import write_stl
    parity_on_card(card, device)
    stl = os.path.join(tmp, "B.stl")
    write_stl(stl, ball)
    runs = {d: dtype_run_b(stl, ball_sdf, d, tmp, dx, device)
            for d in ("float64", "bfloat16")}
    r64, r16 = runs["float64"], runs["bfloat16"]
    check(r64["finite"] and not r64["res"].reinit_diverged
          and not r64["res"].minmax_diverged and r64["e_sdf"] < 5e-3
          and r64["e_smooth"] < 6e-3 and r64["adv"] <= 1.5 * dx
          and r64["res"].reinit_iters < r64["cap"],
          f"run B float64 gates: {run_text(r64)}")
    errs = (r16["e_sdf"], r16["e_smooth"], r16["adv"])
    check(r16["finite"] and not r16["res"].reinit_diverged
          and not r16["res"].minmax_diverged
          and r16["res"].reinit_iters < r16["cap"]
          and r16["res"].minmax_iters < r16["minmax_cap"]
          and all(e <= b for e, b in zip(errs, BF16_RUN_B)),
          f"run B bfloat16 gates (bounds {BF16_RUN_B}): {run_text(r16)}")
    for sdx, ref in BF16_JAX.items():
        r = dtype_run_b(stl, ball_sdf, "bfloat16", tmp, sdx, device)
        errs = (r["e_sdf"], r["e_smooth"], r["adv"])
        check(r["finite"] and all(e <= BF16_VS_JAX * j
                                  for e, j in zip(errs, ref)),
              f"bfloat16 at dx {sdx}: {errs} against the JAX package's "
              f"{ref}")
        phase("dtypes", f"(b) run B's mesh in bfloat16 at dx {sdx} "
              f"{r['res'].grid.shape}: {run_text(r)}; the JAX package's "
              f"(sdf, smoothed, advected) {ref}, ratios "
              f"{tuple(round(e / j, 4) for e, j in zip(errs, ref))}; card "
              f"{card}")
    if run_b is not None:
        launches, res = run_b
        phase("dtypes", f"(b) run B float32 (phase 3): iterations "
              f"{res.reinit_iters} / {res.minmax_iters}, launches "
              f"{ {k: v for k, v in launches.items() if v} }")
    for d, r in runs.items():
        phase("dtypes", f"(b) run B {d} {r['res'].grid.shape}: "
              f"{run_text(r)}; no kernel launched; card {card}")
    bf16_card_vs_cpu(card, device=device)
    f64_gradient_card_vs_cpu(card, device)
    dtype_batches(card, device)


#: Phase 17: K7's distances are bitwise its plain version's, so a point's
#: triangle may differ only where two candidates' exact squared distances
#: are within INIT_TIE_ULPS float32 ulps (a tie); the field's magnitudes
#: agree within INIT_TOL, and its signs only where |phi| < INIT_SIGN_BAND
#: (ROADMAP H8: on the surface the tie sum of the pseudonormals is
#: rounding noise, and K7 adds a tile's terms in another order).
INIT_TIE_ULPS = 1
INIT_TOL = 1e-6
INIT_SIGN_BAND = 1e-5
#: Run B's whole init under torch.profiler: at most this many CUDA kernels
#: (907,190 on the plain route in PR 13's records).
INIT_KERNELS = 1000


@contextlib.contextmanager
def plain_selection():
    """The init's selection scan on its plain version over the block, on
    the card (the route a float64 field takes)."""
    from levelsetfortran_tpu_torch.ops import init_sign
    real = init_sign.kernel_supported
    init_sign.kernel_supported = lambda shape, dtype: False
    try:
        yield
    finally:
        init_sign.kernel_supported = real


@contextlib.contextmanager
def k7_calls():
    """Every K7 wrapper call of the block: its arguments and outputs."""
    from levelsetfortran_tpu_torch.ops import init_cuda
    real, calls = init_cuda.select_rows, []

    def spy(*a, **k):
        out = real(*a, **k)
        calls.append((a, k, out))
        return out

    spy.launches = 0        # the wrapper counts on the name it is called by
    init_cuda.select_rows = spy
    try:
        yield calls
    finally:
        init_cuda.select_rows = real


def k7_case(tag, run, vertices=None):
    """Phase 17a, one case: the init ``run()`` on the K7 route, then on the
    plain route.  Every K7 call's argmin is held against the plain version
    on the same inputs (a difference only at a tie of exact distances
    within INIT_TIE_ULPS ulps) and the two fields against each other
    (magnitudes within INIT_TOL, signs apart only under INIT_SIGN_BAND);
    with ``vertices`` (that require grad) the vertex gradients of a seeded
    random linear loss too, at run D's gate.  Returns the record's
    numbers."""
    import torch
    from levelsetfortran_tpu_torch.ops import init_cuda
    from levelsetfortran_tpu_torch.ops.init_sign import _exact_d2
    with k7_calls() as calls:
        phi_k, t_k = sync_time(run)
    with plain_selection():
        phi_p, t_p = sync_time(run)
    check(len(calls) == 1, f"K7 {tag}: {len(calls)} K7 calls")
    a, kw, (best, _) = calls[0]
    pts, _, tri_s, _, rows = a
    P = pts.shape[1]
    index = kw.get("index") or init_cuda.row_index(rows, pts.device)
    (bp, _), t_plain = sync_time(lambda: init_cuda.select_rows_plain(
        *a, **{k: v for k, v in kw.items() if k != "index"}))
    ms = median_ms(lambda: init_cuda.select_rows(*a, **kw), 3)
    d = best != bp
    diff = int(d.sum())
    worst = 0.0
    if diff:
        dk, dp = (_exact_d2(pts[d][None], tri_s[init_cuda.triangle_ids(
            index, b)[d]][None])[0].cpu().numpy()
            for b in (best, bp))
        ulp = np.spacing(np.maximum(dk, dp).astype(np.float32))
        worst = float((np.abs(dk - dp) / ulp).max())
    pairs = rows.pairs_per_point * P
    nbytes = 4 * (pts.numel() + 2 * best.numel() + tri_s.numel()
                  + a[3].numel()
                  + (0 if rows.flat is None else len(rows.flat)))
    b = bound(nbytes, pairs * OPS["init_pair"])
    x, y = phi_k.detach().double(), phi_p.detach().double()
    flip = torch.sign(x) != torch.sign(y)
    same = float((x - y)[~flip].abs().max())
    mag = float((x.abs() - y.abs()).abs().max())
    n_flip = int(flip.sum())
    flip_max = (float(torch.maximum(x.abs(), y.abs())[flip].max())
                if n_flip else 0.0)
    text = ""
    if vertices is not None:
        g = torch.Generator(device=phi_k.device).manual_seed(17)
        cot = torch.randn(phi_k.shape, generator=g, device=phi_k.device)
        gk, gp = (torch.autograd.grad((f * cot).sum(), vertices)[0]
                  for f in (phi_k, phi_p))
        gmax, gerr = float(gk.abs().max()), err(gk, gp)
        text = (f"; vertex gradient of a seeded linear loss max err "
                f"{gerr:.3g} of max|grad| {gmax:.4g} (gate 1e-4 of it)")
        check(gerr <= 1e-4 * gmax, f"K7 {tag}: vertex gradient {gerr}")
    phase("K7", f"{tag}: {rows.counts.size} rows of {P} points, {pairs} "
          f"(point, candidate) pairs; best_i differs at {diff} of "
          f"{best.numel()} points ({diff / best.numel():.3g}), the exact "
          f"d2 of the two choices within {worst:.3g} ulps; max |dphi| "
          f"{same:.3g} where the signs agree, ||phi|| {mag:.3g} (gate "
          f"{INIT_TOL:g}), {n_flip} sign(s) apart, at |phi| <= "
          f"{flip_max:.3g} (gate {INIT_SIGN_BAND:g}){text}; K7 {ms:.3f} ms "
          f"(events) vs the plain version {t_plain * 1e3:.1f} ms, bound "
          f"{b['bound_ms']:.4g} ms ({b['bound_by']}); the init "
          f"{t_k:.3f} s vs {t_p:.3f} s on the plain route; card {CARD}")
    check(worst <= INIT_TIE_ULPS, f"K7 {tag}: a triangle chosen apart from "
          f"the plain version's {worst} ulps away")
    check(same <= INIT_TOL and mag <= INIT_TOL, f"K7 {tag}: phi {same} / "
          f"{mag}")
    check(flip_max < INIT_SIGN_BAND, f"K7 {tag}: a sign apart at |phi| "
          f"{flip_max}")
    return {"max_abs_err": max(same, mag), "ms": ms,
            "plain_ms": t_plain * 1e3, **b}


def cuda_kernels_of(fn, reps=3):
    """``fn()``'s CUDA kernels under torch.profiler: (kernels, copies and
    fills, names of the kernels); a trace that lost its device activity
    (no kernel of csrc/ in it) is taken again."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(reps):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        kern = [n for n in names if not n.startswith(("Memcpy", "Memset"))]
        if any("init_select" in n for n in kern):
            return len(kern), len(names) - len(kern), kern
    raise AssertionError(f"no trace of K7 in {reps} profiles")


def k8_case(tag, phi_np, grid, vertices, iters, advected=None,
            device="cuda"):
    """Phase 17b, one case: K8 on a run's smoothed field and its mesh's
    nodes against the plain loop on the card, bitwise (and against the
    run's own advected nodes), timed beside the loop and the bound."""
    import torch
    from levelsetfortran_tpu_torch import LevelSetConfig
    from levelsetfortran_tpu_torch.ops import advect_cuda
    from levelsetfortran_tpu_torch.solvers.advect import banded_gradient
    cfg = LevelSetConfig(dx=grid.dx)
    phi = torch.tensor(phi_np, dtype=torch.float32, device=device)
    grad = banded_gradient(phi, grid.dx, order=cfg.advect_grad_order,
                           stencil_radius=cfg.stencil_band_radius,
                           quirk_deriv8_y=cfg.quirks.deriv8_y_jp1)
    x0 = torch.tensor(vertices, dtype=torch.float32, device=device)
    args = (phi, grad, grid, x0, iters, cfg.advect_eps)
    (xk, pk), _ = sync_time(lambda: advect_cuda.advect(*args))
    (xp, pp), t_plain = sync_time(lambda: advect_cuda.advect_plain(*args))
    ms = median_ms(lambda: advect_cuda.advect(*args), 5)
    same = bitwise(xk, xp) and bitwise(pk, pp)
    own = advected is None or np.array_equal(xk.double().cpu().numpy(),
                                             advected)
    # the data this run needs: the nodes in and out, phi_surf, and the 8
    # corners (phi and its gradient) of the cells of the first and last
    # positions
    shape = torch.tensor(grid.shape, device=device)
    corners = []
    for x in (x0, xk):
        f = grid.world_to_index(x).clamp_min(0.0)
        i = torch.minimum(torch.floor(f).long(), shape - 2).clamp_min(0)
        for o in np.ndindex(2, 2, 2):
            c = i + torch.tensor(o, device=device)
            corners.append((c[:, 0] * shape[1] + c[:, 1]) * shape[2]
                           + c[:, 2])
    cells = int(torch.unique(torch.cat(corners)).numel())
    n = x0.shape[0]
    b = bound(16 * cells + 28 * n, OPS["advect_iter"] * n * (iters + 1))
    phase("K8", f"{tag}: {n} nodes, {iters} iterations on {grid.shape}: "
          f"positions and phi_surf bitwise the plain loop's {same}, the "
          f"run's own advected nodes {own}; K8 {ms:.3f} ms (events) vs the "
          f"plain loop {t_plain * 1e3:.1f} ms, bound {b['bound_ms']:.4g} ms "
          f"({b['bound_by']}, {cells} cells' corners); card {CARD}")
    check(same, f"K8 {tag}: not bitwise the plain loop "
          f"({err(xk, xp):.3g}, {err(pk, pp):.3g})")
    check(own, f"K8 {tag}: differs from the run's advected nodes")
    return {"max_abs_err": max(err(xk, xp), err(pk, pp)), "ms": ms,
            "plain_ms": t_plain * 1e3, **b}


#: Phase 17c: a (block, triangle) pair K10 and the host build keep apart
#: lies at most this many float32 ulps of the quadratic form from its
#: threshold (``cull_cuda.margin_ulps``; the host's BLAS rounds the
#: three-term dot another way than K10's fixed order).
CULL_NEAR_ULPS = 4
#: The benchmark's run cell: the icosphere at this spacing, pad 10, 256^3.
RUN_CELL_DX = 0.00855


def k10_case(tag, grid, mesh, device="cuda"):
    """Phase 17c, one case: K10 on ``mesh`` over ``grid`` against its plain
    version on the card (bitwise) and against the host build (each pair
    apart within CULL_NEAR_ULPS of its threshold), timed beside both and
    the bound; then the init's field through K10 (``culling="auto"`` on
    the card) bitwise the field on the host-built culling.  Returns the
    record's numbers."""
    import torch
    from levelsetfortran_tpu_torch.ops import cull_cuda, init_cuda
    from levelsetfortran_tpu_torch.ops.init_sign import (build_init_culling,
                                                          signed_distance_init)
    frame = cull_cuda.cull_frame(grid, mesh.vertices, mesh.elements)
    rows, _ = sync_time(lambda: cull_cuda.cull_rows(frame, device))
    plain, t_plain = sync_time(
        lambda: cull_cuda.cull_rows_plain(frame, device))
    same = all(np.array_equal(getattr(rows, n), getattr(plain, n))
               for n in ("bidx", "counts", "offsets")) and torch.equal(
        rows.flat, plain.flat)

    def host():
        c = build_init_culling(grid, mesh.vertices, mesh.elements)
        return c, init_cuda.pack_rows(c.cands, c.bidxs, mesh.n_elems)

    (cull, hrows), t_host = sync_time(host)
    mine = rows.flat.cpu().numpy()
    lists = [{int(b): f[o:o + n] for b, o, n in zip(r.bidx, r.offsets,
                                                    r.counts)}
             for r, f in ((hrows, hrows.flat), (rows, mine))]
    apart = [cull_cuda.margin_ulps(frame, b, int(t), device)
             for b in lists[0]
             for t in np.setxor1d(lists[0][b], lists[1][b])]
    ms = median_ms(lambda: cull_cuda.cull_rows(frame, device), 10)
    walls = sorted(sync_time(lambda: cull_cuda.cull_rows(cull_cuda.cull_frame(
        grid, mesh.vertices, mesh.elements), device))[1] for _ in range(5))
    B, Bc, E = len(frame.centers), len(frame.pcen), len(frame.tri)
    on = cull_cuda._on(frame, device)
    dr, th = cull_cuda._keep(on, frame, on.pcen, on.pc_sq, frame.pcen_abs,
                             None, frame.R_p)
    survivors = (dr <= th[:, None]).sum(dim=1).cpu().numpy()
    pairs = Bc * E + int(survivors[frame.parent_of].sum())
    nbytes = (4 * (4 * B + 4 * Bc + 5 * E) + 8 * (3 * B + 3 * Bc + 9 * E)
              + 4 * (len(mine) + B))
    b = bound(nbytes, pairs * OPS["cull_pair"])
    phi_k = signed_distance_init(grid, mesh.vertices, mesh.elements,
                                 device=device)
    phi_h = signed_distance_init(grid, mesh.vertices, mesh.elements,
                                 device=device, culling=cull)
    field = torch.equal(phi_k, phi_h)
    gap = float((phi_k.double() - phi_h.double()).abs().max())
    phase("K10", f"{tag}: {B} blocks, {Bc} parents, {E} triangles, {pairs} "
          f"(row, triangle) pairs tested, {len(mine)} survivors; rows "
          f"bitwise the plain version's {same}; {len(apart)} pair(s) apart "
          f"from the host build's (pairs a point {rows.pairs_per_point} vs "
          f"{hrows.pairs_per_point}), at "
          f"{[round(u, 2) for u in sorted(apart)][:8]} ulps of the "
          f"quadratic form from their thresholds (gate {CULL_NEAR_ULPS}); "
          f"the init's field bitwise the "
          f"host-culled one {field}; K10 {ms:.3f} ms (events, with its host "
          f"read), the whole build with the host's "
          f"constants {walls[2] * 1e3:.2f} ms (median of 5) vs the host "
          f"build {t_host * 1e3:.1f} ms and the plain version "
          f"{t_plain * 1e3:.1f} ms, bound {b['bound_ms']:.4g} ms "
          f"({b['bound_by']}); card {CARD}")
    check(same, f"K10 {tag}: rows differ from the plain version's")
    check(all(u <= CULL_NEAR_ULPS for u in apart), f"K10 {tag}: a pair "
          f"apart from the host build {max(apart, default=0.0)} ulps from its "
          f"threshold")
    check(field, f"K10 {tag}: the init's field differs from the "
          f"host-culled one by {gap}")
    return {"max_abs_err": gap, "ms": ms, "plain_ms": t_plain * 1e3, **b}


def init_kernels_phase(card, record, ball, cubes, runs, items_e,
                       device="cuda", n_d=256, iters_b=1000,
                       iters_e=RUN_E_ADVECT_ITERS):
    """Phase 17: K7, K8 and K10 against their plain versions on the card.
    ``runs``: phase 3's results (A, B; run B advected ``iters_b`` times);
    ``items_e``: run E's geometries (smoothed field, grid, nodes, advected
    nodes; ``iters_e`` times); run D's grid is ``n_d``^3."""
    import torch
    from levelsetfortran_tpu_torch.grid.grid import Grid3D, from_surface
    from levelsetfortran_tpu_torch.ops.init_sign import (build_init_culling,
                                                          signed_distance_init)
    res_b, res_a = runs["B"], runs["A"]
    gb = res_b.grid

    def init_b():
        return signed_distance_init(gb, ball.vertices, ball.elements,
                                    device=device)

    rec = k7_case(f"run B {gb.shape} culled", init_b)
    if device == "cuda":
        n_kern, n_copy, names = cuda_kernels_of(init_b)
        top = sorted(set(names), key=names.count, reverse=True)[:4]
        phase("K7", f"run B's whole init under torch.profiler: {n_kern} "
              f"CUDA kernels (gate {INIT_KERNELS}) and {n_copy} copies / "
              f"fills; the most launched "
              f"{[(n[:40], names.count(n)) for n in top]}; card {card}")
        check(n_kern < INIT_KERNELS,
              f"run B's init launched {n_kern} kernels")
    errs = [rec["max_abs_err"]]
    ga = res_a.grid
    errs.append(k7_case(f"dense, run A's grid {ga.shape}", lambda: (
        signed_distance_init(ga, cubes.vertices, cubes.elements,
                             device=device, culling=None)))["max_abs_err"])
    blk = (gb.shape[0] // 2, gb.shape[1] // 2, gb.shape[2])
    off = (blk[0], 0, 0)
    sub = Grid3D(shape=blk, origin=tuple(
        o + i * gb.dx for o, i in zip(gb.origin, off)), dx=gb.dx)
    errs.append(k7_case(f"block (1, 0, 0) {blk} of run B's (2,2,1) mesh",
                        lambda: signed_distance_init(
                            sub, ball.vertices, ball.elements, device=device,
                            block_of=(gb, off)))["max_abs_err"])
    gd = cube_grid(ball.vertices, n_d)
    cull = build_init_culling(gd, ball.vertices, ball.elements)
    vv = torch.tensor(ball.vertices, dtype=torch.float32,
                      device=device).requires_grad_(True)
    errs.append(k7_case(f"run D {gd.shape}, vertices that require grad",
                        lambda: signed_distance_init(
                            gd, vv, ball.elements, device=device,
                            culling=cull), vertices=vv)["max_abs_err"])
    record["select_rows"].update(rec, max_abs_err=max(errs))
    if device == "cuda":
        torch.cuda.empty_cache()

    rec = k8_case(f"run B {gb.shape}", res_b.phi_smoothed, gb,
                  ball.vertices, iters_b, res_b.advected,
                  device=device)
    errs = [rec["max_abs_err"]]
    for i, (phi, grid, nodes, adv) in enumerate(items_e):
        errs.append(k8_case(f"run E geometry {i}", phi, grid, nodes,
                            iters_e, adv,
                            device=device)["max_abs_err"])
    record["advect"].update(rec, max_abs_err=max(errs))

    rec = k10_case(f"run B {gb.shape}", gb, ball, device=device)
    gr = from_surface(ball.vertices, RUN_CELL_DX, 10)
    errs = [rec["max_abs_err"],
            k10_case(f"run cell {gr.shape}", gr, ball,
                     device=device)["max_abs_err"]]
    record["cull_rows"].update(rec, max_abs_err=max(errs))


#: Phase 18: the sharded cell's spacing (``icosphere5_512``: the icosphere
#: of radius 1 on 512^3 at (2, 2, 1)) and its advection iterations.
SHARDED_CELL_DX = 0.004085
SHARDED_ITERS = 1000


def rank_advect(spec, devices):
    """One rank of phase 18: ``spec``'s field cut on its mesh across the
    ranks, the sharded advection of its nodes (K8's block mode, one
    sample launch per shard and iteration, the ranks' sums all-reduced):
    the digests of the positions and of phi_surf, the launches, the
    wall."""
    import torch
    from levelsetfortran_tpu_torch.grid.grid import Grid3D
    from levelsetfortran_tpu_torch.ops import advect_cuda as ac
    from levelsetfortran_tpu_torch.parallel import sharded as sh
    from levelsetfortran_tpu_torch.parallel.mesh import (make_mesh,
                                                         split_blocks)
    phi, nodes = torch.load(spec["field"]), torch.load(spec["nodes"])
    grid = Grid3D(shape=tuple(phi.shape), origin=tuple(spec["origin"]),
                  dx=spec["dx"])
    mesh = make_mesh(tuple(spec["mesh"]), devices)
    blocks = split_blocks(mesh, phi)
    home = next(b.device for b in blocks if b is not None)
    ac.sample_block.launches = 0
    res, wall = rank_timed(lambda: sh.advect_nodes_sharded(
        mesh, blocks, grid, nodes.to(home), grid.dx, spec["iters"]))
    return {"positions": digest(res.positions),
            "phi_surf": digest(res.phi_surf),
            "launches": {"sample_block": ac.sample_block.launches},
            "wall": wall}


def k8_block_case(tag, mesh, phi, grid, nodes, iters, card, solo=None):
    """Phase 18, one case: ``phi`` cut on ``mesh`` and its nodes advected,
    K8's block mode (``advect_blocks`` in rounds) against the plain loop
    on the same blocks (the route forced), and each shard's sample
    (``sample_block``) against its plain version, bitwise; ``solo``: the
    solo K8's positions and phi_surf, compared by value (the sharded sum
    turns a -0.0 into +0.0).  Timed: the whole stage (the fields and the
    rounds), the rounds alone and the plain loop, host clock with every
    card synchronised."""
    import torch
    from levelsetfortran_tpu_torch.ops import advect_cuda as ac
    from levelsetfortran_tpu_torch.parallel import sharded as sh
    from levelsetfortran_tpu_torch.parallel.mesh import split_blocks
    blocks = split_blocks(mesh, phi)
    home = blocks[0].device
    x0 = torch.as_tensor(nodes, dtype=torch.float32, device=home)
    fields, specs = sh.advection_fields(mesh, blocks, grid.dx)
    samples = all(bitwise(ac.sample_block(f, sp, grid, x0),
                          ac.sample_block_plain(f, sp, grid, x0))
                  for f, sp in zip(fields, specs))

    def stage():
        return sh.advect_nodes_sharded(mesh, blocks, grid, x0, grid.dx,
                                       iters)

    ac.run_blocks.launches, r0 = 0, ac.rounds
    res, _ = sync_time(stage)
    launches, rounds = ac.run_blocks.launches, ac.rounds - r0
    real = ac.takes_kernel
    ac.takes_kernel = lambda f: False
    try:
        plain, t_plain = sync_time(stage)
    finally:
        ac.takes_kernel = real
    same = (bitwise(res.positions, plain.positions)
            and bitwise(res.phi_surf, plain.phi_surf))
    t_stage = float(np.median([sync_time(stage)[1] for _ in range(3)]))
    t_rounds = float(np.median([sync_time(lambda: ac.advect_blocks(
        fields, specs, grid, x0, iters, 1e-13,
        zero_sign=mesh.n_shards > 1))[1] for _ in range(3)]))
    as_solo = solo is None or (
        torch.equal(res.positions, solo[0].to(home))
        and torch.equal(res.phi_surf, solo[1].to(home)))
    n = x0.shape[0]
    b = bound(28 * n, OPS["advect_iter"] * n * (iters + 1))
    devs = sorted({str(f.device) for f in fields})
    phase("K8 block", f"{tag}: blocks on {devs}, {n} nodes, {iters} "
          f"iterations on {grid.shape}: every shard's sample bitwise its "
          f"plain version {samples}, positions and phi_surf bitwise the "
          f"plain loop's {same}"
          + ("" if solo is None else f", equal to the solo K8's {as_solo}")
          + f"; {launches} launches in {rounds} round(s); the stage "
          f"{t_stage * 1e3:.2f} ms (the rounds {t_rounds * 1e3:.3f} ms) vs "
          f"the plain loop {t_plain * 1e3:.1f} ms, bound "
          f"{b['bound_ms']:.4g} ms ({b['bound_by']}); card {card}")
    check(samples, f"K8 block {tag}: a shard's sample is not bitwise its "
          f"plain version")
    check(same, f"K8 block {tag}: not bitwise the plain loop "
          f"({err(res.positions, plain.positions):.3g}, "
          f"{err(res.phi_surf, plain.phi_surf):.3g})")
    return {"max_abs_err": max(err(res.positions, plain.positions),
                               err(res.phi_surf, plain.phi_surf)),
            "ms": t_rounds * 1e3, "plain_ms": t_plain * 1e3,
            "stage_ms": t_stage * 1e3, "res": res, **b}


def k8_block_phase(card, record, tmp, ball, device="cuda", dx_b=0.01,
                   dx_cell=SHARDED_CELL_DX, iters=SHARDED_ITERS):
    """Phase 18: K8's block mode, the sharded advection on the card.
    Run B's smoothed field (``dx_b``) through the solo K8 (phase 17's
    case: its time beside PERF.md's), then cut (2, 2, 1): all four blocks
    on one card (the mesh's round-robin) and one block per visible card,
    each against the plain loop and the solo K8; then the sphere's
    distance on the sharded cell's grid (``dx_cell``, 512^3) cut the same
    two ways; then the same advection on two or more ranks (one per card,
    NCCL; two on one card over gloo) against this process, bitwise."""
    import torch
    from levelsetfortran_tpu_torch import LevelSetConfig, run_mesh
    from levelsetfortran_tpu_torch.grid.grid import from_surface
    from levelsetfortran_tpu_torch.ops import advect_cuda as ac
    from levelsetfortran_tpu_torch.parallel import sharded as sh
    from levelsetfortran_tpu_torch.parallel.mesh import (make_mesh,
                                                         split_blocks)
    from levelsetfortran_tpu_torch.solvers.advect import advect_nodes
    res_b = run_mesh(ball, LevelSetConfig(dx=dx_b, device=device,
                                          advect_iters=iters))
    gb = res_b.grid
    solo_rec = k8_case(f"run B {gb.shape} (solo)", res_b.phi_smoothed, gb,
                       ball.vertices, iters, res_b.advected, device=device)
    phi_b = torch.tensor(res_b.phi_smoothed, dtype=torch.float32)
    solo = advect_nodes(phi_b.to(device), gb, torch.tensor(
        ball.vertices, dtype=torch.float32, device=device), gb.dx, iters)
    del res_b
    if device == "cuda":
        cards = [torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())]
    else:
        cards = [torch.device(device)]
    placements = [("one card", cards[:1])]
    if len(cards) > 1:
        placements.append(("a card each", cards))
    recs = [k8_block_case(f"run B on (2, 2, 1), {where}",
                          make_mesh((2, 2, 1), devs), phi_b, gb,
                          ball.vertices, iters, card, solo)
            for where, devs in placements]
    gc = from_surface(ball.vertices, dx_cell, 10, (2, 2, 1))
    axes = [torch.tensor(o + gc.dx * np.arange(n), dtype=torch.float32,
                         device=cards[0])
            for o, n in zip(gc.origin, gc.shape)]
    phi_c = torch.sqrt(axes[0][:, None, None] ** 2
                       + axes[1][None, :, None] ** 2
                       + axes[2][None, None, :] ** 2) - 1.0
    del axes
    for where, devs in placements:
        recs.append(k8_block_case(f"{gc.shape} on (2, 2, 1), {where}",
                                  make_mesh((2, 2, 1), devs), phi_c, gc,
                                  ball.vertices, iters, card))
    # one shard's sample alone at the cell's size, on one card
    mesh = make_mesh((2, 2, 1), cards[:1])
    fields, specs = sh.advection_fields(mesh, split_blocks(mesh, phi_c),
                                        gc.dx)
    del phi_c
    x0 = torch.tensor(ball.vertices, dtype=torch.float32, device=cards[0])
    f, sp = fields[0], specs[0]
    t_plain = sync_time(lambda: ac.sample_block_plain(f, sp, gc, x0))[1]
    ms = (median_ms(lambda: ac.sample_block(f, sp, gc, x0), 20)
          if device == "cuda" else t_plain * 1e3)
    n = x0.shape[0]
    sb = bound(16 * n + 12 * n, OPS["advect_iter"] * n)
    phase("K8 block", f"one shard's sample at {gc.shape}: {ms:.4f} ms "
          f"(events) vs its plain version {t_plain * 1e3:.2f} ms, bound "
          f"{sb['bound_ms']:.4g} ms; card {card}")
    del fields, f
    if device == "cuda":
        torch.cuda.empty_cache()

    # across processes, against this process on the same placement
    world = max(2, len(cards)) if device == "cuda" else 2
    backend = rank_backend(world, device)
    field = os.path.join(tmp, "K8B_field.pt")
    nodes = os.path.join(tmp, "K8B_nodes.pt")
    torch.save(phi_b, field)
    torch.save(torch.tensor(ball.vertices, dtype=torch.float32), nodes)
    spec = {"kind": "advect", "device": device, "field": field,
            "nodes": nodes, "origin": list(gb.origin), "dx": gb.dx,
            "mesh": [2, 2, 1], "iters": iters}
    ranks = run_ranks(spec, world, backend, tmp, "K8B")
    one = recs[len(placements) - 1]["res"]   # run B's, a card each
    for r in ranks:
        check(r["positions"] == digest(one.positions)
              and r["phi_surf"] == digest(one.phi_surf),
              f"K8 block ranks: rank {r['rank']}'s advected nodes differ "
              f"from one process's")
        check(device != "cuda" or r["launches"]["sample_block"] > 0,
              f"K8 block ranks: rank {r['rank']} launched no sample")
    phase("K8 block", f"run B on (2, 2, 1) across {world} ranks "
          f"{[r['device'] for r in ranks]} over {backend}: every rank's "
          f"positions and phi_surf bitwise one process's; sample launches "
          f"per rank {[r['launches']['sample_block'] for r in ranks]}, "
          f"walls {[round(r['wall'], 3) for r in ranks]} s; card {card}")
    cell = recs[-1]
    record["run_blocks"].update(
        {k: cell[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
        max_abs_err=max(r["max_abs_err"] for r in recs),
        solo_ms=solo_rec["ms"])
    record["sample_block"].update(ms=ms, plain_ms=t_plain * 1e3,
                                  max_abs_err=0.0, bound_ms=sb["bound_ms"],
                                  bound_by=sb["bound_by"])
    return recs



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
        "minmax_fusedk_block": (csrc + "minmax_step.cu",
                                mm + "647 (offsets)"),
        # no pallas_call: the jitted init's scan and the jitted advection
        "select_rows": (csrc + "init_select.cu",
                        "levelsetfortran_tpu/ops/init_sign.py:207 "
                        "(nearest_sign_scan in the jitted _culled_init :660 "
                        "and _dense_signed_distance_init :785; no Pallas)"),
        "advect": (csrc + "advect.cu",
                   "levelsetfortran_tpu/solvers/advect.py:46 (the jitted "
                   "advect_nodes; no Pallas)"),
        # the sharded advection: no pallas_call (a jnp loop under
        # shard_map with a psum per iteration)
        "run_blocks": (csrc + "advect.cu",
                       "levelsetfortran_tpu/parallel/sharded.py "
                       "advect_nodes_sharded (block mode, in rounds; no "
                       "Pallas)"),
        "sample_block": (csrc + "advect.cu",
                         "levelsetfortran_tpu/parallel/sharded.py "
                         "advect_nodes_sharded (block mode, one shard's "
                         "sample; no Pallas)"),
        # no kernel at all: the host's numpy culling build
        "cull_rows": (csrc + "init_cull.cu",
                      "levelsetfortran_tpu/ops/init_sign.py:495-657 "
                      "(build_init_culling, host numpy; no Pallas)"),
    }
    return names


def main() -> int:
    import torch
    if sys.argv[1:2] == ["--rank"]:
        return rank_main(sys.argv[1:])
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
            if label == "B":
                runs_b = launches
        run_a_fused(results["A"], cubes)
        launches, run_f = run_f_phase(ball, ball_sdf, results["B"], card,
                                      tmp)
        count(launches)
        several = {}
        launches, several["run L"] = sync_time(
            lambda: run_l_phase(card, tmp, run_f))
        count(launches)
        del run_f
        launches, items_e, walls_e = run_e_phase(card, tmp)
        count(launches)
        launches, wall_k = sync_time(
            lambda: run_k_phase(card, tmp, (items_e, walls_e)))
        count(launches)
        kept_e = [(it.phi_smoothed, it.grid, it.mesh.vertices, it.advected)
                  for it in items_e]
        del items_e
        walls = {}
        launches, walls["run H"] = sync_time(
            lambda: run_h_phase(cubes, results["C"], card, tmp))
        count(launches)
        _, walls["run H 222^3"] = sync_time(
            lambda: run_h_full_phase(card, tmp))
        launches, walls["run I"] = sync_time(
            lambda: run_i_phase(ball, ball_sdf, results["B"], card, tmp))
        count(launches)
        _, walls["profiling"] = sync_time(lambda: throughput_line(card))
        phase("operations", "walls " + ", ".join(
            f"{k} {v:.1f} s" for k, v in walls.items())
            + f", together {sum(walls.values()):.1f} s; card {card}")
    launches, run_d = run_d_phase(ball, card, record)
    count(launches)
    launches, run_g = run_g_phase(ball, card, run_d)
    count(launches)
    del run_d
    with tempfile.TemporaryDirectory() as tmp:
        launches, several["run G-ranks"] = sync_time(
            lambda: run_g_ranks_phase(card, tmp, run_g))
        count(launches)
    del run_g
    count(banded_solves_phase(card))
    with tempfile.TemporaryDirectory() as tmp:
        launches, wall_j = sync_time(lambda: run_j_phase(card, tmp))
        count(launches)
    launches, wall_dry = sync_time(lambda: dryrun_phase(card))
    count(launches)
    several.update({"run K": wall_k, "run J": wall_j, "dryrun": wall_dry})
    phase("several", "walls " + ", ".join(
        f"{k} {v:.1f} s" for k, v in several.items())
        + f", together {sum(several.values()):.1f} s; card {card}")
    small_holds()
    with tempfile.TemporaryDirectory() as tmp:
        launches, wall_opt = sync_time(
            lambda: options_phase(card, record, tmp))
        count(launches)
    phase("options", f"wall {wall_opt:.1f} s; card {card}")
    with tempfile.TemporaryDirectory() as tmp:
        _, wall_dt = sync_time(lambda: dtypes_phase(
            card, tmp, ball, ball_sdf, (runs_b, results["B"])))
    phase("dtypes", f"wall {wall_dt:.1f} s; card {card}")
    _, wall_17 = sync_time(lambda: init_kernels_phase(
        card, record, ball, cubes, results, kept_e))
    phase("init kernels", f"wall {wall_17:.1f} s; card {card}")
    with tempfile.TemporaryDirectory() as tmp:
        _, wall_18 = sync_time(lambda: k8_block_phase(card, record, tmp,
                                                      ball))
    phase("K8 block", f"wall {wall_18:.1f} s; card {card}")

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
