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
     with a real mask; K4 also against 4 launches of K3, bitwise; median
     times from CUDA events;
  3. runs A (twoCube10 twin, dx 0.05, 262x42x42), B (icosphere with 20,480
     triangles, dx 0.01, 222^3) and C (A with --narrow-band off), each
     through ``python -m levelsetfortran_tpu_torch`` and in-process
     through ``run()`` with the launch counters read around it; outputs
     checked against the analytic SDFs.
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

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SHAPES = ((67, 45, 39), (222, 222, 222))
MAIN_SHAPE = SHAPES[1]


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


def err(a, b):
    return float((a.double() - b.double()).abs().max())


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
        rec = record["reinit_step"]
        rec["max_abs_err"] = max(rec["max_abs_err"], e1)
        if main:
            rec["ms"] = median_ms(lambda: wc.reinit_step(
                phi, phi, dx, h, with_rms=True), 20)
            rec["plain_ms"] = median_ms(lambda: wc.reinit_step_plain(
                phi, phi, dx, h, with_rms=True), 5)
            rec["banded_ms"] = median_ms(lambda: wc.reinit_step(
                phi, phi, dx, h, active=act_r, with_rms=True), 20)
        phase("kernels", f"K1 {shape}: max_abs_err {e1:.3g} (tol 1e-6), "
              f"dsq rel {rel:.3g} (tol 1e-5), active bricks "
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
        rec = record["minmax_step"]
        rec["max_abs_err"] = max(rec["max_abs_err"], e3)
        if main:
            rec["ms"] = median_ms(lambda: mc.minmax_step(
                phi, dx, h1, with_rms=True), 20)
            rec["plain_ms"] = median_ms(lambda: mc.minmax_step_plain(
                phi, dx, h1, with_rms=True), 10)
            rec["banded_ms"] = median_ms(lambda: mc.minmax_step(
                phi, dx, h1, active=act_m, with_rms=True), 20)
        phase("kernels", f"K3 {shape}: max_abs_err {e3:.3g} (tol 1e-7), "
              f"dsq rel {rel3:.3g}, active bricks "
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
        phase("kernels", f"K4 {shape}: bitwise equal to 4 K3 launches, "
              f"max_abs_err vs plain {e4:.3g} (tol 1e-7)")
        del phi, k, p, kb, pb, kc
        torch.cuda.empty_cache()
    for name, rec in record.items():
        phase("kernels", f"{name} at {MAIN_SHAPE}: kernel {rec['ms']:.4f} ms"
              f" (banded {rec['banded_ms']:.4f} ms), plain "
              f"{rec['plain_ms']:.4f} ms")


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
    counters = (wc.reinit_step, mc.minmax_step, mc.minmax_fusedk)
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
    check(e_sdf.max() < 5e-3, f"run {label}: sdf error {e_sdf.max()}")
    # min/max flow rounds corners, so the smoothed field is gated by its
    # median; the JAX package's own pipeline measures 5.01e-3 on mesh A
    # (CPU, float32), hence 6e-3 rather than the nominal ~5e-3
    check(np.median(e_smooth) < 6e-3, f"run {label}: smoothed median error")
    check(adv.max() <= 1.5 * dx, f"run {label}: advected |sdf| {adv.max()}")
    check(res.reinit_iters < cfg.reinit_iters, f"run {label}: reinit cap")
    check(finite and not res.reinit_diverged and not res.minmax_diverged,
          f"run {label}: diverged or non-finite")
    if "off" in extra_args:
        want = ("reinit_step", "minmax_step")
    else:
        want = ("reinit_step", "minmax_fusedk")
    for name in want:
        check(launches[name] > 0, f"run {label}: {name} never launched")
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else \
        "nvidia-smi unavailable"
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    phase("device", f"{torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}; TF32 on")

    from levelsetfortran_tpu_torch import cuda_build
    from levelsetfortran_tpu_torch.models import analytic
    t0 = time.perf_counter()
    cuda_build.library()
    phase("build", f"{time.perf_counter() - t0:.1f} s "
          f"({', '.join(s.name for s in cuda_build.sources())})")

    names = {
        "reinit_step": ("levelsetfortran_tpu_torch/csrc/reinit_step.cu",
                        "levelsetfortran_tpu/ops/weno_pallas.py:1938"),
        "minmax_step": ("levelsetfortran_tpu_torch/csrc/minmax_step.cu",
                        "levelsetfortran_tpu/ops/minmax_pallas.py:309"),
        "minmax_fusedk": ("levelsetfortran_tpu_torch/csrc/minmax_step.cu",
                          "levelsetfortran_tpu/ops/minmax_pallas.py:647"),
    }
    record = {n: {"max_abs_err": 0.0} for n in names}
    kernel_phase(record)

    cubes = analytic.two_cubes_mesh()
    ball = analytic.icosphere_mesh(subdivisions=5)
    check(ball.n_elems == 20480, "icosphere triangles")

    def cubes_sdf(p):
        return analytic.sdf_two_cubes(p, spacing=10.0, size=1.0)

    def ball_sdf(p):
        return analytic.sdf_sphere(p, (0.0, 0.0, 0.0), 1.0)

    total = {n: 0 for n in names}
    with tempfile.TemporaryDirectory() as tmp:
        for label, mesh, truth, dx, extra in (
                ("A", cubes, cubes_sdf, 0.05, []),
                ("B", ball, ball_sdf, 0.01, []),
                ("C", cubes, cubes_sdf, 0.05, ["--narrow-band", "off"])):
            for n, v in run_phase(label, mesh, truth, dx, extra,
                                  tmp).items():
                total[n] += v

    kernels = []
    for n, (src, repl) in names.items():
        r = record[n]
        kernels.append({"name": n, "route": "cuda", "source": src,
                        "replaces": repl, "launches": total[n],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
