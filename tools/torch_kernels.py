#!/usr/bin/env python3
"""The kernel phases of ``chip_smoke.py`` alone (2: every solo kernel
against its plain version, with K4 against 4 K3 launches; 2d: the block and
banded modes of K5 and K6), after each CUDA source's register, shared
memory and spill counts as ``nvcc -Xptxas -v`` prints them.

With ``--run-g-memory`` it runs only run G's gradient (run D's
configuration on a (2,2,1) mesh, one card) and prints the peak device
memory after the forward and after the backward, which says which of the
two sets the run's peak.

A development helper, not the smoke check: it prints no result line.  Run
from the repository root on a machine with one NVIDIA card:

    python3 tools/torch_kernels.py [--run-g-memory]
"""

import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def resource_usage():
    """``-Xptxas -v`` for every source, kernel names demangled."""
    from levelsetfortran_tpu_torch import cuda_build
    nvcc = cuda_build._nvcc()
    with tempfile.TemporaryDirectory() as tmp:
        for src in cuda_build.sources():
            proc = subprocess.run(
                [nvcc, *cuda_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
                 os.path.join(tmp, src.stem + ".o"), str(src)],
                capture_output=True, text=True)
            lines = [ln for ln in proc.stderr.splitlines()
                     if "Compiling entry" in ln or "registers" in ln
                     or "spill" in ln]
            demangled = subprocess.run(["c++filt"], input="\n".join(lines),
                                       capture_output=True, text=True)
            out = demangled.stdout if demangled.returncode == 0 else \
                "\n".join(lines)
            print(f"[ptxas] {src.name}\n{out}", flush=True)


def profile_kernels():
    """Device time per CUDA kernel (torch.profiler, 10 calls) of K5 and K4
    at the main shape: which pass of a launch takes the time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from levelsetfortran_tpu_torch.ops import minmax_cuda as mc
    from levelsetfortran_tpu_torch.ops import weno_cuda as wc
    shape, dx = cs.MAIN_SHAPE, 0.01
    phi, sgn = cs.sphere(shape, dx, 1.0), cs.sphere(shape, dx, 1.1)
    g = torch.ones(shape, device="cuda")
    h, h1 = 0.1 * dx / 3.0, 0.01 * dx / 3.0
    act = wc.tile_activity(phi, dx, 4.1, window="owned")
    cases = {
        "K5 dense": lambda: wc.reinit_step_vjp(phi, sgn, g, dx, h),
        "K4 dense": lambda: mc.minmax_fusedk(phi, dx, h1, ksteps=4,
                                             with_rms=True),
        "K4 banded": lambda: mc.minmax_fusedk(phi, dx, h1, ksteps=4,
                                              active=act, with_rms=True)}
    n, bdx = cs.BENCH_N, cs.BENCH_DX
    bphi = cs.sphere((n,) * 3, bdx, cs.BENCH_R)
    bsgn = cs.sphere((n,) * 3, bdx, 1.1 * cs.BENCH_R)
    bg = torch.ones((n,) * 3, device="cuda")
    bh = 0.1 * bdx
    act5 = wc.tile_activity(bphi, bdx, 8.1, 5 * bh / bdx, window="band4")
    cases["K5 dense 256^3"] = lambda: wc.reinit_step_vjp(bphi, bsgn, bg, bdx,
                                                         bh)
    cases["K5 banded 256^3"] = lambda: wc.reinit_step_vjp_banded(
        bphi, bsgn, bg, bdx, bh, act5)
    for name, fn in cases.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
        rows = []
        for e in prof.key_averages():
            t = getattr(e, "device_time_total", None)
            if t is None:
                t = getattr(e, "cuda_time_total", 0.0)
            if t > 0:
                rows.append((t / max(e.count, 1), e.count, e.key[:90]))
        for t, n, key in sorted(rows, reverse=True)[:8]:
            print(f"[profile] {name}: {t:.1f} us x {n}  {key}", flush=True)


def run_g_memory():
    import torch
    from levelsetfortran_tpu_torch import render_from_vertices
    from levelsetfortran_tpu_torch.models import analytic
    from levelsetfortran_tpu_torch.parallel.mesh import make_mesh
    ball = analytic.icosphere_mesh(subdivisions=5)
    grid = cs.cube_grid(ball.vertices, 256)
    kw = dict(eye=(0.0, -3.0, 0.0), target=(0.0, 0.0, 0.0), reinit_steps=50,
              minmax_steps=20, height=64, width=64, culling="auto",
              mesh=make_mesh((2, 2, 1), ["cuda"]))
    v = torch.tensor(ball.vertices, dtype=torch.float32,
                     device="cuda").requires_grad_(True)
    torch.cuda.reset_peak_memory_stats()
    out = render_from_vertices(v, ball.elements, grid, **kw)
    loss = 0.5 * torch.sum(out.image ** 2)
    torch.cuda.synchronize()
    fwd = torch.cuda.max_memory_allocated() / 2 ** 30
    held = torch.cuda.memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    grad, = torch.autograd.grad(loss, v)
    torch.cuda.synchronize()
    bwd = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[run G memory] forward peak {fwd:.2f} GiB, held by the graph at "
          f"its end {held:.2f} GiB, backward peak {bwd:.2f} GiB; loss "
          f"{float(loss):.6g}, max|grad| {float(grad.abs().max()):.6g}; "
          f"card {cs.CARD}", flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_kernels: no CUDA device", file=sys.stderr)
        return 2
    cs.start()
    if "--run-g-memory" in sys.argv[1:]:
        run_g_memory()
        return 0
    resource_usage()
    profile_kernels()
    record = {n: {"max_abs_err": 0.0, "library_ms": None}
              for n in cs.kernel_names()}
    cs.kernel_phase(record)
    cs.adjoint_mode_phase(record)
    print(f"kernel phases passed on {torch.cuda.get_device_name(0)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
