#!/usr/bin/env python3
"""Kernel-level measurements of the PyTorch port on one NVIDIA card.

Default: each CUDA source's register, shared memory and spill counts as
``nvcc -Xptxas -v`` prints them; the SASS instruction counts of the K1, K3
and K6 kernels; a ``torch.profiler`` split of K5, K4 and K6 by CUDA kernel;
then every mode of K1, K3 and K6 (dense, banded, pack, block; K6 also with
a solve's buffers) timed three ways: CUDA events around one call (median
of 20), the device time per call under ``torch.profiler`` (every CUDA
kernel the call launches), and the wrapper's host time per call (N calls
enqueued with no synchronize, the host clock over N); then the kernel
phases of ``chip_smoke.py`` (2 and 2d) alone.

``--against DIR [DIR ...]``: the same K1, K3 and K6 cases in other
checkouts (trees of this repository, e.g. the parent commit unpacked into
the git-ignored ``_archive/``) and this one, each in its own process, in
turns (the others, this, this, the others reversed) on one card; every
output field and sum of this tree is compared with the first DIR's bitwise
(a case the other tree lacks, such as a call with a solve's buffers, is
only timed), and the times are printed side by side.

``--cases K3,K6``: with ``--against`` (or alone), only the mode cases
whose names start with one of these prefixes.

``--sass OUT [DIR ...]``: the SASS counts of this tree's and the other
trees' K1, K3 and K6 sources, each listing written into the directory
OUT.

``--run-g-memory``: only run G's gradient (run D's configuration on a
(2,2,1) mesh, one card), and the peak device memory after the forward and
after the backward.

A development helper, not the smoke check: it prints no result line.  Run
from the repository root on a machine with one NVIDIA card:

    python3 tools/torch_kernels.py [--against DIR [DIR ...] | --sass OUT [DIR ...]
                                    | --run-g-memory] [--cases PREFIX,...]
"""

import importlib.util
import inspect
import os
import re
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: H100 SXM: SMs, warp schedulers per SM (one warp instruction per clock
#: each), lanes per warp.
SMS, SCHEDULERS, LANES = 132, 4, 32


def _chip_smoke():
    """``chip_smoke.py`` of this checkout, whatever tree the package is
    imported from."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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


def sass_counts(csrc=None, dump=None):
    """SASS instructions of every kernel of the K1, K3 and K6 sources (of
    ``csrc``, default this checkout's), from ``nvdisasm`` of each source's
    cubin: all of them, the main body (up to the first ``$__internal``
    subroutine: the slow paths of IEEE division and square root), and a few
    classes; ``dump``: a path prefix to write each listing to.  Returns
    {kernel: main body}."""
    from levelsetfortran_tpu_torch import cuda_build
    nvcc = cuda_build._nvcc()
    nvdisasm = os.path.join(os.path.dirname(nvcc), "nvdisasm")
    flags = [f for f in cuda_build.NVCC_FLAGS if f not in ("-Xcompiler",
                                                            "-fPIC")]
    src_dir = cuda_build.CSRC if csrc is None else csrc
    counts = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in ("reinit_step.cu", "minmax_step.cu", "minmax_bwd.cu"):
            cubin = os.path.join(tmp, name + ".cubin")
            subprocess.run([nvcc, *flags, "-cubin", "-o", cubin,
                            os.path.join(src_dir, name)], check=True,
                           capture_output=True)
            text = subprocess.run([nvdisasm, "-c", cubin], check=True,
                                  capture_output=True, text=True).stdout
            if dump is not None:
                with open(f"{dump}{name}.sass", "w") as f:
                    f.write(text)
            fn, body, total, internal, cls = None, 0, 0, False, {}

            def flush():
                if fn is not None:
                    dem = subprocess.run(["c++filt", fn], capture_output=True,
                                         text=True).stdout.strip() or fn
                    counts[dem] = body
                    print(f"[sass] {name} {dem[:80]}: {total} instructions, "
                          f"main body {body}; "
                          + ", ".join(f"{k} {v}" for k, v in
                                      sorted(cls.items())), flush=True)

            for line in text.splitlines():
                m = re.match(r"\s*\.text\.(\S+):", line)
                if m:
                    flush()
                    fn, body, total, internal, cls = m.group(1), 0, 0, \
                        False, {}
                    continue
                if fn is None:
                    continue
                if re.match(r"\s*\$__internal", line):
                    internal = True
                m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?"
                              r"([A-Z][A-Z0-9_.]*)", line)
                if m:
                    total += 1
                    body += not internal
                    op = m.group(2).split(".")[0]
                    if op in ("MUFU", "BAR", "LDG", "LDS", "STS", "STG",
                              "CALL", "SHFL", "ATOMG", "RED"):
                        cls[op] = cls.get(op, 0) + 1
            flush()
    return counts


def issue_bound_ms(instructions_per_cell, cells, clock_mhz):
    """The least time the card's schedulers could issue ``cells`` x
    ``instructions_per_cell`` thread instructions: one warp instruction per
    scheduler per clock."""
    rate = SMS * SCHEDULERS * LANES * clock_mhz * 1e6
    return instructions_per_cell * cells / rate * 1e3


def max_sm_clock():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True)
    try:
        return float(smi.stdout.split()[0])
    except (IndexError, ValueError):
        return float("nan")


def mode_cases(cs):
    """Every mode of K1, K3 and K6 on the shapes ``chip_smoke.py`` uses:
    {name: (call, timed)}; ``call()`` returns the output tensors (fields
    and sums), ``timed`` says whether the case is timed."""
    import torch
    from levelsetfortran_tpu_torch.ops import minmax_cuda as mc
    from levelsetfortran_tpu_torch.ops import weno_cuda as wc
    from levelsetfortran_tpu_torch.parallel import sharded as sh
    from levelsetfortran_tpu_torch.parallel.halo import halo_exchange
    from levelsetfortran_tpu_torch.parallel.mesh import make_mesh, split_blocks

    cases = {}
    # the main paths' other shapes: run C's grid (its 1064 K3 and 13 K1
    # launches) and run D's 256^3 (its K1 and K3 launches), dense only
    extra = ((262, 42, 42), (cs.BENCH_N,) * 3)
    for shape in cs.SHAPES + extra:
        dx = {cs.MAIN_SHAPE: 0.01, extra[1]: cs.BENCH_DX}.get(shape, 0.05)
        r = {cs.MAIN_SHAPE: 1.0, extra[1]: cs.BENCH_R}.get(shape, 0.6)
        phi, sgn = cs.sphere(shape, dx, r), cs.sphere(shape, dx, 1.1 * r)
        h, h1 = 0.1 * dx / 3.0, 0.01 * dx / 3.0
        tag = "x".join(map(str, shape))
        timed = shape != cs.SHAPES[0]
        cases[f"K1 dense {tag}"] = (partial_(
            wc.reinit_step, phi, sgn, dx, h, with_rms=True), timed)
        cases[f"K3 dense {tag}"] = (partial_(
            mc.minmax_step, phi, dx, h1, with_rms=True), timed)
        if hasattr(wc, "solve_buffers"):
            # as the solvers call them: buffers and stream resolved once
            bufs = wc.solve_buffers(phi)
            cases[f"K1 dense {tag} (solve buffers)"] = (partial_(
                wc.reinit_step, phi, sgn, dx, h, with_rms=True, bufs=bufs),
                timed)
            cases[f"K3 dense {tag} (solve buffers)"] = (partial_(
                mc.minmax_step, phi, dx, h1, with_rms=True, bufs=bufs),
                timed)
        if shape in extra:
            continue
        act_r = wc.tile_activity(phi, dx, 8.1, 9 * h / dx, window="band4")
        act_m = wc.tile_activity(phi, dx, 4.1, window="owned")
        carry = phi + 0.0
        cases[f"K1 banded {tag}"] = (partial_(
            wc.reinit_step, phi, sgn, dx, h, active=act_r, with_rms=True),
            timed)
        cases[f"K1 banded carry {tag}"] = (
            lambda phi=phi, sgn=sgn, dx=dx, h=h, a=act_r, c=carry:
            wc.reinit_step(phi, sgn, dx, h, active=a, out=c.clone(),
                           mint=False, with_rms=True), False)
        cases[f"K3 banded {tag}"] = (partial_(
            mc.minmax_step, phi, dx, h1, active=act_m, with_rms=True),
            timed)
        cases[f"K3 banded carry {tag}"] = (
            lambda phi=phi, dx=dx, h1=h1, a=act_m, c=carry:
            mc.minmax_step(phi, dx, h1, active=a, out=c.clone(),
                           mint=False, with_rms=True), False)

    # pack: 8 spheres on run E's 129^3 and on 64^3, one geometry frozen
    for shape, dx in (((64, 64, 64), 0.03), ((129, 129, 129), cs.RUN_E_DX)):
        phi, sgn, h, h1, live = cs.packed_inputs(shape, dx)
        hv, h1v = (torch.tensor(v, device="cuda") for v in (h, h1))
        tag = f"{cs.PACK_B}x{shape[0]}^3"
        cases[f"K1 pack {tag}"] = (partial_(
            wc.reinit_step_packed, phi, sgn, dx, hv, live, with_rms=True),
            shape[0] == 129)
        cases[f"K3 pack {tag}"] = (partial_(
            mc.minmax_step_packed, phi, dx, h1v, live, with_rms=True),
            shape[0] == 129)

    # block: one shard's padded block of (2,2,1) on 222^3 and of (2,2,2)
    # on (66, 46, 38), dense, banded and a sub-box of the brick grid
    for shape, mshape, dx, r in ((cs.MAIN_SHAPE, (2, 2, 1), 0.01, 1.0),
                                 ((66, 46, 38), (2, 2, 2), 0.05, 0.6)):
        mesh = make_mesh(mshape, ["cuda"])
        phi, sgn = cs.sphere(shape, dx, r), cs.sphere(shape, dx, 1.1 * r)
        h, h1 = 0.1 * dx / 3.0, 0.01 * dx / 3.0
        w = sh.sharded_widths(mesh, sh.HALO)
        geoms = sh.reinit_geoms(mesh, shape, w)
        pads = [p.contiguous() for p in halo_exchange(
            split_blocks(mesh, phi), w, mesh)]
        spads = [p.contiguous() for p in halo_exchange(
            split_blocks(mesh, sgn), w, mesh)]
        w1 = sh.sharded_widths(mesh, 1)
        mgeoms = sh.minmax_geoms(mesh, shape, w1)
        mpads = [p.contiguous() for p in halo_exchange(
            split_blocks(mesh, phi), w1, mesh)]
        tag = f"{'x'.join(map(str, shape))} on {mshape}"
        for n, (p, s, g) in enumerate(zip(pads, spads, geoms)):
            if n not in (0, len(pads) - 1):
                continue
            act = wc.tile_activity(p, dx, 8.1, h / dx, window="band4",
                                   geom=g)
            nb = g.bricks(p.shape)
            sub = ((1, 0, 1), (max(nb[0] - 2, 1), nb[1], max(nb[2] - 1, 1)))
            timed = n == 0 and shape == cs.MAIN_SHAPE
            cases[f"K1 block {n} {tag}"] = (partial_(
                wc.reinit_step_block, p, s, dx, h, g, with_rms=True), timed)
            cases[f"K1 block banded {n} {tag}"] = (partial_(
                wc.reinit_step_block, p, s, dx, h, g, active=act,
                with_rms=True), False)
            cases[f"K1 block sub-box {n} {tag}"] = (partial_(
                wc.reinit_step_block, p, s, dx, h, g, tile_range=sub,
                with_rms=True), False)
        for n, (p, g) in enumerate(zip(mpads, mgeoms)):
            if n not in (0, len(mpads) - 1):
                continue
            timed = n == 0 and shape == cs.MAIN_SHAPE
            cases[f"K3 block {n} {tag}"] = (partial_(
                mc.minmax_step_block, p, dx, h1, g, with_rms=True), timed)
            blk = split_blocks(mesh, phi)[n]
            act = sh.minmax_tile_activity_local([blk], dx, 4.1)[0]
            cases[f"K3 block banded {n} {tag}"] = (partial_(
                mc.minmax_step_block, p, dx, h1, g, active=act,
                with_rms=True), False)
    cases.update(k6_cases(cs))
    return cases


def k6_cases(cs):
    """K6 at the shapes of ``chip_smoke.py``'s K6 lines: dense at 222^3 (a
    sphere after one K1 step) and at 256^3 (the bench sphere), banded at
    256^3 with its band4 mask (timed) and with random masks, block on the
    256^3 bench sphere cut (2,2,1) (shard 0 timed) and on (66, 46, 38) cut
    (2,2,2); with a standard-normal cotangent.  Where the package's K6
    takes a solve's buffers, the timed cases also with them (their field
    only: the buffers add the sums up)."""
    import numpy as np
    import torch
    from levelsetfortran_tpu_torch.ops import minmax_cuda as mc
    from levelsetfortran_tpu_torch.ops import weno_cuda as wc
    from levelsetfortran_tpu_torch.parallel import sharded as sh
    from levelsetfortran_tpu_torch.parallel.halo import halo_exchange
    from levelsetfortran_tpu_torch.parallel.mesh import make_mesh, split_blocks

    bufs_ok = "bufs" in inspect.signature(mc.minmax_step_vjp).parameters
    rng = np.random.default_rng(11)
    cases = {}

    def add(name, fn, make, timed, **kw):
        cases[name] = (partial_(fn, **kw), timed)
        if timed and bufs_ok:
            b = make()
            cases[name + " (solve buffers)"] = (
                lambda kw=kw, b=b: fn(bufs=b, **kw)[:1], True)

    def normal(shape):
        return torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                            device="cuda")

    for shape, dx, r in ((cs.MAIN_SHAPE, 0.01, 1.0),
                         ((cs.BENCH_N,) * 3, cs.BENCH_DX, cs.BENCH_R),
                         (cs.SHAPES[0], 0.05, 0.6)):
        phi = cs.sphere(shape, dx, r)
        h1 = 0.01 * dx * dx
        mm = wc.reinit_step(phi, cs.sphere(shape, dx, 1.1 * r), dx, 0.1 * dx)
        g = normal(shape)
        tag = "x".join(map(str, shape))
        timed = shape != cs.SHAPES[0]
        add(f"K6 dense {tag}", mc.minmax_step_vjp,
            lambda mm=mm, dx=dx, h1=h1: mc.VjpBuffers(mm, dx, h1), timed,
            phi=mm, g=g, dx=dx, h1=h1)
        if shape[0] != cs.BENCH_N:
            continue
        masks = [wc.tile_activity(mm, dx, 4.1, window="band4")]
        nb = masks[0].shape
        masks += [torch.tensor((rng.random(nb) < p).astype(np.int32),
                               device="cuda") for p in (0.5, 0.15)]
        for n, act in enumerate(masks):
            add(f"K6 banded {tag} mask {n}", mc.minmax_step_vjp_banded,
                lambda mm=mm, dx=dx, h1=h1: mc.VjpBuffers(mm, dx, h1), n == 0,
                phi=mm, g=g, dx=dx, h1=h1, active=act)
    for shape, mshape, dx, r in (((cs.BENCH_N,) * 3, (2, 2, 1), cs.BENCH_DX,
                                  cs.BENCH_R),
                                 ((66, 46, 38), (2, 2, 2), 0.05, 0.6)):
        mesh = make_mesh(mshape, ["cuda"])
        phi = cs.sphere(shape, dx, r)
        h1 = 0.01 * dx * dx
        mm = wc.reinit_step(phi, cs.sphere(shape, dx, 1.1 * r), dx, 0.1 * dx)
        g = normal(shape)
        w = sh.sharded_widths(mesh, wc.VJP_HALO["minmax"])
        geoms = sh.minmax_geoms(mesh, shape, w)
        pads, gpads = ([p.contiguous() for p in halo_exchange(
            split_blocks(mesh, f), w, mesh)] for f in (mm, g))
        tag = f"{'x'.join(map(str, shape))} on {mshape}"
        for n, (p, q, ge) in enumerate(zip(pads, gpads, geoms)):
            if n not in (0, len(pads) - 1):
                continue
            add(f"K6 block {n} {tag}", mc.minmax_step_block_vjp,
                lambda p=p, dx=dx, h1=h1, ge=ge: mc.VjpBuffers(
                    p, dx, h1, geom=ge),
                n == 0 and mshape == (2, 2, 1), pad=p, g_pad=q, dx=dx,
                h1=h1, geom=ge)
    return cases


def partial_(fn, *a, **k):
    return lambda: fn(*a, **k)


def flat(res):
    return list(res) if isinstance(res, (tuple, list)) else [res]


def run_cases(out_path=None, only=None):
    """Every K1/K3/K6 mode case of this process's package: its outputs (saved
    to ``out_path`` as CPU tensors when given) and, for the timed cases,
    events, device and host times per call."""
    import torch
    cs = _chip_smoke()
    outs, times = {}, {}
    for name, (fn, timed) in mode_cases(cs).items():
        if only and not name.startswith(tuple(only)):
            continue
        a = [t.detach().cpu() for t in flat(fn())]
        b = [t.detach().cpu() for t in flat(fn())]
        same = all(torch.equal(x, y) for x, y in zip(a, b))
        outs[name] = a
        line = f"[modes] {name}: two calls bitwise equal {same}"
        if timed:
            t = (cs.median_ms(fn, 20), cs.device_ms(fn), cs.host_ms(fn))
            times[name] = t
            line += (f"; events {t[0]:.4f} ms, device {t[1]:.4f} ms, "
                     f"host {t[2]:.4f} ms per call")
        print(line, flush=True)
        if not same:
            raise AssertionError(f"{name}: two calls differ")
        torch.cuda.empty_cache()
    if out_path is not None:
        torch.save({"outs": outs, "times": times}, out_path)
    return outs, times


def against(others, only=None):
    """This tree's K1/K3/K6 cases against other trees' (the first: the
    reference), in turns (others, this, this, others reversed), each in its
    own process: bitwise against the first where it has the case, and
    timed."""
    import torch
    others = [os.path.abspath(o) for o in others]
    trees = others + [HERE, HERE] + others[::-1]
    res = []
    with tempfile.TemporaryDirectory() as tmp:
        for n, tree in enumerate(trees):
            path = os.path.join(tmp, f"{n}.pt")
            env = dict(os.environ, PYTHONPATH=tree)
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--child", tree, path,
                            *(["--cases", ",".join(only)] if only else [])],
                           check=True, env=env)
            res.append(torch.load(path))
    ref, new = res[0]["outs"], res[len(others)]["outs"]
    bitwise = _chip_smoke().bitwise
    bad = []
    for name in ref:
        eq = len(ref[name]) == len(new[name]) and all(
            bitwise(a, b) for a, b in zip(ref[name], new[name]))
        if not eq:
            bad.append(name)
        print(f"[against] {name}: bitwise equal to {others[0]}'s {eq}",
              flush=True)
    labels = [os.path.relpath(t, HERE) or "this tree" for t in trees]
    for name in res[len(others)]["times"]:
        cells = "; ".join(
            f"{label} " + ("/".join(f"{v:.4f}" for v in r["times"][name])
                           if name in r["times"] else "-")
            for label, r in zip(labels, res))
        print(f"[against] {name}: events/device/host ms per call: {cells}",
              flush=True)
    if bad:
        raise AssertionError(f"not bitwise equal to {others[0]}: {bad}")


def profile_kernels():
    """Device time per CUDA kernel (torch.profiler, 10 calls) of K5, K4 and
    K6 at the main shape: which pass of a launch takes the time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from levelsetfortran_tpu_torch.ops import minmax_cuda as mc
    from levelsetfortran_tpu_torch.ops import weno_cuda as wc
    cs = _chip_smoke()
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
                                              active=act, with_rms=True),
        "K1 dense": lambda: wc.reinit_step(phi, sgn, dx, h, with_rms=True),
        "K3 dense": lambda: mc.minmax_step(phi, dx, h1, with_rms=True)}
    for name, (fn, timed) in k6_cases(cs).items():
        if timed:
            cases[name] = fn
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
    cs = _chip_smoke()
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
    args = sys.argv[1:]
    only = None
    if "--cases" in args:
        n = args.index("--cases")
        only = args[n + 1].split(",")
        del args[n:n + 2]
    if args[:1] == ["--child"]:
        sys.path.insert(0, args[1])
        import torch
        cs = _chip_smoke()
        cs.start()
        import levelsetfortran_tpu_torch as pkg
        print(f"[child] {args[1]}: package from "
              f"{os.path.dirname(pkg.__file__)}; "
              f"{torch.cuda.get_device_name(0)}", flush=True)
        run_cases(args[2], only)
        return 0
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        print("torch_kernels: no CUDA device", file=sys.stderr)
        return 2
    cs = _chip_smoke()
    cs.start()
    if "--run-g-memory" in args:
        run_g_memory()
        return 0
    if "--sass" in args:
        # SASS of this tree's and other trees' K1/K3 sources, the listings
        # into OUT
        out, *others = args[args.index("--sass") + 1:]
        os.makedirs(out, exist_ok=True)
        for tree in [HERE] + others:
            tag = os.path.basename(os.path.abspath(tree))
            print(f"[sass] tree {tree}", flush=True)
            sass_counts(os.path.join(tree, "levelsetfortran_tpu_torch",
                                     "csrc"), os.path.join(out, f"{tag}_"))
        return 0
    if "--against" in args:
        resource_usage()
        against(args[args.index("--against") + 1:], only)
        return 0
    resource_usage()
    counts = sass_counts()
    clock = max_sm_clock()
    cells = 1
    for n in cs.MAIN_SHAPE:
        cells *= n
    for name, body in counts.items():
        if "reinit" in name:
            print(f"[sass] issue bound if every cell of {cs.MAIN_SHAPE} "
                  f"issued the {body} main-body instructions of {name[:60]}"
                  f" once: {issue_bound_ms(body, cells, clock):.4f} ms at "
                  f"{clock:.0f} MHz", flush=True)
    profile_kernels()
    run_cases(only=only)
    record = {n: {"max_abs_err": 0.0, "library_ms": None}
              for n in cs.kernel_names()}
    cs.kernel_phase(record)
    cs.adjoint_mode_phase(record)
    print(f"kernel phases passed on {torch.cuda.get_device_name(0)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
