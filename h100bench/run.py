"""The H100 benchmark of ``levelsetfortran_tpu_torch``: one run of one cell.

    python -m h100bench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Set-up makes the cell's jobs from the seed and runs one of them to warm
up; then one caller sends jobs one after another for ``--seconds`` (a
closed loop), and the job running when the time is up completes.  After
the window the program's outputs of one of the window's jobs, drawn from
the seed, are compared with the plain reference (``reference/``).
``--trace 1`` records the window under ``torch.profiler`` (at most
``TRACE_SECONDS`` of it) and reports the per-layer metrics; ``--trace 0``
the end-to-end ones.
The last line of standard output is the result; the last lines of
standard error are the numbers compared, each beside its limit.

It runs on the card it is started on and on nothing else: without CUDA,
or with fewer cards than the cell asks for, it prints no result and exits
with 2.  Where JAX or the JAX package is loaded in the process once all
else is done (the check and the metrics' readers included), it prints no
result and exits with 3.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

T_MAIN = time.time()

#: Top-level modules that may not be loaded once the window has closed.
FORBIDDEN = ("jax", "jaxlib", "flax", "levelsetfortran_tpu")
#: Longest traced window, seconds.
TRACE_SECONDS = 10.0


def process_start() -> float:
    """Wall-clock time at which this process started (Linux), else the
    time this module was imported."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return T_MAIN


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


@dataclasses.dataclass
class Ctx:
    """What an entry is given: the cell, its configuration and traffic,
    the seed, the device, a scratch directory, and whether the window is
    traced.  ``dtype`` names the program's dtype where it is not the
    configuration's (the control)."""
    cell: str
    seed: int
    config: dict
    traffic: dict
    device: str
    tmpdir: str
    traced: bool = False
    dtype: str = None


@dataclasses.dataclass
class Run:
    """What a metric reads: the window's job records, its length, the set-up
    phases and their total (from the process's start to the window's), and
    in a traced run the trace and the window's bounds in it."""
    ctx: Ctx
    records: list
    window_s: float
    setup: dict
    setup_s: float
    trace: object = None
    lo: float = 0.0
    hi: float = 0.0

    def job_spans(self) -> list:
        """(record, span) of each traced job, in order."""
        spans = sorted(self.trace.spans.get("h100bench.job", []),
                       key=lambda e: e.ts) if self.trace else []
        return list(zip(self.records, spans))


def window(entry, seconds: float, seed: int):
    """Jobs back to back until ``seconds`` have passed: (records, the
    checked job's ``(i, output)`` in a list, window seconds, failed).  The
    checked job is one drawn uniformly from the seed, job by job (a
    reservoir of one), so only its output is held."""
    import numpy as np
    import torch
    rng = np.random.default_rng(np.random.SeedSequence(
        [int(seed) & (2 ** 128 - 1), 7]))
    records, kept, failed = [], [], 0
    t0 = time.perf_counter()
    with torch.profiler.record_function("h100bench.window"):
        i = 0
        while True:
            try:
                with torch.profiler.record_function("h100bench.job"):
                    rec, out = entry.job(i)
                records.append(rec)
                if len(records) == 1 or rng.integers(0, len(records)) == 0:
                    kept = [(i, out)]
            except Exception:   # a job that fails is counted and reported
                failed += 1
                traceback.print_exc()
            i += 1
            if time.perf_counter() - t0 >= seconds:
                break
    return records, kept, time.perf_counter() - t0, failed


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not read"


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, checks): each number beside its limit; a number passes
    when it is finite and at most its limit."""
    checks, ok = {}, True
    for name, value in numbers.items():
        limit = limits.get(name)
        good = (limit is not None and value == value and value <= limit)
        ok &= good
        checks[name] = {"value": value, "limit": limit}
    missing = set(limits) - set(numbers)
    for name in sorted(missing):
        checks[name] = {"value": None, "limit": limits[name]}
    return ok and not missing and bool(numbers), checks


def measure(cell: str, seed: int, seconds: float, traced: bool, *,
            device: str = "cuda", root=None) -> dict:
    """One run of ``cell``: the result object (without printing it).
    ``device="cpu"`` skips the look for a card (tests only)."""
    from h100bench import catalog
    t_imports = time.time()
    import numpy  # noqa: F401
    import torch
    import levelsetfortran_tpu_torch  # noqa: F401
    from levelsetfortran_tpu_torch import cuda_build
    root = root or catalog.HERE.parent
    bench = catalog.benchmark(root)
    w = catalog.workload(bench, cell)
    if device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device: this benchmark runs on the "
                             "card only")
        if torch.cuda.device_count() < int(w["chips"]):
            raise SystemExit(f"{cell} needs {w['chips']} cards, "
                             f"{torch.cuda.device_count()} visible")
    here = root / "h100bench"
    config = catalog.config(bench, w["config"], root)
    traffic = catalog.traffic(w["traffic"], here)
    setup = {"start": t_imports - process_start()}
    t = time.time()
    setup["imports"] = t - t_imports
    if device == "cuda":
        torch.cuda.init()
        torch.empty(1, device=device)
        cuda_build.library()
    setup["cuda"] = time.time() - t
    with tempfile.TemporaryDirectory(prefix="h100bench-") as scratch:
        ctx = Ctx(cell, seed, config, traffic, device, scratch, traced)
        entry = catalog.entry(traffic["entry"], here).Entry(ctx)
        t = time.time()
        entry.setup()
        setup["pool"] = time.time() - t
        t = time.time()
        entry.warm()
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        setup["warm"] = time.time() - t
        prof, trace_path = None, os.path.join(scratch, "trace.json")
        if traced:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if device == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
            seconds = min(seconds, TRACE_SECONDS)
        setup_s = time.time() - process_start()
        try:
            records, kept, window_s, failed = window(entry, seconds, seed)
            if device == "cuda":
                torch.cuda.synchronize()
        finally:
            if prof is not None:
                prof.__exit__(None, None, None)
        peak = (torch.cuda.max_memory_allocated() if device == "cuda"
                else 0)
        run = Run(ctx, records, window_s, setup, setup_s)
        if prof is not None:
            from h100bench import trace as tr
            prof.export_chrome_trace(trace_path)
            del prof
            run.trace = tr.load(trace_path)
            os.remove(trace_path)
            win = run.trace.span("h100bench.window")
            run.lo, run.hi = (win.ts, win.end) if win else (0.0, 0.0)
        entry.release()
        if device == "cuda":
            torch.cuda.empty_cache()
        numbers = entry.check(kept) if kept else {}
        correct, checks = verdict(numbers, catalog.limits(cell, here))
        metrics = {}
        for m in catalog.metrics_of(bench, cell, traced):
            value = catalog.metric(m["name"], here).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                    else device),
           "count": int(w["chips"]), "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct and failed == 0),
              "attempted": len(records) + failed, "failed": failed,
              "metrics": metrics, "device": dev}
    if run.trace is not None:
        from h100bench import trace as tr
        dev["busy_s"] = tr.busy_s(run.trace, run.lo, run.hi)
        dev["window_s"] = (run.hi - run.lo) * 1e-6
        result["breakdown"] = {
            "device_ops": tr.top_device_ops(run.trace, run.lo, run.hi),
            "idle_gaps": tr.idle_gaps(run.trace, run.lo, run.hi)}
    result["checks"] = checks
    result["_setup"] = setup
    return result


def main(argv=None, *, device: str = "cuda", root=None) -> int:
    """The command.  ``device="cpu"`` and ``root`` as for ``measure``
    (tests only)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        result = measure(args.workload, args.seed, args.seconds,
                         bool(args.trace), device=device, root=root)
    except SystemExit as e:
        print(e, file=sys.stderr)
        return 2
    setup = result.pop("_setup")
    # read last, after the reference's check and every metric's reader
    found = forbidden_modules()
    if found:
        print("loaded in this process: " + ", ".join(found),
              file=sys.stderr)
        return 3
    print("set-up s: " + ", ".join(f"{k} {v:.3f}" for k, v in setup.items()),
          file=sys.stderr)
    print(f"card: {card_line()}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
