"""The readings that a cell's correctness limits are set from.

    python -m h100bench.control --workload <cell> --seeds 1,2,3 \\
        --dtype float32,bfloat16 [--out FILE]

For each seed and dtype: the cell's jobs from the seed, one job drawn from
the seed run through the program in that dtype, and the numbers that
decide ``correct`` read against the plain reference (float32).  float32
gives the lower readings (sound runs of the program); bfloat16, the
program's own lower-precision path, is the control, which the limits must
fail.  One line of JSON per reading on standard output (and appended to
``--out``).  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time


def readings(cell: str, seeds, dtypes, *, device="cuda", root=None,
             out=None):
    import numpy as np
    import torch
    from h100bench import catalog
    from h100bench.run import Ctx
    root = root or catalog.HERE.parent
    bench = catalog.benchmark(root)
    w = catalog.workload(bench, cell)
    here = root / "h100bench"
    config = catalog.config(bench, w["config"], root)
    traffic = catalog.traffic(w["traffic"], here)
    module = catalog.entry(traffic["entry"], here)
    found = []
    for seed in seeds:
        k = int(np.random.default_rng(np.random.SeedSequence(
            [int(seed) & (2 ** 128 - 1), 11])).integers(0, traffic["pool"]))
        for dtype in dtypes:
            with tempfile.TemporaryDirectory(prefix="h100bench-") as tmp:
                ctx = Ctx(cell, seed, config, traffic, device, tmp,
                          dtype=dtype)
                entry = module.Entry(ctx)
                entry.setup()
                t0 = time.perf_counter()
                rec, output = entry.job(k)
                t1 = time.perf_counter()
                entry.release()
                numbers = entry.check([(k, output)])
                del output, entry
                if device == "cuda":
                    torch.cuda.empty_cache()
            line = dict(cell=cell, seed=seed, dtype=dtype, job=k,
                        job_s=t1 - t0, check_s=time.perf_counter() - t1,
                        numbers=numbers)
            found.append(line)
            print(json.dumps(line), flush=True)
            if out:
                with open(out, "a") as f:
                    f.write(json.dumps(line) + "\n")
    return found


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--dtype", default="float32,bfloat16")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    readings(args.workload, [int(s) for s in args.seeds.split(",")],
             args.dtype.split(","), out=args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
