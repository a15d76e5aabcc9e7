"""Device milliseconds per step of the dense reinit: the kernels launched
inside the program's spans ``lsf.reinit`` over the window, over its
counter ``reinit.steps`` (the steps those solves took)."""

from h100bench.spans import kernel_ms_per_job


def read(run):
    if run.trace is None:
        return None
    from levelsetfortran_tpu_torch.utils import profiling
    read_counters = getattr(profiling, "counters", None)
    steps = (read_counters() if read_counters else {}).get("reinit.steps")
    ms = [m for m in kernel_ms_per_job(run, "lsf.reinit") if m is not None]
    if not steps or not ms:
        return None
    return sum(ms) / steps
