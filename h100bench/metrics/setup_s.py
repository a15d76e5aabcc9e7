"""Set-up seconds: from the process's start to the window's (imports, the
card and the kernels' library, the job pool, one warm-up job)."""


def read(run):
    return run.setup_s
