"""Window seconds over meshes completed (host clock)."""


def read(run):
    n = sum(r["units"] for r in run.records)
    return run.window_s / n if n else None
