"""Meshes of the completed batches over window seconds (host clock)."""


def read(run):
    n = sum(r["units"] for r in run.records)
    return n / run.window_s if n and run.window_s > 0 else None
