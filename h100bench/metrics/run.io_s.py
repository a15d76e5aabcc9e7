"""Seconds per mesh in the program's STL reader and its three writers (the
harness's host clock around them)."""

from h100bench.readers import mean


def read(run):
    return mean(r.get("io_s") for r in run.records)
