"""Seconds per mesh of the init's host culling build (the program's
``init_sign.stage_times["culling"]``, set in the traced run only)."""

from h100bench.readers import mean


def read(run):
    return mean(r.get("culling_s") for r in run.records)
