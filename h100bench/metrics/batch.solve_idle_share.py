"""Per cent of the packed solves' time (the program's spans
``lsf.batched_solve``) in which the device ran no operation: how far the
host's step loop holds the card back."""

from h100bench.spans import idle_share_in


def read(run):
    return idle_share_in(run, "lsf.batched_solve")
