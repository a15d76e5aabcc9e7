"""Per cent of the dense reinit's time (the program's spans
``lsf.reinit``) in which the device ran no operation: what the host read
of each step's sum costs the loop."""

from h100bench.spans import idle_share_in


def read(run):
    return idle_share_in(run, "lsf.reinit")
