"""Per cent of the traced window in which the device ran no operation
(kernels, copies, sets): the window minus the union of their intervals,
over the window."""

from h100bench.readers import idle_share


def read(run):
    return idle_share(run)
