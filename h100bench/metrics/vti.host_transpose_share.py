"""The share of the ``.vti`` writes whose field the host had to copy into
the payload's x-fastest order, over the window: the program's counters
``vti.host_transposes`` over ``vti.writes``."""

from h100bench.spans import counter_ratio


def read(run):
    return counter_ratio(run, "vti.host_transposes", "vti.writes")
