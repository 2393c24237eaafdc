"""The card's idle share over the traced window on the gridded map's cell: 1 -
the union of its kernel and memory-operation intervals over the window's
wall time (navbench/devtrace.py)."""

from navbench import readings


def read(trace):
    return readings.idle_share(trace)
