"""The path walk's microseconds a walk step on the gridded map's cell: the
extract stage's time over the program's "walk_steps"."""

from navbench import counters


def read(trace):
    return counters.walk_step_us(trace)
