"""The residual scatter-min's ms a step on the scanned map's cell: the
program's span "solve/residual", a part of the solve stage."""

from navbench import counters


def read(trace):
    return counters.residual_ms(trace)
