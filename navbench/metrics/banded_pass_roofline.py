"""csrc/banded_pass.cu's share of its roofline, in %, on the gridded map's
cell, where every launch is a main-mode launch: the frozen bound of those
launches (navbench/counts.py on the field's own shape) over their
measured time (walker and prescan kernels)."""

from navbench import readings


def read(trace):
    return readings.pass_roofline(trace)
