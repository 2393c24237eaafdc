"""csrc/banded_pass.cu's ms a launch on the scanned map's cell, where every
launch is dirty-driven (the extended-lane mode): walker and prescan time
over the launches. A dirty launch walks the rows its dirty table marks,
which the program does not expose, so no roofline is read for it."""

from navbench import readings


def read(trace):
    return readings.dirty_pass_ms(trace)
