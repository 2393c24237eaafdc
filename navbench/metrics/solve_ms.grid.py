"""The solve loop's ms a step on the gridded map's cell:
ops/banded_gpu.banded_solve_padded and the class table, the solve and pred
stages."""

from navbench import readings


def read(trace):
    return readings.stage_ms(trace, ("solve", "pred"))
