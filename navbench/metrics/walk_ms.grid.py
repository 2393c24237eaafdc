"""The path walk's ms a step on the gridded map's cell:
ops/banded_gpu.extract_paths_cls, the planner's extract stage (with the
class-9 decode on an irregular plan)."""

from navbench import readings


def read(trace):
    return readings.stage_ms(trace, ("extract",))
