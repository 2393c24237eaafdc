"""The share of the path walk's lane-steps in which the lane still walked, on
the gridded map's cell: the program's "walk_lane_steps" over "walk_steps" times
the lanes."""

from navbench import counters


def read(trace):
    return counters.walk_lane_use(trace)
