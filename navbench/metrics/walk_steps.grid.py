"""The steps the path walk (ops/banded_gpu.extract_paths_cls) ran a step on the
gridded map's cell: its chunks run times the chunk, the program's counter
"walk_steps"."""

from navbench import counters


def read(trace):
    return counters.walk_steps(trace)
