"""The planner facade's own ms a step on the scanned map's cell:
DijkstraPlanner.plan_batch_banded's snap and pose stages (the port's
StageTimer, CUDA events)."""

from navbench import readings


def read(trace):
    return readings.stage_ms(trace, ("snap", "pose"))
