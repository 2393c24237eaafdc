"""The controller's ms a step on the scanned map's cell:
MeshController.compute_velocity_banded's control stage."""

from navbench import readings


def read(trace):
    return readings.stage_ms(trace, ("control",))
