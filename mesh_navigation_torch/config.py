"""Planner and controller parameters (port of mesh_navigation_tpu/config.py).

Plain frozen dataclasses with the reference's parameter names and defaults
(dijkstra_mesh_planner.h:180-190, mesh_controller.h:190-203).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PlannerConfig:
    """Shared planner parameters."""
    publish_vector_field: bool = False
    publish_face_vectors: bool = False
    goal_dist_offset: float = 0.3
    cost_limit: float = 1.0
    step_width: float = 0.4             # CVP only (cvp_mesh_planner.h:211)
    # Sweep-solver controls (no reference analog):
    max_sweeps: int = 0                 # 0 = auto; the banded solve caps
                                        # rounds at max(max_sweeps // 2, 64)
    block_sweeps: int = 8
    method: str = "batched"
    ordered_rounds: int = 0
    sweep_directions: int = 4


@dataclasses.dataclass(frozen=True)
class ControllerConfig:
    """mesh_controller parameters (mesh_controller.h:190-203)."""
    max_lin_velocity: float = 1.0
    max_ang_velocity: float = 0.5
    arrival_fading: float = 0.5
    ang_vel_factor: float = 1.0
    lin_vel_factor: float = 1.0
    max_angle: float = 20.0             # degrees
    max_search_radius: float = 0.4
    max_search_distance: float = 0.4
