"""Map, layer, planner and controller parameters (port of
mesh_navigation_tpu/config.py).

Plain frozen dataclasses with the reference's parameter names and defaults
(mesh_map.cpp:97-123, layer_manager.cpp:18-95, dijkstra_mesh_planner.h:180-190,
mesh_controller.h:190-203).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MeshMapConfig:
    """mesh_map.* parameters (mesh_map.cpp:97-123) that the port reads."""
    edge_cost_factor: float = 0.0       # mesh_map.cpp:105
    default_layer: str = ""             # mesh_map.cpp:107-112


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


@dataclasses.dataclass(frozen=True)
class LayerConfig:
    """One entry of the mesh_map.layers list (layer_manager.cpp:18-95)."""
    name: str
    kind: str                            # layer type, e.g. "steepness"
    inputs: tuple[str, ...] = ()
    factor: float = 1.0                  # combination_weight (abstract_layer.h:180)
    params: tuple[tuple[str, float], ...] = ()

    def param(self, key: str, default: float) -> float:
        for k, v in self.params:
            if k == key:
                return v
        return default


@dataclasses.dataclass(frozen=True)
class NavConfig:
    mesh_map: MeshMapConfig = MeshMapConfig()
    planner: PlannerConfig = PlannerConfig()
    controller: ControllerConfig = ControllerConfig()
    layers: tuple[LayerConfig, ...] = ()
