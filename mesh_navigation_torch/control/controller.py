"""Vector-field-following controller, batched over robots (port of
mesh_navigation_tpu/control/controller.py:45-264).

Per control cycle: track each robot's face, sample the planner's direction
field at the barycentric position (recovered on the fly from the banded
solve's field at the tracked face's three vertices), and emit (linear,
angular) velocities by the naiveControl law (mesh_controller.cpp:225-242).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from mesh_navigation_torch.api.outcomes import Outcome
from mesh_navigation_torch.config import ControllerConfig
from mesh_navigation_torch.device import resolve_device
from mesh_navigation_torch.mesh import geometry, query
from mesh_navigation_torch.mesh.arrays import MeshArrays
from mesh_navigation_torch.control import tracking
from mesh_navigation_torch.ops import banded_gpu as _bg
from mesh_navigation_torch.utils.timing import stage as _stage


@dataclasses.dataclass(frozen=True)
class ControllerState:
    """Per-robot tracking state (mesh_controller.cpp:179-193), batched."""
    current_face: torch.Tensor  # [B] i64 (-1 = unknown -> global search)
    goal_pos: torch.Tensor      # [B, 3]
    goal_dir: torch.Tensor      # [B, 3]
    cancel: torch.Tensor        # [B] bool


@dataclasses.dataclass(frozen=True)
class VelocityCommand:
    linear: torch.Tensor         # [B] m/s along +x
    angular: torch.Tensor        # [B] rad/s around +z
    outcome: torch.Tensor        # [B] i32
    cost: torch.Tensor           # [B] combined cost under the robot
    heading_error: torch.Tensor  # [B] φ


def initial_state(goal_pos: torch.Tensor, goal_dir: torch.Tensor) -> ControllerState:
    """setPlan: record the goal poses, reset the tracked faces
    (mesh_controller.cpp:179-193). goal_pos [B, 3], goal_dir [B, 3] or [3]."""
    B = goal_pos.shape[0]
    dev = goal_pos.device
    goal_dir = torch.broadcast_to(goal_dir.to(dev, goal_pos.dtype), goal_pos.shape)
    return ControllerState(
        current_face=torch.full((B,), -1, dtype=torch.int64, device=dev),
        goal_pos=goal_pos,
        goal_dir=geometry.normalize(goal_dir),
        cancel=torch.zeros(B, dtype=torch.bool, device=dev),
    )


def naive_control(robot_dir, mesh_dir, mesh_normal, config: ControllerConfig):
    """MeshController::naiveControl (mesh_controller.cpp:225-242): heading
    error φ = acos(mesh_dir·robot_dir) signed by (mesh_dir × robot_dir)·n;
    angular ∝ φ; linear fades to 0 as φ -> max_angle. Returns
    (linear, angular, φ)."""
    cosphi = torch.clamp(torch.sum(mesh_dir * robot_dir, dim=-1), -1.0, 1.0)
    phi = torch.arccos(cosphi)
    sign_phi = torch.sum(geometry.cross(mesh_dir, robot_dir) * mesh_normal, dim=-1)
    angular = torch.copysign(phi * config.max_ang_velocity / math.pi, -sign_phi)
    max_angle = config.max_angle * math.pi / 180.0
    linear = torch.where(
        phi <= max_angle,
        config.max_lin_velocity - phi * config.max_lin_velocity / max_angle,
        0.0,
    )
    return linear, angular, phi


class MeshController:
    """MeshController-shaped facade (mbf_mesh_core/mesh_controller.h:51-115)."""

    def __init__(
        self,
        mesh: MeshArrays,
        config: ControllerConfig = ControllerConfig(),
        *,
        grid: query.SpatialGrid | None = None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.mesh = mesh.to(self.device)
        self.config = config
        self.grid = grid if grid is not None else query.build_grid(self.mesh)

    def compute_velocity_banded(
        self,
        kernel_plan: _bg.BandedKernelPlan,
        d_flat: torch.Tensor,         # [Rp*Cp, Bp] padded field (d_pad reshaped)
        vertex_costs: torch.Tensor,   # [V]
        positions: torch.Tensor,      # [B, 3]
        orientations: torch.Tensor,   # [B, 4]
        states: ControllerState,
        *,
        tol: float = 1e-5,
        lane_map: torch.Tensor | None = None,
        timer=None,
    ) -> tuple[VelocityCommand, ControllerState]:
        """Batched control cycle on the banded solver's padded field: the
        direction rows come from pred_at_vertices at the tracked face's 3
        vertices per lane; no [B, V] pred map or vector field is built.
        `lane_map` maps robots to solver lanes (PlanResult.lane_map)."""
        with _stage(timer, "control"):
            mesh = self.mesh
            positions = positions.to(self.device, torch.float32)
            orientations = orientations.to(self.device, torch.float32)
            fix = tracking.locate_batch(
                mesh, self.grid, positions, states.current_face,
                max_dist=self.config.max_search_distance,
            )
            vids = mesh.faces[torch.clamp(fix.face, min=0)].long()   # [B, 3]
            preds = _bg.pred_at_vertices(
                kernel_plan, d_flat, vids, tol=tol, lane_map=lane_map
            )
            d = mesh.vertices[preds] - mesh.vertices[vids]
            unit = d / torch.clamp(geometry.norm(d)[..., None], min=1e-12)
            rows = torch.where((preds != vids)[..., None], unit, 0.0)  # [B, 3, 3]
            raw_dir = geometry.bary_interpolate(rows, fix.bary)
            return self._finish_velocity(fix, raw_dir, vertex_costs, orientations, states)

    def _finish_velocity(self, fix, raw_dir, vertex_costs, orientation, state):
        cfg = self.config
        robot_dir = geometry.direction_from_pose(orientation)
        mesh_dir = geometry.normalize(raw_dir)
        has_dir = geometry.norm(raw_dir) > 1e-9
        cost = tracking.cost_at(self.mesh, vertex_costs, fix.face, fix.bary)
        # the control-plane normal is the robot's own up axis
        # (mesh_controller.cpp:158)
        up = geometry.direction_from_pose(
            orientation,
            torch.tensor([0.0, 0.0, 1.0], dtype=orientation.dtype, device=orientation.device),
        )
        linear, angular, phi = naive_control(robot_dir, mesh_dir, up, cfg)
        linear = torch.clamp(linear * cfg.lin_vel_factor, max=cfg.max_lin_velocity)
        angular = torch.clamp(angular * cfg.ang_vel_factor, max=cfg.max_ang_velocity)
        outcome = torch.where(
            state.cancel,
            int(Outcome.CANCELED),
            torch.where(
                ~fix.found,
                int(Outcome.OUT_OF_MAP),
                torch.where(~has_dir, int(Outcome.FAILURE), int(Outcome.SUCCESS)),
            ),
        ).to(torch.int32)
        ok = outcome == int(Outcome.SUCCESS)
        cmd = VelocityCommand(
            linear=torch.where(ok, linear, 0.0),
            angular=torch.where(ok, angular, 0.0),
            outcome=outcome,
            cost=cost,
            heading_error=phi,
        )
        return cmd, dataclasses.replace(state, current_face=fix.face)
