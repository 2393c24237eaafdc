"""Vector-field-following controller, batched over robots (port of
mesh_navigation_tpu/control/controller.py).

Per control cycle: track each robot's face, sample the planner's direction
field at the barycentric position, and emit (linear, angular) velocities by
the naiveControl law (mesh_controller.cpp:225-242). The field is read from
a full result's [B, V, 3] vector map (or one plan's [V, 3] map for one
pose, the ExePath cycle) or its [B, V] predecessor map, or recovered on the
fly at the tracked face's three vertices from the solve's field:
predecessors of the banded Dijkstra field, or the winning triangle update
and its θ rotation on the CVP eikonal field. Also the goal check and a
closed-loop kinematic rollout of one robot.
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
from mesh_navigation_torch.ops import eikonal_gpu as _eg
from mesh_navigation_torch.ops import sweeps
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
    (mesh_controller.cpp:179-193). goal_pos [B, 3], goal_dir [B, 3] or [3];
    or goal_pos [3] for one robot, whose state has unbatched leaves."""
    shape = goal_pos.shape[:-1]
    dev = goal_pos.device
    goal_dir = torch.broadcast_to(goal_dir.to(dev, goal_pos.dtype), goal_pos.shape)
    return ControllerState(
        current_face=torch.full(shape, -1, dtype=torch.int64, device=dev),
        goal_pos=goal_pos,
        goal_dir=geometry.normalize(goal_dir),
        cancel=torch.zeros(shape, dtype=torch.bool, device=dev),
    )


def _quat_mul(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product, (x, y, z, w) convention (controller.py:316-328)."""
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    return torch.stack([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ], dim=-1)


def unicycle_step(position, orientation, linear, angular, dt: float):
    """Integrate one control cycle of the unicycle model: move along the
    pose's +x by linear·dt, turn about its up axis by angular·dt
    (controller.py:298-308). Returns (position, orientation), the latter
    not normalized, as the reference's rollout leaves it."""
    fwd = geometry.direction_from_pose(orientation)
    up = geometry.direction_from_pose(
        orientation, torch.tensor([0.0, 0.0, 1.0], dtype=orientation.dtype,
                                  device=orientation.device))
    half = (angular * dt * 0.5)[..., None]
    dq = torch.cat([up * torch.sin(half), torch.cos(half)], dim=-1)
    return position + fwd * linear[..., None] * dt, _quat_mul(dq, orientation)


def _map_leaves(fn, obj):
    """fn applied to every leaf of a ControllerState or VelocityCommand."""
    return dataclasses.replace(obj, **{f.name: fn(getattr(obj, f.name))
                                       for f in dataclasses.fields(obj)})


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

    def compute_velocity(
        self,
        vector_map: torch.Tensor,     # [B, V, 3] planner field (PlanResult.vector_map)
        vertex_costs: torch.Tensor,   # [V]
        positions: torch.Tensor,      # [B, 3]
        orientations: torch.Tensor,   # [B, 4]
        states: ControllerState,
        *,
        timer=None,
    ) -> tuple[VelocityCommand, ControllerState]:
        """One control cycle per robot on its own vector map
        (MeshController::computeVelocityCommands, mesh_controller.cpp:67-170;
        controller.py:95-111 batched over robots). One robot (the ExePath
        cycle): vector_map [V, 3], position [3], orientation [4] and a state
        with unbatched leaves, as the batch of one; the command's and the
        state's leaves come back unbatched."""
        if positions.dim() == 1:
            cmd, st = self.compute_velocity(
                vector_map[None], vertex_costs, positions[None], orientations[None],
                _map_leaves(lambda t: t[None], states), timer=timer)
            return _map_leaves(lambda t: t[0], cmd), _map_leaves(lambda t: t[0], st)
        with _stage(timer, "control"):
            positions = positions.to(self.device, torch.float32)
            orientations = orientations.to(self.device, torch.float32)
            fix = tracking.locate_batch(
                self.mesh, self.grid, positions, states.current_face,
                max_dist=self.config.max_search_distance,
            )
            raw_dir = tracking.direction_at(self.mesh, vector_map, fix.face, fix.bary)
            return self._finish_velocity(fix, raw_dir, vertex_costs, orientations, states)

    def compute_velocity_pred(
        self,
        pred: torch.Tensor,           # [B, V] predecessor map (PlanResult.pred)
        vertex_costs: torch.Tensor,   # [V]
        positions: torch.Tensor,      # [B, 3]
        orientations: torch.Tensor,   # [B, 4]
        states: ControllerState,
        *,
        timer=None,
    ) -> tuple[VelocityCommand, ControllerState]:
        """Control cycle sampling the direction field straight from the
        predecessor map at the tracked face's vertices (controller.py:113-136,
        batched): no [B, V, 3] field is read or built."""
        with _stage(timer, "control"):
            positions = positions.to(self.device, torch.float32)
            orientations = orientations.to(self.device, torch.float32)
            fix = tracking.locate_batch(
                self.mesh, self.grid, positions, states.current_face,
                max_dist=self.config.max_search_distance,
            )
            vids = self.mesh.faces[torch.clamp(fix.face, min=0)]
            rows = sweeps.vector_rows_from_predecessors(self.mesh, pred, vids)
            raw_dir = geometry.bary_interpolate(rows, fix.bary)
            return self._finish_velocity(fix, raw_dir, vertex_costs, orientations, states)

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

    def compute_velocity_cvp(
        self,
        kernel_plan: _eg.EikonalKernelPlan,
        side_lengths: torch.Tensor,   # [E] the CVP solve's edge weights
        d_flat: torch.Tensor,         # [R*Cp, Bp] eikonal field (d_pad reshaped)
        vertex_costs: torch.Tensor,   # [V]
        positions: torch.Tensor,      # [B, 3]
        orientations: torch.Tensor,   # [B, 4]
        states: ControllerState,
        *,
        tol: float = 1e-3,
        timer=None,
    ) -> tuple[VelocityCommand, ControllerState]:
        """Batched control cycle on the CVP eikonal field (controller.py:
        192-227): the direction rows are the winning triangle candidates'
        predecessor directions rotated by θ (cvp_rows_at_vertices) at the
        tracked face's 3 vertices per lane; no [B, V, 3] field is built.
        Robot b reads solver lane b."""
        with _stage(timer, "control"):
            mesh = self.mesh
            positions = positions.to(self.device, torch.float32)
            orientations = orientations.to(self.device, torch.float32)
            fix = tracking.locate_batch(
                mesh, self.grid, positions, states.current_face,
                max_dist=self.config.max_search_distance,
            )
            vids = mesh.faces[torch.clamp(fix.face, min=0)].long()   # [B, 3]
            rows = _eg.cvp_rows_at_vertices(
                kernel_plan, mesh, side_lengths.to(self.device), d_flat, vids, tol=tol
            )                                                         # [B, 3, 3]
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

    def is_goal_reached(self, position, orientation, state: ControllerState,
                        dist_tolerance: float, angle_tolerance: float) -> torch.Tensor:
        """Distance and heading tolerance check (mesh_controller.cpp:172-177),
        for one robot or a batch."""
        robot_dir = geometry.direction_from_pose(orientation.to(self.device, torch.float32))
        goal_distance = geometry.norm(state.goal_pos - position.to(self.device, torch.float32))
        ang = torch.arccos(torch.clamp(geometry.dot(state.goal_dir, robot_dir), -1.0, 1.0))
        return (goal_distance <= dist_tolerance) & (ang <= angle_tolerance)

    def rollout(self, vector_map, vertex_costs, position, orientation,
                state: ControllerState, num_steps: int = 128, dt: float = 0.05):
        """Closed-loop kinematic rollout of one robot (controller.py:281-313):
        num_steps control cycles on its [V, 3] vector map, each integrated
        by the unicycle model. Returns (positions [T, 3], the commands with
        [T] leaves, the final state)."""
        pos = position.to(self.device, torch.float32)
        quat = orientation.to(self.device, torch.float32)
        traj, cmds = [], []
        for _ in range(num_steps):
            cmd, state = self.compute_velocity(vector_map, vertex_costs, pos, quat, state)
            pos, quat = unicycle_step(pos, quat, cmd.linear, cmd.angular, dt)
            traj.append(pos)
            cmds.append(cmd)
        stacked = VelocityCommand(**{f.name: torch.stack([getattr(c, f.name) for c in cmds])
                                     for f in dataclasses.fields(VelocityCommand)})
        return torch.stack(traj), stacked, state
