"""Recovery behaviors, the concrete MeshRecovery plugins (port of
mesh_navigation_tpu/control/recovery.py).

The reference defines the MeshRecovery contract
(mbf_mesh_core/mesh_recovery.h:54-93) but ships no concrete plugin. These
are the two behaviors MBF deployments pair with it:

- `clear_layers`: drop the dynamic obstacle state and re-evaluate the cost
  DAG (MeshNavServer.recovery("clear"));
- `rotate_in_place`: the command sequence that spins the robot to
  re-acquire the vector field after tracking loss.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mesh_navigation_torch.api.outcomes import Outcome
from mesh_navigation_torch.control.controller import _quat_mul
from mesh_navigation_torch.mesh import geometry


class RotateRecovery(NamedTuple):
    """Parameters of the rotate-in-place behavior."""
    angular_velocity: float = 0.5            # rad/s command magnitude
    target_angle: float = 2.0 * 3.14159265   # a full turn by default
    dt: float = 0.05


def rotate_in_place(params: RotateRecovery, orientation: torch.Tensor):
    """The (linear, angular) commands of the rotation and the heading
    quaternion after each step, about the pose's own up axis. Returns
    (linear [T], angular [T], quats [T, 4]) with T = target_angle /
    (angular_velocity · dt) steps (at least 1); a caller runs them at its
    control rate and may stop once the controller re-acquires the field."""
    steps = max(1, int(params.target_angle / (params.angular_velocity * params.dt)))
    dev = orientation.device
    linear = torch.zeros(steps, dtype=torch.float32, device=dev)
    angular = torch.full((steps,), params.angular_velocity, dtype=torch.float32, device=dev)
    up = geometry.direction_from_pose(
        orientation, torch.tensor([0.0, 0.0, 1.0], dtype=orientation.dtype, device=dev))
    half = torch.tensor(params.angular_velocity * params.dt * 0.5, dtype=orientation.dtype,
                        device=dev)
    dq = torch.cat([up * torch.sin(half), torch.cos(half)[None]])
    quats, q = [], orientation
    for _ in range(steps):
        q = geometry.normalize(_quat_mul(dq, q))
        quats.append(q)
    return linear, angular, torch.stack(quats)


def clear_layers(server) -> Outcome:
    """Costmap-clearing recovery: reset the dynamic layer state and re-run
    the DAG (MeshNavServer.clear_mesh)."""
    return Outcome.SUCCESS if server.clear_mesh() else Outcome.FAILURE
