"""Obstacle layer: live sensor point clouds -> lethal vertices (port of
mesh_navigation_tpu/layers/obstacle.py:29-130).

Parity with mesh_layers/src/obstacle_layer.cpp: range-filter the points
(214-227), cast every point along the `down_axis` (229-239), mark all three
vertices of faces hit within `robot_height` as cost inf + lethal (241-256),
and diff against the previous lethal set (258-274). The cast goes through
ops/raycast.py: the xy face bins for a vertical down axis, the 3-D grid's
DDA for any other where the state holds one, else the brute force.
"""

from __future__ import annotations

from typing import NamedTuple

import math

import torch

from mesh_navigation_torch.config import LayerConfig
from mesh_navigation_torch.layers.base import LayerOutput, register_layer, zero_vectors
from mesh_navigation_torch.mesh.arrays import MeshArrays
from mesh_navigation_torch.ops import raycast


class ObstacleParams(NamedTuple):
    """obstacle_layer.cpp:32-110 parameter defaults."""
    robot_height: float = 1.0
    min_range: float = 0.0
    max_range: float = 10.0
    down_axis: tuple[float, float, float] = (0.0, 0.0, -1.0)


def process_point_cloud(
    mesh: MeshArrays,
    points: torch.Tensor,       # [N, 3] in map frame (invalid rows may be nan)
    params: ObstacleParams,
    *,
    sensor_origin: torch.Tensor | None = None,
    face_grid: raycast.FaceGrid2D | None = None,
    face_grid3d: raycast.FaceGrid3D | None = None,
) -> torch.Tensor:
    """Returns the new lethal mask [V] bool (obstacle.py:38-90). Points are
    range-filtered around `sensor_origin` and cast along `down_axis`; faces
    hit within `robot_height` make their three vertices lethal. A vertical
    axis with a `face_grid` casts through the xy bins; any other axis
    walks `face_grid3d` far enough to cover robot_height (hits beyond it
    are dropped anyway); without a grid the cast is the brute force."""
    points = points.to(mesh.device, torch.float32)
    down = torch.tensor(params.down_axis, dtype=torch.float32, device=mesh.device)
    down = down / torch.clamp(torch.linalg.norm(down), min=1e-12)
    finite = torch.all(torch.isfinite(points), dim=-1)
    if sensor_origin is not None:
        rng = torch.linalg.norm(points - sensor_origin.to(points), dim=-1)
        finite = finite & (rng >= params.min_range) & (rng <= params.max_range)
    safe_points = torch.where(finite[:, None], points, 0.0)
    dirs = torch.broadcast_to(down, safe_points.shape)
    if face_grid is not None and tuple(params.down_axis[:2]) == (0.0, 0.0):
        t, face_id, hit = raycast.raycast_vertical(
            mesh, face_grid, safe_points, down=params.down_axis[2] < 0
        )
    elif face_grid3d is not None:
        n_steps = int(math.ceil(params.robot_height
                                / max(face_grid3d.cell_size_static, 1e-6))) + 2
        t, face_id, hit = raycast.raycast_grid(mesh, face_grid3d, safe_points, dirs,
                                               n_steps=n_steps)
    else:
        t, face_id, hit = raycast.raycast_bruteforce(mesh, safe_points, dirs)
    hit = hit & finite & (t <= params.robot_height)
    # scatter only the <= N hit faces' vertices (obstacle_layer.cpp:241-256)
    vids = mesh.faces.long()[torch.where(hit, face_id, 0)]          # [N, 3]
    count = torch.zeros(mesh.num_vertices, dtype=torch.int32, device=mesh.device)
    count.index_add_(0, vids.reshape(-1), hit.repeat_interleave(3).to(torch.int32))
    return count > 0


def lethal_diff(prev: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """Symmetric difference of lethal sets as a changed-vertex mask
    (obstacle_layer.cpp:258-274)."""
    return prev ^ new


@register_layer("obstacle")
def make_obstacle(cfg: LayerConfig):
    params = ObstacleParams(
        robot_height=cfg.param("robot_height", 1.0),
        min_range=cfg.param("min_range", 0.0),
        max_range=cfg.param("max_range", 10.0),
    )

    def fn(mesh: MeshArrays, inputs: dict, state) -> LayerOutput:
        # live state: the newest point cloud (state["obstacle:<name>:points"])
        # or the lethal mask it left (":lethal")
        key_pts = f"obstacle:{cfg.name}:points"
        key_lethal = f"obstacle:{cfg.name}:lethal"
        if key_pts in state:
            lethal = process_point_cloud(
                mesh, state[key_pts], params, face_grid=state.get("__face_grid__"),
                face_grid3d=state.get("clearance:grid3d") or state.get("__face_grid3d__"),
            )
            state[key_lethal] = lethal
        elif key_lethal in state:
            lethal = state[key_lethal]
        else:
            lethal = torch.zeros(mesh.num_vertices, dtype=torch.bool, device=mesh.device)
        costs = torch.where(lethal, torch.inf, 0.0).to(torch.float32)
        return LayerOutput(costs=costs, lethal=lethal, vectors=zero_vectors(mesh))

    def prepare(m: MeshArrays) -> dict:
        return {"__face_grid__": raycast.build_face_grid(m)}

    fn.prepare = prepare  # type: ignore[attr-defined]
    return fn
