"""Plan results and pose chains (port of mesh_navigation_tpu/planners/common.py)."""

from __future__ import annotations

import dataclasses

import torch

from mesh_navigation_torch.mesh import geometry


@dataclasses.dataclass(frozen=True)
class PlanResult:
    """A batch of planning solves — the GetPath result surface
    (mbf_mesh_core/mesh_planner.h:71-84), in robot order.

    The banded light path keeps the field in the solver's padded,
    goal-grouped layout: `d_pad` [Rp, Cp, Bp] and `lane_map` (solver lane of
    robot b). A [B, V] potential is never built on it (4 GB at 1M x 1024);
    take the lanes you need with planners.dijkstra.potential_lanes. The
    banded full path and the structured path give the full result instead: `potential`, `pred` and
    the `vector_map` the controller samples, in robot order. The single-goal
    planners (plan_one) give one plan's result with unbatched leaves
    (outcome [], path [L, 3], potential [V], vector_map [V, 3], pred [V]).
    `rounds` counts the solve's rounds (sweeps on the structured path and
    the gather solves)."""
    outcome: torch.Tensor         # [B] i32 Outcome code
    path_positions: torch.Tensor  # [B, L, 3] f32
    path_quats: torch.Tensor      # [B, L, 4] f32 (x, y, z, w)
    path_valid: torch.Tensor      # [B, L] bool
    cost: torch.Tensor            # [B] f32 summed segment lengths
    lane_map: torch.Tensor | None = None     # [B] i64 solver lane of robot b
    d_pad: torch.Tensor | None = None        # [Rp, Cp, Bp] f32 converged padded field
    potential: torch.Tensor | None = None    # [B, V] f32
    vector_map: torch.Tensor | None = None   # [B, V, 3] f32
    pred: torch.Tensor | None = None         # [B, V] i32
    rounds: int = 0
    converged: bool = True


def pose_chain(
    positions: torch.Tensor,   # [..., L, 3]
    valid: torch.Tensor,       # [..., L]
    normals: torch.Tensor,     # [..., L, 3]
) -> tuple[torch.Tensor, torch.Tensor]:
    """Orient each pose toward the next position with the local normal as
    the up axis (util.cpp:286-298); the last valid pose keeps the previous
    direction. Returns (quats [..., L, 4], cost [...])."""
    nxt = torch.roll(positions, -1, dims=-2)
    seg = nxt - positions
    seg_len = torch.linalg.norm(seg, dim=-1)
    pair_valid = valid & torch.roll(valid, -1, dims=-1)
    pair_valid[..., -1] = False
    safe_dir = torch.where(pair_valid[..., None], seg, torch.roll(seg, 1, dims=-2))
    fallback = torch.tensor([1.0, 0.0, 0.0], dtype=seg.dtype, device=seg.device)
    safe_dir = torch.where(
        torch.linalg.norm(safe_dir, dim=-1, keepdim=True) > 1e-9, safe_dir, fallback
    )
    quats = geometry.pose_from_direction(positions, safe_dir, normals)
    cost = torch.sum(torch.where(pair_valid, seg_len, 0.0), dim=-1)
    return quats, cost
