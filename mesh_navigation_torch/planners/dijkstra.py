"""Dijkstra-parity batched planner on the banded solve (port of the light
path of mesh_navigation_tpu/planners/dijkstra.py:158-312).

Snap starts and goals to vertices, group lanes by goal, solve the batch of
goal-seeded fields with the banded kernels (converge="pred": the last
certificate pass emits the int8 class table), walk each lane's predecessor
chain from its start, and build the pose chain.
"""

from __future__ import annotations

import numpy as np
import torch

from mesh_navigation_torch.api.outcomes import Outcome
from mesh_navigation_torch.config import PlannerConfig
from mesh_navigation_torch.device import resolve_device
from mesh_navigation_torch.mesh import query
from mesh_navigation_torch.mesh.arrays import MeshArrays
from mesh_navigation_torch.ops import banded_gpu as _bg
from mesh_navigation_torch.planners.common import PlanResult, pose_chain
from mesh_navigation_torch.utils.timing import stage as _stage


class DijkstraPlanner:
    """MeshPlanner-shaped facade (mbf_mesh_core/mesh_planner.h:50-96) holding
    the mesh and snap grid on one device (default: the card)."""

    def __init__(
        self,
        mesh: MeshArrays,
        config: PlannerConfig = PlannerConfig(),
        *,
        grid: query.SpatialGrid | None = None,
        max_path_len: int = 1024,
        device=None,
    ):
        self.device = resolve_device(device)
        self.mesh = mesh.to(self.device)
        self.config = config
        self.grid = grid if grid is not None else query.build_grid(self.mesh)
        self.max_path_len = max_path_len
        # [V, 6] position + normal rows, gathered once per path step
        self._pos_normals = torch.cat(
            [self.mesh.vertices, self.mesh.vertex_normals], dim=1
        )

    def prepare_banded_plan(self, weights_vd, *, min_coverage: float = 0.9):
        """Banded kernel plan when the vertex order has band structure
        (x-major terrain grids), else None. Rebuild when costs change."""
        try:
            plan = _bg.build_banded_kernel_plan(self.mesh, weights_vd, device=self.device)
        except ValueError:
            return None
        return plan if plan.coverage >= min_coverage else None

    def plan_batch_banded(
        self,
        kernel_plan: _bg.BandedKernelPlan,
        starts: torch.Tensor,    # [B, 3]
        goals: torch.Tensor,     # [B, 3]
        *,
        atol: float = 1e-5,
        rtol: float = 1e-5,
        timer=None,
    ) -> PlanResult:
        """Batch planning via banded GS fast sweeping, light path: no vector
        field and no [V, B] potential; predecessors come from the solve's
        int8 class table. `timer` (utils.timing.StageTimer) records the
        snap, solve, pred, extract and pose stages."""
        plan = kernel_plan
        if plan.n_residual:
            raise NotImplementedError("residual (irregular) plans")
        if not (atol > 0 or rtol > 0):
            raise ValueError("the banded light path needs a positive tolerance")
        starts = starts.to(self.device, torch.float32)
        goals = goals.to(self.device, torch.float32)
        with _stage(timer, "snap"):
            start_v = query.nearest_vertex_batch(self.mesh, self.grid, starts)[0]
            goal_v = query.nearest_vertex_batch(self.mesh, self.grid, goals)[0]
            order, inv = _bg.group_lanes(goal_v, self.mesh.num_vertices)
            goal_s = goal_v[order]
            start_s = start_v[order]
        max_rounds = max(self.config.max_sweeps // 2, 64)
        res = _bg.banded_solve_padded(
            plan, goal_s, max_rounds=max_rounds, atol=atol, rtol=rtol,
            converge="pred", timer=timer,
        )
        C, Cp = plan.n_cols, plan.n_cols_pad
        B = start_v.shape[0]
        with _stage(timer, "extract"):
            path, valid = _bg.extract_paths_cls(
                res.cls, start_s, goal_s, self.max_path_len, C
            )                                                   # [B, L] grouped
        with _stage(timer, "pose"):
            pn = self._pos_normals[path]
            positions = pn[..., :3]
            quats, cost = pose_chain(positions, valid, pn[..., 3:])
            lanes = torch.arange(B, device=self.device)
            reached = torch.isfinite(
                res.d_pad.reshape(-1, res.d_pad.shape[-1])[
                    (start_s // C) * Cp + start_s % C, lanes
                ]
            )
            outcome = torch.where(
                reached, int(Outcome.SUCCESS), int(Outcome.NO_PATH_FOUND)
            ).to(torch.int32)
            result = PlanResult(
                outcome=outcome[inv],
                path_positions=positions[inv],
                path_quats=quats[inv],
                path_valid=(valid & reached[:, None])[inv],
                cost=torch.where(reached, cost, torch.inf)[inv],
                lane_map=inv,
                d_pad=res.d_pad,
                rounds=res.rounds,
                converged=res.converged,
            )
        return result


def potential_lanes(
    plan: _bg.BandedKernelPlan, d_pad: torch.Tensor, lane_map: torch.Tensor,
    robots,
) -> np.ndarray:
    """[len(robots), V] potential of the given robots, read from the padded
    field through lane_map — built only for the lanes asked for."""
    R, C, V = plan.n_rows, plan.n_cols, plan.num_vertices
    cols = lane_map[torch.as_tensor(robots, device=lane_map.device)]
    sub = d_pad[:R, :C, :][..., cols]                       # [R, C, k]
    return sub.reshape(R * C, -1)[:V].T.cpu().numpy()
