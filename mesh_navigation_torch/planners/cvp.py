"""Continuous Vector Field Planner (CVP) at scale (port of the banded path
of mesh_navigation_tpu/planners/cvp.py:30-59, :215-396).

Seed the three vertices of each goal's containing face with their Euclidean
distances (cvp_mesh_planner.cpp:716-728), warm-start from one banded
Dijkstra solve over the same side lengths (the reference takes graph
distances as upper bounds of the triangle-interior ones; next to vertices
over the cost limit they are not, ROADMAP queue C), propagate the wavefront with the
geometric unfolding update by fast-sweeping rounds (ops/eikonal_gpu.py),
then walk each path by lazy triangle-update descent from the start vertex
and build its pose chain. No [B, V] pred map, θ map or vector field is
built; the field stays in the solver's padded layout.

The gather planners (plan_one, plan_batch with vector-field back-tracking)
are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from mesh_navigation_torch.api.outcomes import Outcome
from mesh_navigation_torch.config import PlannerConfig
from mesh_navigation_torch.device import resolve_device
from mesh_navigation_torch.mesh import geometry, query
from mesh_navigation_torch.mesh.arrays import MeshArrays, host_array
from mesh_navigation_torch.ops import banded_gpu as _bg
from mesh_navigation_torch.ops import eikonal_gpu as _eg
from mesh_navigation_torch.ops import sweeps
from mesh_navigation_torch.planners.common import PlanResult, pose_chain
from mesh_navigation_torch.utils.timing import stage as _stage


class CVPPlanner:
    """MeshPlanner-shaped facade running the CVP wavefront, holding the mesh
    and snap grid on one device (default: the card)."""

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
        self._dij_plan = None
        self._target_ok = None      # [V] bool: the vertices that take updates
        self._pos_normals = torch.cat([self.mesh.vertices, self.mesh.vertex_normals], dim=1)

    def prepare_weights(self, vertex_costs: torch.Tensor, edge_cost_factor: float = 0.0):
        """CVP takes the combined edge weights as triangle side lengths
        (waveFrontPropagation passes mesh_map->edgeWeights(),
        cvp_mesh_planner.cpp:746)."""
        return sweeps.compute_edge_weights(
            self.mesh, vertex_costs.to(self.device, torch.float32), edge_cost_factor
        )

    def prepare_eikonal_plan(self, side_lengths_np, vertex_costs_np=None, *,
                             warm_start: bool = True):
        """Banded eikonal plan for band-ordered meshes (None otherwise),
        reused across solves. `vertex_costs_np` applies the cost-limit skip
        on free vertices (cvp_mesh_planner.cpp:802-851) at build time and,
        with `warm_start`, builds the banded Dijkstra plan of the warm start
        over the same side lengths with the CVP '>=' skip on both endpoints
        (cvp:757, 802-851): a more restrictive graph only raises the warm
        bound, never breaks it."""
        try:
            plan = _eg.build_eikonal_kernel_plan(self.mesh, side_lengths_np, device=self.device)
        except ValueError:
            return None
        self._dij_plan = None
        self._target_ok = None
        if vertex_costs_np is not None:
            costs = np.asarray(vertex_costs_np, np.float32)
            ok = costs < self.config.cost_limit
            plan = _eg.apply_target_mask(plan, ok)
            self._target_ok = torch.from_numpy(ok).to(self.device)
            if warm_start:
                ew = np.asarray(side_lengths_np, np.float32)
                adj_v = host_array(self.mesh, "adj_vertex")
                adj_m = host_array(self.mesh, "adj_mask")
                blocked = ~ok | host_array(self.mesh, "invalid").astype(bool)
                usable = adj_m & ~blocked[adj_v] & ~blocked[:, None]
                W = np.where(usable, ew[host_array(self.mesh, "adj_edge")], np.inf)
                try:
                    self._dij_plan = _bg.build_banded_kernel_plan(
                        self.mesh, W.astype(np.float32), device=self.device)
                except ValueError:
                    self._dij_plan = None
                if self._dij_plan is not None and self._dij_plan.n_cols_pad > _bg.PASS_MAX_COLS:
                    self._dij_plan = None   # wider than the pass kernel's rows: no warm start
        return plan

    def plan_batch_banded(
        self,
        edge_weights: torch.Tensor,        # [E] side lengths
        kernel_plan: _eg.EikonalKernelPlan,
        starts: torch.Tensor,              # [B, 3]
        goals: torch.Tensor,               # [B, 3]
        atol: float = 1e-4,
        rtol: float = 1e-3,
        *,
        timer=None,
    ) -> PlanResult:
        """Batched CVP at scale, warm-started from the Dijkstra plan of
        prepare_eikonal_plan where it built one. The eikonal solve
        alternates the two diagonal ordering pairs (orderings=2) at rtol
        1e-3: on long wavefronts
        sub-tolerance gains compound over the rounds, and rtol 2e-3 left
        far-field labels above the 1% oracle gate in the reference's runs
        (planners/cvp.py:352-356). `cost` is the walked pose-chain cost.
        Lanes are in robot order (lane_map is the identity). `timer` records
        the goal, warm, eikonal, descent and pose stages."""
        plan, warm_plan = kernel_plan, self._dij_plan
        mesh, dev = self.mesh, self.device
        starts = starts.to(dev, torch.float32)
        goals = goals.to(dev, torch.float32)
        B = starts.shape[0]
        lane = torch.arange(B, device=dev)
        R, C, Cp = plan.n_rows, plan.n_cols, plan.n_cols_pad
        with _stage(timer, "goal"):
            g_face, _, _, g_found = query.containing_face_batch(mesh, self.grid, goals)
            g_vids = mesh.faces[torch.clamp(g_face, min=0)].long()            # [B, 3]
            seed_d = geometry.norm(mesh.vertices[g_vids] - goals[:, None, :])
            seed_d = torch.where(g_found[:, None], seed_d, torch.inf)
        init = None
        if warm_plan is not None:
            with _stage(timer, "warm"):
                dres = _bg.banded_solve_padded(warm_plan, g_vids[:, 0], max_rounds=64,
                                               atol=1e-4, rtol=2e-3)
                Rd, Cd, V = warm_plan.n_rows, warm_plan.n_cols, plan.num_vertices
                init = dres.d_pad[:Rd, :Cd, :B].reshape(Rd * Cd, B)[:V] + seed_d[:, 0][None, :]
                if self._target_ok is not None:
                    init = torch.where(self._target_ok[:, None], init, torch.inf)
                del dres
        res = _eg.eikonal_solve_padded(plan, g_vids, seed_d, atol=atol, rtol=rtol,
                                       init_vb=init, orderings=2, timer=timer)
        del init
        d_flat = res.d_pad.view(R * Cp, -1)
        with _stage(timer, "descent"):
            start_v = query.nearest_vertex_batch(mesh, self.grid, starts)[0]
            path, valid = _eg.cvp_descend_paths(
                plan, mesh, edge_weights.to(dev), d_flat, start_v, g_vids,
                self.max_path_len, tol=5e-3,
            )
        with _stage(timer, "pose"):
            pn = self._pos_normals[path]
            positions = pn[..., :3]
            quats, cost = pose_chain(positions, valid, pn[..., 3:])
            reached = torch.isfinite(d_flat[(start_v // C) * Cp + start_v % C, lane]) & g_found
            outcome = torch.where(
                ~g_found, int(Outcome.INVALID_GOAL),
                torch.where(reached, int(Outcome.SUCCESS), int(Outcome.NO_PATH_FOUND)),
            ).to(torch.int32)
            return PlanResult(
                outcome=outcome,
                path_positions=positions,
                path_quats=quats,
                path_valid=valid & reached[:, None],
                cost=torch.where(reached, cost, torch.inf),
                lane_map=lane,
                d_pad=res.d_pad,
                rounds=res.rounds,
                converged=res.converged,
            )
