"""Continuous Vector Field Planner (CVP) (port of
mesh_navigation_tpu/planners/cvp.py).

Seed the three vertices of each goal's containing face with their Euclidean
distances (cvp_mesh_planner.cpp:716-728) and propagate the wavefront with
the geometric unfolding update. Two routes:

- The gather planners, plan_one and plan_batch: the Jacobi eikonal solve
  (ops/eikonal.py) with predecessor and θ bookkeeping, the per-vertex
  vector field, then vector-field back-tracking from the start by
  `meshAhead` surface steps (cvp_mesh_planner.cpp:920-951).
- The scale path, plan_batch_banded: warm-start from one banded Dijkstra
  solve over the same side lengths (the reference takes graph distances as
  upper bounds of the triangle-interior ones; next to vertices over the
  cost limit they are not, ROADMAP queue C), fast-sweeping rounds of the
  eikonal pass kernel (ops/eikonal_gpu.py), then each path by lazy
  triangle-update descent from the start vertex. No [B, V] pred map, θ map
  or vector field is built; the field stays in the solver's padded layout.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mesh_navigation_torch.api.outcomes import Outcome
from mesh_navigation_torch.config import PlannerConfig
from mesh_navigation_torch.device import resolve_device
from mesh_navigation_torch.mesh import geometry, query
from mesh_navigation_torch.mesh.arrays import MeshArrays, host_array
from mesh_navigation_torch.ops import banded_gpu as _bg
from mesh_navigation_torch.control import tracking
from mesh_navigation_torch.ops import eikonal
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
        update: str = "unfolding",
        device=None,
    ):
        self.device = resolve_device(device)
        self.mesh = mesh.to(self.device)
        self.config = config
        self.grid = grid if grid is not None else query.build_grid(self.mesh)
        self.max_path_len = max_path_len
        self.update = update        # the gather planners' triangle update (eikonal._UPDATE_FNS)
        self._cancel = False
        self._dij_plan = None
        self._target_ok = None      # [V] bool: the vertices that take updates
        self._pos_normals = torch.cat([self.mesh.vertices, self.mesh.vertex_normals], dim=1)

    def cancel(self) -> bool:
        """MeshPlanner::cancel: raise the planner's cancel flag (planners/
        cvp.py:49-51; as there, no solve reads it)."""
        self._cancel = True
        return True

    def prepare_weights(self, vertex_costs: torch.Tensor, edge_cost_factor: float = 0.0):
        """CVP takes the combined edge weights as triangle side lengths
        (waveFrontPropagation passes mesh_map->edgeWeights(),
        cvp_mesh_planner.cpp:746)."""
        return sweeps.compute_edge_weights(
            self.mesh, vertex_costs.to(self.device, torch.float32), edge_cost_factor
        )

    def _goal_seeds(self, goals: torch.Tensor):
        """Containing faces of [B, 3] goals and their vertices' Euclidean
        distances (cvp_mesh_planner.cpp:674-728): (g_face [B], g_vids [B, 3],
        seed_d [B, 3], g_found [B])."""
        mesh = self.mesh
        g_face, _, _, g_found = query.containing_face_batch(mesh, self.grid, goals)
        g_vids = mesh.faces[torch.clamp(g_face, min=0)].long()
        seed_d = geometry.norm(mesh.vertices[g_vids] - goals[:, None, :])
        return g_face, g_vids, seed_d, g_found

    def plan_one(
        self,
        edge_weights: torch.Tensor,     # [E] side lengths
        vertex_costs: torch.Tensor,     # [V]
        start: torch.Tensor,            # [3]
        goal: torch.Tensor,             # [3]
        layer_vectors: torch.Tensor | None = None,   # [V, 3]
    ) -> PlanResult:
        """Single-goal CVP (planners/cvp.py:61-98): the gather eikonal solve
        from the goal face's vertices with the cost-limit skip, the vector
        field (seed vertices point straight at the goal, cvp:723), then
        back-tracking from the start, blending the layers' repulsive field
        in at each step. The result's leaves are unbatched (outcome [],
        path [L, 3], potential [V], vector_map [V, 3], pred [V]); `rounds`
        holds the solve's sweeps."""
        mesh, dev = self.mesh, self.device
        start = start.to(dev, torch.float32).reshape(1, 3)
        goal = goal.to(dev, torch.float32).reshape(1, 3)
        s_face, _, _, s_found = query.containing_face_batch(mesh, self.grid, start)
        g_face, g_vids, seed_d, g_found = self._goal_seeds(goal)
        seed = torch.full((mesh.num_vertices,), torch.inf, device=dev)
        seed[g_vids[0]] = seed_d[0]
        field = eikonal.eikonal_field(
            mesh, edge_weights, seed, update=self.update,
            target_mask=vertex_costs.to(dev) < self.config.cost_limit,
            max_sweeps=self.config.max_sweeps, block_sweeps=self.config.block_sweeps,
        )
        vector_map = eikonal.cvp_vector_map(mesh, field)
        vector_map[g_vids[0]] = geometry.normalize(goal - mesh.vertices[g_vids[0]])
        res = self._backtrack(vector_map[None], start, s_face, s_found, goal, g_face, g_found,
                              layer_vectors)
        return PlanResult(
            outcome=res.outcome[0], path_positions=res.path_positions[0],
            path_quats=res.path_quats[0], path_valid=res.path_valid[0], cost=res.cost[0],
            potential=field.dist, vector_map=vector_map, pred=field.pred,
            rounds=field.sweeps, converged=field.converged,
        )

    def plan_batch(
        self,
        edge_weights: torch.Tensor,     # [E]
        vertex_costs: torch.Tensor,     # [V]
        starts: torch.Tensor,           # [B, 3]
        goals: torch.Tensor,            # [B, 3]
    ) -> PlanResult:
        """Batched gather CVP (planners/cvp.py:162-210): one shared [V, B]
        solve (eikonal.batched_eikonal_field, blocks of at least 16 sweeps),
        then each lane's vector field and back-tracking. The full result:
        potential [B, V], vector_map [B, V, 3], pred [B, V]; `rounds` holds
        the sweeps."""
        mesh, dev = self.mesh, self.device
        starts = starts.to(dev, torch.float32)
        goals = goals.to(dev, torch.float32)
        B = goals.shape[0]
        lane = torch.arange(B, device=dev)[:, None]
        g_face, g_vids, seed_d, g_found = self._goal_seeds(goals)
        seeds = torch.full((B, mesh.num_vertices), torch.inf, device=dev)
        seeds[lane, g_vids] = seed_d
        field = eikonal.batched_eikonal_field(
            mesh, edge_weights, seeds, update=self.update,
            target_mask=vertex_costs.to(dev) < self.config.cost_limit,
            max_sweeps=self.config.max_sweeps, block_sweeps=max(self.config.block_sweeps, 16),
        )
        vector_map = eikonal.cvp_vector_map(mesh, field)
        vector_map[lane, g_vids] = geometry.normalize(goals[:, None, :] - mesh.vertices[g_vids])
        s_face, _, _, s_found = query.containing_face_batch(mesh, self.grid, starts)
        res = self._backtrack(vector_map, starts, s_face, s_found, goals, g_face, g_found, None)
        return dataclasses.replace(res, potential=field.dist, vector_map=vector_map,
                                   pred=field.pred, rounds=field.sweeps,
                                   converged=field.converged)

    def _backtrack(self, vector_map, starts, s_face, s_found, goals, g_face, g_found,
                   layer_vectors, *, chunk: int = 64) -> PlanResult:
        """Vector-field back-tracking of every lane from its start
        (cvp_mesh_planner.cpp:920-951; planners/cvp.py:100-160): up to
        max_path_len - 1 mesh_ahead steps of step_width, a lane ending where
        its squared distance to the goal is at most step_width (the
        reference compares distance2 with step_width as is, cvp:925), then
        the goal pose appended, entries past the end collapsed onto the
        goal, poses oriented by the face normals along the walked faces.
        Steps run in chunks of `chunk` with one host check of any lane
        alive before each; a lane that stopped keeps its position and face,
        so the steps skipped are those the reference repeats unchanged."""
        mesh, dev = self.mesh, self.device
        step = self.config.step_width
        B, n = starts.shape[0], self.max_path_len - 1
        pos, face, alive = starts, s_face, s_found & g_found
        path_pos = torch.empty((n, B, 3), device=dev)
        path_face = torch.empty((n, B), dtype=torch.int64, device=dev)
        path_alive = torch.zeros((n, B), dtype=torch.bool, device=dev)
        i = 0
        while i < n and (i % chunk or bool(alive.any())):
            path_pos[i], path_face[i], path_alive[i] = pos, face, alive
            done = torch.sum((pos - goals) ** 2, dim=-1) <= step
            new_pos, new_face, ok = tracking.mesh_ahead_batch(
                mesh, self.grid, vector_map, pos, face, step, layer_vectors=layer_vectors)
            alive = alive & ~done & ok
            pos = torch.where(alive[:, None], new_pos, pos)
            face = torch.where(alive, new_face, face)
            i += 1
        path_pos[i:], path_face[i:] = pos, face
        reached = torch.sum((pos - goals) ** 2, dim=-1) <= step
        valid = torch.cat([path_alive.T, reached[:, None]], dim=1)                 # [B, L]
        positions = torch.cat([path_pos.transpose(0, 1), goals[:, None, :]], dim=1)
        positions = torch.where(valid[..., None], positions, goals[:, None, :])
        faces = torch.cat([path_face.T, torch.clamp(g_face, min=0)[:, None]], dim=1)
        quats, cost = pose_chain(positions, torch.ones_like(valid),
                                 mesh.face_normals[torch.clamp(faces, min=0)])
        ok_ends = s_found & g_found
        outcome = torch.where(
            ~ok_ends,
            torch.where(~s_found, int(Outcome.INVALID_START), int(Outcome.INVALID_GOAL)),
            torch.where(reached, int(Outcome.SUCCESS), int(Outcome.NO_PATH_FOUND)),
        ).to(torch.int32)
        return PlanResult(outcome=outcome, path_positions=positions, path_quats=quats,
                          path_valid=valid, cost=torch.where(reached, cost, torch.inf))

    def banded_solve_inputs(self, goals: torch.Tensor, *, timer=None):
        """The banded path's eikonal seeds of [B, 3] goals and its warm
        start: (g_vids [B, 3] goal-face vertices, seed_d [B, 3] their
        distances, +inf where no face holds the goal, g_found [B], init
        [V, B] or None). init is the Dijkstra field of the warm plan of
        prepare_eikonal_plan from each goal face's first vertex plus that
        vertex's seed distance, +inf outside the target mask. `timer`
        records the goal and warm stages."""
        mesh, dev, warm_plan = self.mesh, self.device, self._dij_plan
        goals = goals.to(dev, torch.float32)
        B = goals.shape[0]
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
                Rd, Cd, V = warm_plan.n_rows, warm_plan.n_cols, mesh.num_vertices
                init = dres.d_pad[:Rd, :Cd, :B].reshape(Rd * Cd, B)[:V] + seed_d[:, 0][None, :]
                if self._target_ok is not None:
                    init = torch.where(self._target_ok[:, None], init, torch.inf)
                del dres
        return g_vids, seed_d, g_found, init

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
        self.drop_eikonal_plan()
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

    def drop_eikonal_plan(self) -> None:
        """Forget the warm plan and target mask of the last
        prepare_eikonal_plan (their costs are stale)."""
        self._dij_plan = None
        self._target_ok = None

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
        plan = kernel_plan
        mesh, dev = self.mesh, self.device
        starts = starts.to(dev, torch.float32)
        B = starts.shape[0]
        lane = torch.arange(B, device=dev)
        R, C, Cp = plan.n_rows, plan.n_cols, plan.n_cols_pad
        g_vids, seed_d, g_found, init = self.banded_solve_inputs(goals, timer=timer)
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
