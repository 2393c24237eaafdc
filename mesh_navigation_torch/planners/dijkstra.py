"""Dijkstra-parity planner (port of mesh_navigation_tpu/planners/dijkstra.py).

plan_one answers one GetPath: snap start and goal to vertices, the
goal-seeded Jacobi field (ops/sweeps.shortest_path_field), its vector map,
the predecessor walk and the pose chain. Four batch paths. The banded light path snaps starts and goals to
vertices, groups lanes by goal, solves the goal-seeded fields with the
banded kernels (converge="pred": the last certificate pass emits the int8
class table; on irregular plans a quiet-round solve and the residual class
table), walks each lane's predecessor chain from its start and builds the
pose chain; it gives no potential, predecessor map or vector field. The
banded full path (light=False) solves the same fields to a quiet round and
gives the full result: potential, the int32 predecessor map of the
class-pred kernel's id mode and the [B, V, 3] vector field the controller
samples. The structured path solves with the fused offset-shift sweeps
(ops/structured.py) on meshes without a banded plan and gives the same full
result. plan_batch takes any mesh (a scan in its native vertex order): the
hybrid ordered + Jacobi solve (ops/ordered.py) and the same full result.
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
from mesh_navigation_torch.ops import ordered as _ordered
from mesh_navigation_torch.ops import structured as _structured
from mesh_navigation_torch.ops import sweeps
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
        self._cancel = False
        # [V, 6] position + normal rows, gathered once per path step
        self._pos_normals = torch.cat(
            [self.mesh.vertices, self.mesh.vertex_normals], dim=1
        )
        # plan_batch's ordered rounds (dijkstra.py:43-54); with none, no
        # plan is built (the reference builds a dummy one)
        self.sweep_plan = (
            _ordered.build_sweep_plan(self.mesh, directions=config.sweep_directions)
            if config.method == "batched" and config.ordered_rounds > 0 else None
        )

    def cancel(self) -> bool:
        """MeshPlanner::cancel: raise the planner's cancel flag (planners/
        dijkstra.py:56-59; as there, no solve reads it)."""
        self._cancel = True
        return True

    def prepare_weights(self, vertex_costs: torch.Tensor, edge_cost_factor: float = 0.0):
        """[V, D] slot weights of a cost field on the planner's device: the
        MeshMap::computeEdgeWeights product (mesh_map.cpp:517-561) with the
        planner's cost limit."""
        costs = vertex_costs.to(self.device, torch.float32)
        ew = sweeps.compute_edge_weights(self.mesh, costs, edge_cost_factor)
        return sweeps.slot_weights(self.mesh, ew, costs, self.config.cost_limit)

    def plan_one(self, weights_vd: torch.Tensor, start: torch.Tensor,
                 goal: torch.Tensor) -> PlanResult:
        """One GetPath (dijkstra.py:68-108): the field seeded at the goal's
        nearest vertex, the walk from the start's. The result's leaves are
        unbatched (outcome [], path [L, 3], potential [V], vector_map
        [V, 3], pred [V]); `rounds` holds the sweeps."""
        mesh = self.mesh
        start_v = query.nearest_vertex(mesh, self.grid, start.to(self.device, torch.float32))[0]
        goal_v = query.nearest_vertex(mesh, self.grid, goal.to(self.device, torch.float32))[0]
        field = sweeps.shortest_path_field(
            mesh, weights_vd.to(self.device), goal_v,
            max_sweeps=self.config.max_sweeps, block_sweeps=self.config.block_sweeps,
        )
        path, valid = sweeps.extract_path(field.pred[None], start_v[None], goal_v[None],
                                          self.max_path_len)
        pn = self._pos_normals[path[0]]
        quats, cost = pose_chain(pn[:, :3], valid[0], pn[:, 3:])
        reached = torch.isfinite(field.dist[start_v])
        return PlanResult(
            outcome=torch.where(reached, int(Outcome.SUCCESS),
                                int(Outcome.NO_PATH_FOUND)).to(torch.int32),
            path_positions=pn[:, :3],
            path_quats=quats,
            path_valid=valid[0] & reached,
            cost=torch.where(reached, cost, torch.inf),
            potential=field.dist,
            vector_map=sweeps.vector_map_from_predecessors(mesh, field.pred),
            pred=field.pred,
            rounds=field.sweeps,
            converged=field.converged,
        )

    def plan_batch(self, weights_vd: torch.Tensor, starts: torch.Tensor,
                   goals: torch.Tensor, *, timer=None) -> PlanResult:
        """Batch planning on any mesh (dijkstra.py:110-156), the server's
        path where the mesh has neither a banded plan nor an offset plan
        covering more than half of its edges. method="batched": one hybrid
        solve for the whole batch (ops/ordered.batched_field_hybrid: the
        config's ordered_rounds, then Jacobi sweeps in blocks of
        max(block_sweeps, 16)), then the full result (_finish_batch). Any
        other method: each lane's plan_one result, stacked (the reference's
        vmap). `timer` records the snap, solve (the predecessors included),
        vector_map, extract and pose stages of the batched method."""
        weights_vd = weights_vd.to(self.device, torch.float32)
        starts = starts.to(self.device, torch.float32)
        goals = goals.to(self.device, torch.float32)
        if self.config.method != "batched":
            lanes = [self.plan_one(weights_vd, s, g) for s, g in zip(starts, goals)]
            stack = {f: torch.stack([getattr(r, f) for r in lanes]) for f in (
                "outcome", "path_positions", "path_quats", "path_valid", "cost",
                "potential", "vector_map", "pred")}
            return PlanResult(**stack, rounds=max(r.rounds for r in lanes),
                              converged=all(r.converged for r in lanes))
        with _stage(timer, "snap"):
            start_v = query.nearest_vertex_batch(self.mesh, self.grid, starts)[0]
            goal_v = query.nearest_vertex_batch(self.mesh, self.grid, goals)[0]
        with _stage(timer, "solve"):
            field = _ordered.batched_field_hybrid(
                self.mesh, weights_vd, self.sweep_plan, goal_v,
                ordered_rounds=self.config.ordered_rounds,
                block_sweeps=max(self.config.block_sweeps, 16),
                max_sweeps=self.config.max_sweeps,
            )
        return self._finish_batch(field.dist, field.pred, start_v, goal_v, rounds=field.rounds,
                                  converged=field.converged, timer=timer)

    def prepare_banded_plan(self, weights_vd, *, min_coverage: float = 0.9):
        """Banded kernel plan when the vertex order has band structure
        (x-major terrain grids, band-reordered irregular meshes) and its
        padded rows fit the pass kernel (banded_gpu.PASS_MAX_COLS columns,
        PASS_MAX_COLS_X2 where an extended lane reaches two rows), else
        None: the server then takes the structured tier. Rebuild when costs
        change."""
        try:
            plan = _bg.build_banded_kernel_plan(self.mesh, weights_vd, device=self.device)
        except ValueError:
            return None
        two_rows = _bg.pass_needs_two_rows(plan.xlanes_down + plan.xlanes_up)
        if plan.n_cols_pad > (_bg.PASS_MAX_COLS_X2 if two_rows else _bg.PASS_MAX_COLS):
            return None
        return plan if plan.coverage >= min_coverage else None

    def plan_batch_banded(
        self,
        kernel_plan: _bg.BandedKernelPlan,
        starts: torch.Tensor,    # [B, 3]
        goals: torch.Tensor,     # [B, 3]
        *,
        light: bool = True,
        atol: float = 1e-5,
        rtol: float = 1e-5,
        dtype=torch.float32,
        scan_steps: int = 0,
        timer=None,
    ) -> PlanResult:
        """Batch planning via banded GS fast sweeping.

        dtype=torch.bfloat16 opts into the approximate solve with the field
        stored in bfloat16 (banded_solve_padded; tolerance floors 1e-3 /
        4e-3); `scan_steps` cuts the lateral scan depth (0: full). Both
        paths take them as the reference's does (dijkstra.py:170-245). A
        bfloat16 solve ends on a quiet round, not on the class-pred
        certificate, and its predecessors are read at tol 1e-2 (light: the
        class table; full: the id table); the unpadded potential is f32.

        light=True: the result has no vector map, predecessor map or [B, V]
        potential; predecessors come from an int8 class table: the solve's
        own certificate table (converge="pred"), or on an irregular plan,
        after a quiet-round solve, predecessors_banded_classes_residual at
        tol max(1e-5, 3 rtol), whose class 9 the walk decodes through the
        residual jump table (reference dijkstra.py:239-277).
        `timer` (utils.timing.StageTimer) records the snap, solve, pred,
        extract and pose stages, and the solve's and the walk's counts
        (banded_solve_padded, extract_paths_cls).

        light=False: the full result (reference dijkstra.py:213-221,
        pallas_banded.py:2969-3012): the goal-seeded fields solved to a round
        with no supra-tolerance gain (no lane grouping), unpadded to [B, V],
        the int32 predecessor table of the class-pred kernel's id mode at
        tol max(atol, 1e-6), then _finish_batch (vector map, walk, pose
        chain); on an irregular plan the id table's residual post-pass
        follows. The reference recovers predecessors with its roll-based
        predecessors_banded, whose class order differs from the kernel's:
        ids differ only where two in-edges tie (ROADMAP queue C). `timer`
        records the snap, solve, pred, vector_map, extract and pose
        stages."""
        bf16 = dtype == torch.bfloat16
        if not light:
            return self._plan_batch_banded_full(kernel_plan, starts, goals, atol=atol,
                                                rtol=rtol, dtype=dtype, scan_steps=scan_steps,
                                                timer=timer)
        plan = kernel_plan
        if not (atol > 0 or rtol > 0 or bf16):
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
        tol = 1e-2 if bf16 else max(1e-5, 3.0 * rtol)
        use_pred_conv = not plan.n_residual and not bf16
        res = _bg.banded_solve_padded(
            plan, goal_s, max_rounds=max_rounds, atol=atol, rtol=rtol,
            converge="pred" if use_pred_conv else "round", timer=timer, dtype=dtype,
            scan_steps=scan_steps,
        )
        C, Cp = plan.n_cols, plan.n_cols_pad
        B = start_v.shape[0]
        cls, decode = res.cls, {}
        if plan.n_residual:
            with _stage(timer, "pred"):
                cls, choice = _bg.predecessors_banded_classes_residual(plan, res.d_pad, tol=tol)
            decode = dict(res_row_map=plan.res_row_map, res_jump=plan.res_jump,
                          res_choice=choice)
        elif not use_pred_conv:
            with _stage(timer, "pred"):
                cls = _bg.predecessors_banded_classes(plan, res.d_pad, tol=tol)
        with _stage(timer, "extract"):
            path, valid = _bg.extract_paths_cls(
                cls, start_s, goal_s, self.max_path_len, C, timer=timer, **decode
            )                                                   # [B, L] grouped
            del cls, decode
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

    def _plan_batch_banded_full(self, plan, starts, goals, *, atol, rtol, dtype, scan_steps,
                                timer):
        starts = starts.to(self.device, torch.float32)
        goals = goals.to(self.device, torch.float32)
        with _stage(timer, "snap"):
            start_v = query.nearest_vertex_batch(self.mesh, self.grid, starts)[0]
            goal_v = query.nearest_vertex_batch(self.mesh, self.grid, goals)[0]
        max_rounds = max(self.config.max_sweeps // 2, 64)
        res = _bg.banded_solve_padded(
            plan, goal_v, max_rounds=max_rounds, atol=atol, rtol=rtol, converge="round",
            timer=timer, dtype=dtype, scan_steps=scan_steps,
        )
        R, C, V, B = plan.n_rows, plan.n_cols, plan.num_vertices, start_v.shape[0]
        # pallas_banded.py:3007: a bfloat16 field's predecessors at tol 1e-2
        pred_tol = 1e-2 if dtype == torch.bfloat16 else max(atol, 1e-6)
        with _stage(timer, "pred"):
            dist = res.d_pad[:R, :C, :B].reshape(R * C, B)[:V].T.to(torch.float32)   # [B, V]
            dist = dist.contiguous()
            ids = _bg.predecessors_banded_ids(plan, res.d_pad, tol=pred_tol)
            pred = ids[:, :B].T.contiguous()
            del ids
        return self._finish_batch(dist, pred, start_v, goal_v, rounds=res.rounds,
                                  converged=res.converged, timer=timer)

    def prepare_offset_plan(self, weights_vd) -> _structured.OffsetPlan:
        """Host-side offset classification for the structured solver, on
        the planner's device. Rebuild when the mesh changes; a cost change
        needs only structured.refresh_offset_planes."""
        return _structured.build_offset_plan(self.mesh, weights_vd, device=self.device)

    def plan_batch_structured(
        self,
        weights_vd: torch.Tensor,               # [V, D] slot weights
        offset_plan: _structured.OffsetPlan,
        starts: torch.Tensor,                   # [B, 3]
        goals: torch.Tensor,                    # [B, 3]
        *,
        timer=None,
    ) -> PlanResult:
        """Batch planning with the fused offset-shift sweeps
        (dijkstra.py:321-341): snap, solve the goal-seeded fields, then the
        full result (_finish_batch). `timer` records the snap, solve,
        solve_check, pred, vector_map, extract and pose stages."""
        weights_vd = weights_vd.to(self.device, torch.float32)
        starts = starts.to(self.device, torch.float32)
        goals = goals.to(self.device, torch.float32)
        with _stage(timer, "snap"):
            start_v = query.nearest_vertex_batch(self.mesh, self.grid, starts)[0]
            goal_v = query.nearest_vertex_batch(self.mesh, self.grid, goals)[0]
        field = _structured.batched_field_structured(
            self.mesh, weights_vd, offset_plan, goal_v,
            block_sweeps=max(self.config.block_sweeps, 16),
            max_sweeps=self.config.max_sweeps, timer=timer,
        )
        return self._finish_batch(field.dist, field.pred, start_v, goal_v,
                                  rounds=field.sweeps, converged=field.converged, timer=timer)

    def _finish_batch(self, dist, pred, start_v, goal_v, *, rounds: int, converged: bool,
                      timer=None) -> PlanResult:
        """The full plan result of a batch of fields (dijkstra.py:137-156):
        vector map, predecessor walk and pose chain; outcome NO_PATH_FOUND
        where the start is unreached."""
        with _stage(timer, "vector_map"):
            vector_map = sweeps.vector_map_from_predecessors(self.mesh, pred)
        with _stage(timer, "extract"):
            path, valid = sweeps.extract_path(pred, start_v, goal_v, self.max_path_len)
        with _stage(timer, "pose"):
            pn = self._pos_normals[path]
            positions = pn[..., :3]
            quats, cost = pose_chain(positions, valid, pn[..., 3:])
            lanes = torch.arange(start_v.shape[0], device=self.device)
            reached = torch.isfinite(dist[lanes, start_v.long()])
            outcome = torch.where(
                reached, int(Outcome.SUCCESS), int(Outcome.NO_PATH_FOUND)
            ).to(torch.int32)
            return PlanResult(
                outcome=outcome,
                path_positions=positions,
                path_quats=quats,
                path_valid=valid & reached[:, None],
                cost=torch.where(reached, cost, torch.inf),
                potential=dist,
                vector_map=vector_map,
                pred=pred,
                rounds=rounds,
                converged=converged,
            )


def potential_lanes(
    plan: _bg.BandedKernelPlan, d_pad: torch.Tensor, lane_map: torch.Tensor,
    robots,
) -> np.ndarray:
    """[len(robots), V] potential of the given robots, read from the padded
    field through lane_map — built only for the lanes asked for."""
    R, C, V = plan.n_rows, plan.n_cols, plan.num_vertices
    cols = lane_map[torch.as_tensor(robots, device=lane_map.device)]
    sub = d_pad[:R, :C, :][..., cols]                       # [R, C, k]
    return sub.reshape(R * C, -1)[:V].T.float().cpu().numpy()
