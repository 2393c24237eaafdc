"""MeshNav navigation facade, Dijkstra kind (port of the map plumbing, the
batch GetPath and the live-replan step of
mesh_navigation_tpu/api/server.py:47-305).

One shared map (mesh + layer DAG + combined costs + a solver plan: banded
where the vertex order has band structure, else offset-classed) with the
Dijkstra planner and the controller beside it. What is ported:

  update_point_cloud(layer, points)  -> obstacle sensor update, layer cascade,
                                        plan refresh on the device
  get_path_batch(starts, goals)      -> PlanResult (batch GetPath)
  make_replan_step(layer)            -> step(points, prev_costs, d_prev, seeds)
                                        -> (costs, d_pad, rounds): the live-replan
                                        cascade with the warm incremental solve

The single-plan GetPath, ExePath, recovery and the CVP planner kind are not
ported yet.
"""

from __future__ import annotations

import torch

from mesh_navigation_torch import layers as _layers
from mesh_navigation_torch.config import NavConfig
from mesh_navigation_torch.control.controller import MeshController
from mesh_navigation_torch.device import resolve_device
from mesh_navigation_torch.mesh import query
from mesh_navigation_torch.mesh.arrays import MeshArrays
from mesh_navigation_torch.ops import banded_gpu as _bg
from mesh_navigation_torch.ops import structured as _structured
from mesh_navigation_torch.ops import sweeps
from mesh_navigation_torch.planners.common import PlanResult
from mesh_navigation_torch.planners.dijkstra import DijkstraPlanner
from mesh_navigation_torch.utils.timing import stage as _stage

# the replan step's solve: the live-replan tolerance and round cap
# (mesh_navigation_tpu/api/server.py:268-273)
REPLAN_ATOL, REPLAN_RTOL, REPLAN_MAX_ROUNDS = 1e-4, 2e-3, 64


class MeshNavServer:
    """One shared map + the Dijkstra planner and the controller, on one
    device (default: the card). `grid` may pass in a snap grid already built
    for this mesh."""

    def __init__(
        self,
        mesh: MeshArrays,
        config: NavConfig = NavConfig(),
        *,
        planner_kind: str = "dijkstra",
        max_path_len: int = 1024,
        grid: query.SpatialGrid | None = None,
        device=None,
    ):
        if planner_kind != "dijkstra":
            raise NotImplementedError(f"planner kind {planner_kind!r} (only 'dijkstra' is ported)")
        self.device = resolve_device(device)
        self.mesh = mesh.to(self.device)
        self.config = config
        self.grid = grid if grid is not None else query.build_grid(self.mesh)
        self.stack = (
            _layers.LayerStack.from_configs(config.layers, config.mesh_map.default_layer or None)
            if config.layers else None
        )
        self.layer_state: dict = self.stack.prepare(self.mesh) if self.stack else {}
        self.planner_kind = planner_kind
        self.planner = DijkstraPlanner(
            self.mesh, config.planner, grid=self.grid, max_path_len=max_path_len,
            device=self.device,
        )
        self.controller = MeshController(
            self.mesh, config.controller, grid=self.grid, device=self.device
        )
        self.banded_plan: _bg.BandedKernelPlan | None = None
        self.offset_plan: _structured.OffsetPlan | None = None
        self.slot_weights: torch.Tensor | None = None
        self._refresh_costs()

    # ------------------------------------------------------------------
    # map / layer plumbing (MeshMap::readMap tail, mesh_map.cpp:434-452)
    # ------------------------------------------------------------------
    def _refresh_costs(self, *, structural: bool = True) -> None:
        """Layer outputs -> combined costs -> solver plan. structural=True
        (and whenever there is no plan yet) builds the plan on the host from
        the slot-weight table: the banded plan, or where the mesh has none
        the offset plan (server.py:134-143). structural=False (the sensor hot
        path) re-derives only the weights, on the device: the banded planes
        straight from the costs, or the [V, D] slot weights and the offset
        planes from them (:144-159). The slot weights are kept only for the
        structured path, whose predecessor recovery reads them; the edge
        weights and the layers' vector field are not kept."""
        if self.stack is not None:
            self.layer_outputs, self.vertex_costs = self.stack.compute(self.mesh, self.layer_state)
        else:
            self.layer_outputs = {}
            self.vertex_costs = torch.zeros(self.mesh.num_vertices, dtype=torch.float32,
                                            device=self.device)
        factor = self.config.mesh_map.edge_cost_factor
        cost_limit = self.config.planner.cost_limit
        if structural or (self.banded_plan is None and self.offset_plan is None):
            W = sweeps.slot_weights_np(
                self.mesh, self.vertex_costs.cpu().numpy(), cost_limit=cost_limit,
                edge_cost_factor=factor,
            )
            self.banded_plan = self.planner.prepare_banded_plan(W)
            # the offset plan is the banded plan's fallback: at 1M each host
            # classification costs seconds, so it is built only when needed
            self.offset_plan = None
            self.slot_weights = None
            if self.banded_plan is None:
                self.offset_plan = self.planner.prepare_offset_plan(W)
                self.slot_weights = torch.from_numpy(W).to(self.device)
        elif self.banded_plan is not None:
            # gather-free: planes straight from the cost field
            self.banded_plan = _bg.refresh_banded_planes_from_costs(
                self.banded_plan, self.vertex_costs,
                edge_cost_factor=factor, cost_limit=cost_limit,
            )
        else:
            edge_weights = sweeps.compute_edge_weights(self.mesh, self.vertex_costs, factor)
            self.slot_weights = sweeps.slot_weights(
                self.mesh, edge_weights, self.vertex_costs, cost_limit
            )
            self.offset_plan = _structured.refresh_offset_planes(
                self.offset_plan, self.slot_weights
            )

    def update_point_cloud(self, layer_name: str, points: torch.Tensor) -> None:
        """Obstacle-layer sensor update -> layer cascade re-evaluation (the
        §3.5 change path); the solver plan is refreshed on the device."""
        key = f"obstacle:{layer_name}:points"
        self.layer_state[key] = points
        self._refresh_costs(structural=False)
        self.layer_state.pop(key, None)

    def get_path_batch(self, starts: torch.Tensor, goals: torch.Tensor, *,
                       timer=None) -> PlanResult:
        """Batch GetPath (server.py:295-305): the banded light path where the
        mesh has a banded plan (its result has no vector map, predecessor map
        or [B, V] potential), else the structured path where the offset
        classes cover more than half of the edges (the full result)."""
        if self.banded_plan is not None:
            return self.planner.plan_batch_banded(self.banded_plan, starts, goals, timer=timer)
        if self.offset_plan is not None and self.offset_plan.coverage > 0.5:
            return self.planner.plan_batch_structured(
                self.slot_weights, self.offset_plan, starts, goals, timer=timer
            )
        raise NotImplementedError(
            "plan_batch, the hybrid gather solve for meshes with neither a banded plan "
            "nor offset coverage above 0.5"
        )

    def make_replan_step(self, layer_name: str, *, inflation_window=(64, 128),
                         warm_window: int | None = None):
        """The live-replan cascade at replanning rate: point cloud ->
        obstacle raycast -> layer DAG re-evaluation (inflation wavefront,
        combination) -> edge-weight plane refresh -> incremental warm solve
        with the per-edge certificate (converge="check").

        Returns `step(points, prev_costs, d_prev, seeds, *, timer=None) ->
        (new_costs, d_pad, rounds)`; chain calls by feeding each result's
        (new_costs, d_pad) into the next. d_prev is not changed. After each
        call `step.last` holds that step's refreshed plan, rounds and
        `converged`. `timer` (utils.timing.StageTimer) records the layers,
        refresh, changed_planes, warm_setup, solve and check stages.

        Only the static layers' outputs are cached; the obstacle layer's
        dependents re-evaluate per update (layer_manager.cpp:202-263). The
        per-step refresh rewrites only the plane rows whose costs differ from
        the no-obstacle base (refresh_banded_planes_rows). The windowed warm
        resolve (`warm_window`) is not ported."""
        if warm_window is not None:
            raise NotImplementedError("the windowed warm resolve (warm_window)")
        if self.stack is None or self.banded_plan is None:
            raise ValueError("replan step needs a layer stack + banded plan")
        mesh = self.mesh
        stack = self.stack
        base_state = dict(self.layer_state)
        plan0 = self.banded_plan
        pos_planes = _bg.position_planes(plan0, mesh)
        factor = self.config.mesh_map.edge_cost_factor
        cost_limit = self.config.planner.cost_limit
        key_pts = f"obstacle:{layer_name}:points"
        configs = {c.name: c for c in stack.configs}
        factors = {c.name: c.factor for c in stack.configs}

        # the change fan-out re-evaluates only the DEPENDENTS of the changed
        # layer: static layers' outputs are cached here
        affected = {layer_name}
        grew = True
        while grew:
            grew = False
            for c in stack.configs:
                if c.name not in affected and any(i in affected for i in c.inputs):
                    affected.add(c.name)
                    grew = True
        cached_outputs, combined0 = stack.compute(mesh, dict(base_state))
        cached_outputs = {n: o for n, o in cached_outputs.items() if n not in affected}
        # planes of the no-obstacle combined costs, kept for the life of the step
        base_planes = _bg.refresh_banded_planes_from_costs(
            plan0, combined0, edge_cost_factor=factor, cost_limit=cost_limit
        )

        def step(points, prev_costs, d_prev, seeds, *, timer=None):
            with _stage(timer, "layers"):
                st = dict(base_state)
                st[key_pts] = points
                # a live update is a small changed region: the inflation
                # wave runs on a certified sub-plane
                st["__inflation_window__"] = inflation_window
                st["__factors__"] = factors
                outputs = dict(cached_outputs)
                for name in stack.order:
                    if name in affected:
                        inputs = {i: outputs[i] for i in configs[name].inputs}
                        outputs[name] = stack.fns[name](mesh, inputs, st)
                combined = outputs[stack.default_layer].costs
            with _stage(timer, "refresh"):
                kp = _bg.refresh_banded_planes_rows(
                    base_planes, combined0, combined,
                    edge_cost_factor=factor, cost_limit=cost_limit,
                )
            with _stage(timer, "changed_planes"):
                # only raised costs can strand stale-low labels, so the
                # invalidation cut keys on the raised plane: a pure clear
                # update cuts nothing and re-solves by relaxation alone
                changed = _bg.changed_plane_from_costs(plan0, prev_costs, combined)
                raised = _bg.raised_plane_from_costs(plan0, prev_costs, combined)
            res = _bg.banded_solve_padded(
                kp, seeds, max_rounds=REPLAN_MAX_ROUNDS, atol=REPLAN_ATOL, rtol=REPLAN_RTOL,
                warm_d=d_prev, warm_changed=changed, warm_raised=raised,
                warm_pos=pos_planes, converge="check", timer=timer,
            )
            step.last = {"plan": kp, "rounds": res.rounds, "converged": res.converged}
            return combined, res.d_pad, res.rounds

        step.last = None
        return step
