"""MeshNav navigation facade (port of mesh_navigation_tpu/api/server.py).

One shared map (mesh + layer DAG + combined costs) with a planner of the
kind asked for (PLANNER_KINDS: "cvp", the reference's default, or
"dijkstra") and the controller, on one device (default: the card). The
verbs:

  get_path(start, goal)              -> PlanResult of one goal (GetPath)
  get_path_batch(starts, goals)      -> PlanResult of a batch
  set_plan(plan)                     -> ControllerState (setPlan)
  exe_path_step(plan, pos, quat, st) -> (command, state): one ExePath cycle
  is_goal_reached(pos, quat, st)     -> bool
  navigate(pos, quat, goal)          -> dict: the MoveBase loop
  check_pose_cost(pos), check_path_cost(positions)
  recovery(name), clear_mesh(), set_parameters(params)
  update_point_cloud(layer, points)  -> obstacle sensor update
  make_replan_step(layer)            -> the live-replan step (Dijkstra kind)
  save_map(path)                     -> the mesh and every layer's costs to HDF5

The solver plans: the Dijkstra kind keeps a banded plan where the vertex
order has band structure, else an offset-classed plan; the CVP kind keeps
the eikonal plan with its banded Dijkstra warm plan where the mesh has band
structure, else solves with the gather plan_batch. The reference rebuilds
the CVP plan only on structural refreshes, so after a sensor update its
batch GetPath solves on the old side lengths and target mask (ROADMAP
queue C). Here a sensor update drops the CVP plan and marks it stale, and
the next get_path_batch rebuilds it from the current edge weights and
costs. `save_map` writes the working file (mesh/io.py).
"""

from __future__ import annotations

import dataclasses

import torch

from mesh_navigation_torch import layers as _layers
from mesh_navigation_torch.api.outcomes import Outcome
from mesh_navigation_torch.config import NavConfig
from mesh_navigation_torch.control import recovery as _recovery
from mesh_navigation_torch.control import tracking
from mesh_navigation_torch.control.controller import (
    ControllerState, MeshController, initial_state, unicycle_step,
)
from mesh_navigation_torch.device import resolve_device
from mesh_navigation_torch.mesh import geometry, io, query
from mesh_navigation_torch.mesh.arrays import MeshArrays
from mesh_navigation_torch.ops import banded_gpu as _bg
from mesh_navigation_torch.ops import structured as _structured
from mesh_navigation_torch.ops import sweeps
from mesh_navigation_torch.planners.common import PlanResult
from mesh_navigation_torch.planners.cvp import CVPPlanner
from mesh_navigation_torch.planners.dijkstra import DijkstraPlanner
from mesh_navigation_torch.utils.timing import stage as _stage

PLANNER_KINDS = {"dijkstra": DijkstraPlanner, "cvp": CVPPlanner}

# the replan step's solve: the live-replan tolerance and round cap
# (mesh_navigation_tpu/api/server.py:268-273)
REPLAN_ATOL, REPLAN_RTOL, REPLAN_MAX_ROUNDS = 1e-4, 2e-3, 64


class MeshNavServer:
    """One shared map + a planner of `planner_kind` and the controller, on
    one device (default: the card). `grid` may pass in a snap grid already
    built for this mesh."""

    def __init__(
        self,
        mesh: MeshArrays,
        config: NavConfig = NavConfig(),
        *,
        planner_kind: str = "cvp",
        max_path_len: int = 1024,
        grid: query.SpatialGrid | None = None,
        device=None,
    ):
        if planner_kind not in PLANNER_KINDS:
            raise ValueError(f"planner kind {planner_kind!r} (have {sorted(PLANNER_KINDS)})")
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
        self.planner = PLANNER_KINDS[planner_kind](
            self.mesh, config.planner, grid=self.grid, max_path_len=max_path_len,
            device=self.device,
        )
        self.controller = MeshController(
            self.mesh, config.controller, grid=self.grid, device=self.device
        )
        # Dijkstra kind
        self.banded_plan: _bg.BandedKernelPlan | None = None
        self.offset_plan: _structured.OffsetPlan | None = None
        self.slot_weights: torch.Tensor | None = None
        # CVP kind
        self.edge_weights: torch.Tensor | None = None
        self.layer_vectors: torch.Tensor | None = None
        self.eikonal_plan = None
        self.eikonal_stale = False
        self._refresh_costs()

    # ------------------------------------------------------------------
    # map / layer plumbing (MeshMap::readMap tail, mesh_map.cpp:434-452)
    # ------------------------------------------------------------------
    def _refresh_costs(self, *, structural: bool = True) -> None:
        """Layer outputs -> combined costs -> the kind's weights and plan.

        Dijkstra kind: structural=True (and whenever there is no plan yet)
        builds the plan on the host from the slot-weight table: the banded
        plan, or where the mesh has none the offset plan (server.py:
        134-143). structural=False (the sensor hot path) re-derives only the
        weights, on the device: the banded planes straight from the costs,
        or the [V, D] slot weights and the offset planes from them
        (:144-159). The slot weights are kept only for the structured path.

        CVP kind: the edge weights (the triangle side lengths) and the
        layers' summed vector field are kept for get_path. structural=True
        builds the eikonal plan with its warm plan now (:121-133);
        structural=False drops it and marks it stale for get_path_batch to
        rebuild."""
        if self.stack is not None:
            self.layer_outputs, self.vertex_costs = self.stack.compute(self.mesh, self.layer_state)
        else:
            self.layer_outputs = {}
            self.vertex_costs = torch.zeros(self.mesh.num_vertices, dtype=torch.float32,
                                            device=self.device)
        factor = self.config.mesh_map.edge_cost_factor
        cost_limit = self.config.planner.cost_limit
        if self.planner_kind == "cvp":
            self.edge_weights = sweeps.compute_edge_weights(self.mesh, self.vertex_costs, factor)
            self.layer_vectors = (
                self.stack.combined_vectors(self.mesh, self.layer_outputs)
                if self.stack is not None else _layers.zero_vectors(self.mesh)
            )
            if structural:
                self._rebuild_eikonal_plan()
            else:
                self.eikonal_plan = None
                self.planner.drop_eikonal_plan()
                self.eikonal_stale = True
            return
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
            self.slot_weights = self.planner.prepare_weights(self.vertex_costs, factor)
            self.offset_plan = _structured.refresh_offset_planes(
                self.offset_plan, self.slot_weights
            )

    def _rebuild_eikonal_plan(self) -> None:
        """The CVP plan, its warm plan and target mask from the current edge
        weights and costs (CVPPlanner.prepare_eikonal_plan, on the host);
        None where the mesh has no band structure."""
        self.eikonal_plan = self.planner.prepare_eikonal_plan(
            self.edge_weights.cpu().numpy(), self.vertex_costs.cpu().numpy()
        )
        self.eikonal_stale = False

    def update_point_cloud(self, layer_name: str, points: torch.Tensor) -> None:
        """Obstacle-layer sensor update -> layer cascade re-evaluation (the
        §3.5 change path); the Dijkstra plan is refreshed on the device, the
        CVP plan marked stale."""
        key = f"obstacle:{layer_name}:points"
        self.layer_state[key] = points
        self._refresh_costs(structural=False)
        self.layer_state.pop(key, None)

    # ------------------------------------------------------------------
    # GetPath
    # ------------------------------------------------------------------
    def get_path(self, start: torch.Tensor, goal: torch.Tensor) -> PlanResult:
        """One GetPath on the current costs (server.py:287-293): the Jacobi
        Dijkstra field on the slot weights, or the gather CVP solve on the
        edge weights with the layers' vector field blended into the
        back-tracking. The result's leaves are unbatched."""
        if self.planner_kind == "dijkstra":
            weights = self.planner.prepare_weights(self.vertex_costs,
                                                   self.config.mesh_map.edge_cost_factor)
            return self.planner.plan_one(weights, start, goal)
        return self.planner.plan_one(self.edge_weights, self.vertex_costs, start, goal,
                                     layer_vectors=self.layer_vectors)

    def get_path_batch(self, starts: torch.Tensor, goals: torch.Tensor, *,
                       timer=None) -> PlanResult:
        """Batch GetPath (server.py:295-310).

        Dijkstra kind: the banded light path where the mesh has a banded
        plan (its result has no vector map, predecessor map or [B, V]
        potential), else the structured path where the offset classes cover
        more than half of the edges, else the planner's plan_batch (the
        hybrid ordered + Jacobi solve); both give the full result.

        CVP kind: a stale plan is rebuilt first (the `rebuild` stage of
        `timer`); then plan_batch_banded where the mesh has an eikonal plan
        (no vector map or predecessor map), else the gather plan_batch (the
        full result)."""
        if self.planner_kind == "cvp":
            if self.eikonal_stale:
                with _stage(timer, "rebuild"):
                    self._rebuild_eikonal_plan()
            if self.eikonal_plan is not None:
                return self.planner.plan_batch_banded(self.edge_weights, self.eikonal_plan,
                                                      starts, goals, timer=timer)
            return self.planner.plan_batch(self.edge_weights, self.vertex_costs, starts, goals)
        if self.banded_plan is not None:
            return self.planner.plan_batch_banded(self.banded_plan, starts, goals, timer=timer)
        if self.offset_plan is not None and self.offset_plan.coverage > 0.5:
            return self.planner.plan_batch_structured(
                self.slot_weights, self.offset_plan, starts, goals, timer=timer
            )
        return self.planner.plan_batch(self.slot_weights, starts, goals, timer=timer)

    # ------------------------------------------------------------------
    # ExePath
    # ------------------------------------------------------------------
    def set_plan(self, plan: PlanResult) -> ControllerState:
        """setPlan (mesh_controller.cpp:179-193): the goal pose of one plan
        (its last valid pose) and a reset tracked face."""
        last = torch.clamp(plan.path_valid.sum() - 1, min=0)
        return initial_state(plan.path_positions[last],
                             geometry.direction_from_pose(plan.path_quats[last]))

    def exe_path_step(self, plan: PlanResult, position: torch.Tensor,
                      orientation: torch.Tensor, state: ControllerState):
        """One ExePath cycle on the plan's vector map (server.py:326-335).
        The banded batch results carry no vector map; the reference's cycle
        would fail on them (ROADMAP queue C), here it raises and names the
        cycles that read those results' fields."""
        if plan.vector_map is None:
            raise ValueError(
                "exe_path_step needs a plan with a vector map (get_path, or a full batch "
                "result); drive a banded batch result with MeshController."
                "compute_velocity_cvp (CVP kind) or compute_velocity_banded (Dijkstra kind)"
            )
        return self.controller.compute_velocity(plan.vector_map, self.vertex_costs, position,
                                                orientation, state)

    def is_goal_reached(self, position, orientation, state: ControllerState,
                        dist_tol: float = 0.2, angle_tol: float = 0.5) -> torch.Tensor:
        return self.controller.is_goal_reached(position, orientation, state, dist_tol, angle_tol)

    # ------------------------------------------------------------------
    # MoveBase: GetPath + ExePath + Recovery with the retry logic
    # ------------------------------------------------------------------
    def navigate(
        self,
        position: torch.Tensor,
        orientation: torch.Tensor,
        goal: torch.Tensor,
        *,
        dist_tolerance: float = 0.3,
        angle_tolerance: float = 3.2,
        max_cycles: int = 2048,
        replan_every: int = 256,
        max_recoveries: int = 2,
        dt: float = 0.05,
    ) -> dict:
        """Closed-loop navigate-to-goal (server.py:348-428): plan, follow
        the vector field one control cycle at a time, integrate the unicycle
        step, replan every `replan_every` cycles, and on a controller
        failure run the recovery chain (clear, then plan again) up to
        `max_recoveries` times. Returns {outcome, cycles, recoveries,
        final_position, path_cost}.

        One departure from the reference: after each step the position is
        put back on the surface, projected into the face the controller
        tracks (tracking.locate from the state's face). The reference's
        step keeps the robot's height, so on a slope it leaves the surface,
        its face search loses it past the 0.4 band (or sooner, over a
        convex crease) and the loop ends OUT_OF_MAP (ROADMAP queue C). On a
        flat map the two loops are the same."""
        position = position.to(self.device, torch.float32)
        orientation = orientation.to(self.device, torch.float32)

        def result(outcome, cycles, recoveries, cost):
            return {"outcome": Outcome(int(outcome)), "cycles": cycles,
                    "recoveries": recoveries, "final_position": position, "path_cost": cost}

        recoveries = 0
        plan = self.get_path(position, goal)
        if int(plan.outcome) != Outcome.SUCCESS:
            return result(plan.outcome, 0, 0, float("inf"))
        state = self.set_plan(plan)
        cycles = 0
        while cycles < max_cycles:
            if bool(self.is_goal_reached(position, orientation, state, dist_tolerance,
                                         angle_tolerance)):
                return result(Outcome.SUCCESS, cycles, recoveries, float(plan.cost))
            cmd, state = self.exe_path_step(plan, position, orientation, state)
            oc = int(cmd.outcome)
            if oc != Outcome.SUCCESS:
                if recoveries >= max_recoveries:
                    return result(oc, cycles, recoveries, float(plan.cost))
                recoveries += 1
                self.recovery("clear")
                plan = self.get_path(position, goal)
                if int(plan.outcome) != Outcome.SUCCESS:
                    return result(plan.outcome, cycles, recoveries, float("inf"))
                state = self.set_plan(plan)
                continue
            position, orientation = unicycle_step(position, orientation, cmd.linear,
                                                  cmd.angular, dt)
            orientation = geometry.normalize(orientation)
            fix = tracking.locate(self.mesh, self.grid, position, state.current_face,
                                  max_dist=self.config.controller.max_search_distance)
            position = torch.where(fix.found, fix.position, position)
            cycles += 1
            if replan_every and cycles % replan_every == 0:
                plan = self.get_path(position, goal)
                if int(plan.outcome) == Outcome.SUCCESS:
                    state = dataclasses.replace(self.set_plan(plan),
                                                current_face=state.current_face)
        return result(Outcome.PAT_EXCEEDED, cycles, recoveries, float(plan.cost))

    # ------------------------------------------------------------------
    # services (mesh_navigation_server.cpp:303-328)
    # ------------------------------------------------------------------
    def check_path_cost(self, positions: torch.Tensor) -> torch.Tensor:
        """Combined cost at each of [N, 3] surface positions, NaN off the
        map (the reference's declared service, mesh_navigation_server.cpp:
        315-323, implemented in server.py:433-443)."""
        positions = positions.to(self.device, torch.float32)
        faces = torch.full((positions.shape[0],), -1, dtype=torch.int64, device=self.device)
        fix = tracking.locate_batch(self.mesh, self.grid, positions, faces)
        cost = tracking.cost_at(self.mesh, self.vertex_costs, fix.face, fix.bary)
        return torch.where(fix.found, cost, torch.nan)

    def check_pose_cost(self, position: torch.Tensor) -> torch.Tensor:
        """check_path_cost of one [3] position."""
        return self.check_path_cost(position.reshape(1, 3))[0]

    def clear_mesh(self) -> bool:
        """clear_mesh service -> resetLayers (mesh_navigation_server.cpp:
        325-328; mesh_map.cpp:1307-1310 is a TODO there): drop the dynamic
        obstacle state and re-run the layers."""
        for key in [k for k in self.layer_state if k.startswith("obstacle:")]:
            del self.layer_state[key]
        self._refresh_costs(structural=False)
        return True

    def set_parameters(self, params: dict) -> bool:
        """Dotted-name parameter updates with the reference's targeted
        recomputation (server.py:458-516): `mesh_map.*` and `planner.*`
        refresh the weights and plans; `controller.*` updates in place;
        `<layer>.<param>` rebuilds the layer stack (keeping the dynamic
        state) and refreshes. False for an unknown layer."""
        refresh_costs = refresh_layers = False
        for name, value in params.items():
            scope, _, key = name.partition(".")
            if scope == "mesh_map":
                self.config = dataclasses.replace(
                    self.config, mesh_map=dataclasses.replace(self.config.mesh_map, **{key: value}))
                refresh_costs = True
            elif scope == "planner":
                self.config = dataclasses.replace(
                    self.config, planner=dataclasses.replace(self.config.planner, **{key: value}))
                self.planner.config = self.config.planner
                refresh_costs = True
            elif scope == "controller":
                self.config = dataclasses.replace(
                    self.config,
                    controller=dataclasses.replace(self.config.controller, **{key: value}))
                self.controller.config = self.config.controller
            else:
                layers, found = [], False
                for lc in self.config.layers:
                    if lc.name == scope:
                        found = True
                        params_new = tuple((k, v) for k, v in lc.params if k != key)
                        lc = dataclasses.replace(lc, params=params_new + ((key, float(value)),))
                    layers.append(lc)
                if not found:
                    return False
                self.config = dataclasses.replace(self.config, layers=tuple(layers))
                refresh_layers = True
        if refresh_layers:
            self.stack = _layers.LayerStack.from_configs(
                self.config.layers, self.config.mesh_map.default_layer or None)
            self.layer_state.update(self.stack.prepare(self.mesh))
            refresh_costs = True
        if refresh_costs:
            self._refresh_costs()
        return True

    def recovery(self, name: str = "clear", orientation: torch.Tensor | None = None):
        """Recovery behaviors (mbf_mesh_core/mesh_recovery.h:54-93):
        "clear" re-runs the layers without the dynamic obstacle state and
        returns SUCCESS; "rotate" returns the rotate-in-place command
        sequence (control/recovery.py); anything else INVALID_PLUGIN."""
        if name == "clear":
            self.clear_mesh()
            return Outcome.SUCCESS
        if name == "rotate":
            if orientation is None:
                orientation = torch.tensor([0.0, 0.0, 0.0, 1.0], device=self.device)
            return _recovery.rotate_in_place(_recovery.RotateRecovery(), orientation)
        return Outcome.INVALID_PLUGIN

    def save_map(self, path: str) -> bool:
        """save_map Trigger service (mesh_map.cpp:141-146; reference
        server.py:534-544): the mesh and one channel per layer's costs, plus
        `vertex_costs`, into the HDF5 working file at `path`."""
        channels = {name: out.costs.cpu().numpy() for name, out in self.layer_outputs.items()}
        channels["vertex_costs"] = self.vertex_costs.cpu().numpy()
        io.save_working_file(path, self.mesh, channels)
        return True

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
        step reads only costs, so its layers run with SKIP_VECTORS in their
        state and compute no repulsive field (the reference's jitted step
        returns only costs and so drops it too). The per-step refresh
        rewrites only the plane rows whose costs differ from the
        no-obstacle base (refresh_banded_planes_rows). `warm_window` (rows,
        a positive multiple of 128; default None, as the reference's) runs
        each step's resolve on a row slab where the rows it affects fit
        (banded_solve_padded); `step.last["window"]` then holds that step's
        WindowRecord."""
        _bg.check_warm_window(warm_window)
        if self.stack is None or self.banded_plan is None:
            raise ValueError("replan step needs a layer stack + banded plan")
        mesh = self.mesh
        stack = self.stack
        base_state = {**self.layer_state, _layers.SKIP_VECTORS: True}
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
                warm_pos=pos_planes, warm_window=warm_window, converge="check", timer=timer,
            )
            step.last = {"plan": kp, "rounds": res.rounds, "converged": res.converged,
                         "window": res.window}
            return combined, res.d_pad, res.rounds

        step.last = None
        return step
