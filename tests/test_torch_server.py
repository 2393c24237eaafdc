"""The port's navigation server against the reference's, both planner kinds,
on the CPU (mesh_navigation_torch against mesh_navigation_tpu on the same
numpy inputs): the default kind, GetPath, setPlan / ExePath / goal check,
the cost services, recovery, clear_mesh, set_parameters and navigate; then
the port's repair of the reference's stale CVP plan and its refusal of
ExePath on a result without a vector map (both ROADMAP queue C).

The map: a 14 x 14 terrain with the replan configuration (steepness +
obstacle + inflation + max combination, edge_cost_factor 1.0, cost_limit
2.0). The reference answers through its jnp gather planners; its CVP batch
GetPath (the Pallas eikonal kernel) is not run. Tolerances are those of
tests/test_torch_gather.py; commands within 1e-5, costs within 1e-5;
navigate on a flat map: the same outcome, cycles within 1, final positions
within the goal tolerance; on hills the port keeps the robot on the surface
where the reference does not, and its Dijkstra robot stalls where the
reference's loop with the same projection stalls (both ROADMAP queue C)."""

import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mesh_navigation_tpu.api.server import MeshNavServer as JMeshNavServer
from mesh_navigation_tpu.config import LayerConfig as JLayerConfig
from mesh_navigation_tpu.config import MeshMapConfig as JMeshMapConfig
from mesh_navigation_tpu.config import NavConfig as JNavConfig
from mesh_navigation_tpu.config import PlannerConfig as JPlannerConfig
from mesh_navigation_tpu.mesh import synthetic

from mesh_navigation_torch.api import server as tserver
from mesh_navigation_torch.api.outcomes import Outcome
from mesh_navigation_torch.api.server import MeshNavServer
from mesh_navigation_torch.config import LayerConfig, MeshMapConfig, NavConfig, PlannerConfig
from mesh_navigation_torch.mesh.arrays import build_mesh
from mesh_navigation_torch.planners import CVPPlanner

from test_torch_gather import _assert_plans_close
from test_torch_reference import reference_build_mesh

torch.set_num_threads(2)
N = 14
KINDS = ["dijkstra", "cvp"]


def _config(NavConfig, MeshMapConfig, PlannerConfig, LayerConfig):
    return NavConfig(
        mesh_map=MeshMapConfig(default_layer="combine", edge_cost_factor=1.0),
        planner=PlannerConfig(cost_limit=2.0),
        layers=(
            LayerConfig(name="steep", kind="steepness", params=(("threshold", 2.0),)),
            LayerConfig(name="obst", kind="obstacle"),
            LayerConfig(name="infl", kind="inflation", inputs=("obst",),
                        params=(("repulsive_field", 0.0),)),
            LayerConfig(name="combine", kind="max_combination",
                        inputs=("steep", "obst", "infl")),
        ),
    )


def _mesh(hills=1.5, roughness=0.02):
    return synthetic.terrain_mesh(N, N, spacing=0.5, hills=hills, roughness=roughness, seed=4)


def _servers(kind, max_path_len=96, hills=1.5, roughness=0.02):
    v, f = _mesh(hills, roughness)
    js = JMeshNavServer(reference_build_mesh(v, f),
                        _config(JNavConfig, JMeshMapConfig, JPlannerConfig, JLayerConfig),
                        planner_kind=kind, max_path_len=max_path_len)
    ts = MeshNavServer(build_mesh(v, f, device="cpu"),
                       _config(NavConfig, MeshMapConfig, PlannerConfig, LayerConfig),
                       planner_kind=kind, max_path_len=max_path_len, device="cpu")
    return v, js, ts


def _pose(v, i, dz=0.05):
    return (v[i] + np.asarray([0.0, 0.0, dz])).astype(np.float32)


def _cloud(v, center, n=48, seed=5):
    """Points 0.3 above a +-1-row/col patch of vertices."""
    rng = np.random.default_rng(seed)
    ids = np.clip(center + rng.integers(-1, 2, n) * N + rng.integers(-1, 2, n), 0, len(v) - 1)
    jit = np.concatenate([rng.uniform(-0.1, 0.1, (n, 2)), np.full((n, 1), 0.3)], axis=1)
    return (v[ids] + jit).astype(np.float32)


def _assert_costs(ts, js):
    got, ref = ts.vertex_costs.numpy(), np.asarray(js.vertex_costs)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(ref))
    np.testing.assert_allclose(got[np.isfinite(ref)], ref[np.isfinite(ref)], rtol=0, atol=1e-6)


def test_default_kind_is_cvp():
    v, f = _mesh()
    ts = MeshNavServer(build_mesh(v, f, device="cpu"),
                       _config(NavConfig, MeshMapConfig, PlannerConfig, LayerConfig),
                       device="cpu")
    assert ts.planner_kind == "cvp" and isinstance(ts.planner, CVPPlanner)
    for srv in (MeshNavServer, JMeshNavServer):
        assert inspect.signature(srv).parameters["planner_kind"].default == "cvp"
    assert set(tserver.PLANNER_KINDS) == {"dijkstra", "cvp"}
    assert ts.eikonal_plan is not None and ts.planner._dij_plan is not None
    assert ts.edge_weights.shape == (ts.mesh.num_edges,) and ts.banded_plan is None
    with pytest.raises(ValueError, match="planner kind"):
        MeshNavServer(ts.mesh, NavConfig(), planner_kind="astar", device="cpu")
    with pytest.raises(ValueError, match="banded plan"):
        ts.make_replan_step("obst")


@pytest.mark.parametrize("kind", KINDS)
def test_get_path_and_exe_path_match_reference(kind):
    v, js, ts = _servers(kind)
    rng = np.random.default_rng(1)
    quat = np.asarray([0.0, 0.0, np.sin(0.2), np.cos(0.2)], np.float32)
    for s_id, g_id in rng.integers(0, len(v), (2, 2)):
        s, g = _pose(v, s_id), _pose(v, g_id)
        ref = js.get_path(jnp.asarray(s), jnp.asarray(g))
        got = ts.get_path(torch.from_numpy(s), torch.from_numpy(g))
        _assert_plans_close(got, ref)
        if int(got.outcome) != 0:
            continue
        jst, tst = js.set_plan(ref), ts.set_plan(got)
        np.testing.assert_allclose(tst.goal_pos.numpy(), np.asarray(jst.goal_pos), atol=1e-4)
        np.testing.assert_allclose(tst.goal_dir.numpy(), np.asarray(jst.goal_dir), atol=1e-3)
        pos = s
        for _ in range(3):
            rc, jst = js.exe_path_step(ref, jnp.asarray(pos), jnp.asarray(quat), jst)
            gc, tst = ts.exe_path_step(got, torch.from_numpy(pos), torch.from_numpy(quat), tst)
            for k in ("linear", "angular", "cost", "heading_error"):
                np.testing.assert_allclose(getattr(gc, k).numpy(), np.asarray(getattr(rc, k)),
                                           atol=1e-5, err_msg=k)
            assert int(gc.outcome) == int(rc.outcome)
            assert int(tst.current_face) == int(jst.current_face)
            pos = pos + np.asarray([0.1, 0.05, 0.0], np.float32)
        for tol in ((0.2, 0.5), (50.0, 3.2)):
            assert bool(ts.is_goal_reached(torch.from_numpy(pos), torch.from_numpy(quat), tst,
                                           *tol)) == bool(js.is_goal_reached(
                                               jnp.asarray(pos), jnp.asarray(quat), jst, *tol))


@pytest.mark.parametrize("kind", KINDS)
def test_services_recovery_and_parameters_match_reference(kind):
    v, js, ts = _servers(kind)
    pts = np.stack([_pose(v, i, dz=0.2) for i in (2 * N + 2, 3 * N + 10, 11 * N + 3, 12 * N + 11)]
                   + [np.asarray([100.0, 100.0, 0.0], np.float32)])
    cloud = _cloud(v, 7 * N + 7)
    js.update_point_cloud("obst", jnp.asarray(cloud))
    ts.update_point_cloud("obst", torch.from_numpy(cloud))
    _assert_costs(ts, js)
    assert np.isinf(ts.vertex_costs.numpy()).sum() > 0
    got = ts.check_path_cost(torch.from_numpy(pts)).numpy()
    ref = np.asarray(js.check_path_cost(jnp.asarray(pts)))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    assert np.isnan(got[-1]) and np.isfinite(got[:2]).all()
    ok = np.isfinite(ref)
    np.testing.assert_allclose(got[ok], ref[ok], atol=1e-5)
    assert np.array_equal(np.isinf(got), np.isinf(ref))
    one = float(ts.check_pose_cost(torch.from_numpy(pts[1])))
    assert one == pytest.approx(float(js.check_pose_cost(jnp.asarray(pts[1]))), abs=1e-5)

    # recovery: clear drops the obstacle points the update left, as the reference
    js.layer_state["obstacle:obst:points"] = jnp.asarray(cloud)
    ts.layer_state["obstacle:obst:points"] = torch.from_numpy(cloud)
    assert ts.recovery("clear") == js.recovery("clear") == Outcome.SUCCESS
    assert not [k for k in ts.layer_state if k.startswith("obstacle:")]
    _assert_costs(ts, js)
    assert ts.clear_mesh() and js.clear_mesh()
    quat = np.asarray([0.0, 0.0, 0.0, 1.0], np.float32)
    rl, ra, rq = js.recovery("rotate", jnp.asarray(quat))
    gl, ga, gq = ts.recovery("rotate", torch.from_numpy(quat))
    np.testing.assert_allclose(gq.numpy(), np.asarray(rq), atol=1e-5)
    np.testing.assert_array_equal(ga.numpy(), np.asarray(ra))
    assert ts.recovery("teleport") == js.recovery("teleport") == Outcome.INVALID_PLUGIN

    # live reconfiguration
    for params in ({"mesh_map.edge_cost_factor": 2.0}, {"steep.threshold": 1.5},
                   {"controller.max_lin_velocity": 0.5}, {"planner.cost_limit": 1.5}):
        assert ts.set_parameters(params) and js.set_parameters(params)
        _assert_costs(ts, js)
        assert ts.config.controller.max_lin_velocity == js.config.controller.max_lin_velocity
        assert ts.planner.config.cost_limit == js.planner.config.cost_limit
    assert not ts.set_parameters({"nolayer.x": 1.0}) and not js.set_parameters({"nolayer.x": 1.0})
    s, g = _pose(v, 20), _pose(v, 170)
    _assert_plans_close(ts.get_path(torch.from_numpy(s), torch.from_numpy(g)),
                        js.get_path(jnp.asarray(s), jnp.asarray(g)))


def _navigate_pair(kind, hills, roughness):
    v, js, ts = _servers(kind, max_path_len=64, hills=hills, roughness=roughness)
    # the goal off its vertex: a CVP seed vertex under the goal would point up
    start, goal = _pose(v, 2 * N + 2), _pose(v, 10 * N + 9) + np.float32([0.12, 0.07, 0.0])
    quat = np.asarray([0.0, 0.0, 0.0, 1.0], np.float32)
    kw = dict(max_cycles=1000, replan_every=64)
    ref = js.navigate(jnp.asarray(start), jnp.asarray(quat), jnp.asarray(goal), **kw)
    got = ts.navigate(torch.from_numpy(start), torch.from_numpy(quat), torch.from_numpy(goal),
                      **kw)
    target = ts.set_plan(ts.get_path(torch.from_numpy(start), torch.from_numpy(goal)))
    return ts, js, start, quat, goal, got, ref, target.goal_pos.numpy()


@pytest.mark.parametrize("kind", KINDS)
def test_navigate_matches_reference(kind):
    """On a flat map both loops are the same: both reach the goal pose of
    their plan (the Dijkstra kind's is the goal's nearest vertex) in the
    same cycles, within one. A goal off the map is refused by the CVP
    kind's containing-face search; the Dijkstra kind snaps it to the
    nearest vertex."""
    ts, js, start, quat, goal, got, ref, target = _navigate_pair(kind, 0.0, 0.0)
    assert got["outcome"] == ref["outcome"] == Outcome.SUCCESS
    assert abs(got["cycles"] - ref["cycles"]) <= 1 and got["cycles"] > 64
    assert got["recoveries"] == ref["recoveries"] == 0
    final = got["final_position"].numpy()
    assert np.linalg.norm(final - np.asarray(ref["final_position"])) <= 0.3
    assert np.linalg.norm(final - target) <= 0.3
    if kind == "cvp":
        far = np.asarray([100.0, 100.0, 0.0], np.float32)
        out = ts.navigate(torch.from_numpy(start), torch.from_numpy(quat), torch.from_numpy(far))
        ref = js.navigate(jnp.asarray(start), jnp.asarray(quat), jnp.asarray(far))
        assert out["outcome"] == ref["outcome"] == Outcome.INVALID_GOAL and out["cycles"] == 0


@pytest.mark.parametrize("kind", KINDS)
def test_navigate_keeps_the_robot_on_the_surface(kind):
    """On hills the reference's unicycle step keeps the robot's height: it
    leaves the surface, its face search loses it, and the loop ends
    without reaching the goal (ROADMAP queue C). The port projects each
    step back onto the tracked face and reaches the goal pose."""
    ts, js, start, quat, goal, got, ref, target = _navigate_pair(kind, 2.5, 0.02)
    assert ref["outcome"] != Outcome.SUCCESS
    assert abs(float(ref["final_position"][2]) - float(start[2])) < 1e-6     # height kept
    assert got["outcome"] == Outcome.SUCCESS and got["recoveries"] == 0
    assert np.linalg.norm(got["final_position"].numpy() - target) <= 0.3


def test_dijkstra_navigate_stalls_where_the_reference_loop_does():
    """The Dijkstra robot's staircase stall is the reference's control law
    (ROADMAP queue C): on pair SEED + 7 of chip_smoke.py's 25 m pairs (a
    window of its 1M terrain) the field's edge-aligned directions turn 90
    degrees across a face, the heading error settles just under max_angle
    and the robot creeps. The reference's loop with the same surface
    projection stops where the port's navigate does, both far from the
    goal; the stall starts near cycle 1,100."""
    import navigate_pairs as npairs

    v = npairs.terrain()
    got, ref = npairs.run_pair(v, 1024, 7, "dijkstra", max_cycles=1400,
                               runs=("port", "reference_projected"))
    assert got["outcome"] == ref["outcome"] == "PAT_EXCEEDED"
    assert got["recoveries"] == ref["recoveries"] == 0
    assert np.linalg.norm(np.subtract(got["final"], ref["final"])) < 0.01
    assert got["final_to_goal_m"] > 5.0


def test_cvp_batch_getpath_solves_on_the_current_costs():
    """The stale-plan repair. The reference keeps the eikonal plan (side
    lengths, target mask) and its warm plan from the last structural
    refresh, so after a sensor update its batch GetPath solves on the old
    costs. The port's update drops them; the next get_path_batch rebuilds
    them from the server's current edge weights and costs, and equals, bit
    for bit, plan_batch_banded on a plan built afresh from those arrays
    (the update's points are popped after the refresh, as in the
    reference, so no second server is needed). The old plan's field
    differs, near the obstacle."""
    v, f = _mesh()
    ts = MeshNavServer(build_mesh(v, f, device="cpu"),
                       _config(NavConfig, MeshMapConfig, PlannerConfig, LayerConfig),
                       max_path_len=96, device="cpu")
    rng = np.random.default_rng(3)
    ids = rng.integers(0, len(v), 8)
    s, g = torch.from_numpy(_pose(v, ids[0:4])), torch.from_numpy(_pose(v, ids[4:8]))
    before = ts.get_path_batch(s, g)
    old_costs = ts.vertex_costs.clone()
    center = int(np.argmin(np.linalg.norm(v[:, :2] - v[:, :2].mean(0), axis=1)))
    ts.update_point_cloud("obst", torch.from_numpy(_cloud(v, center)))
    assert "obstacle:obst:points" not in ts.layer_state
    assert torch.isinf(ts.vertex_costs).sum() > torch.isinf(old_costs).sum()
    assert ts.eikonal_stale and ts.eikonal_plan is None and ts.planner._dij_plan is None
    after = ts.get_path_batch(s, g)
    assert not ts.eikonal_stale and ts.eikonal_plan is not None

    fresh = CVPPlanner(ts.mesh, ts.config.planner, grid=ts.grid, max_path_len=96, device="cpu")
    plan = fresh.prepare_eikonal_plan(ts.edge_weights.numpy(), ts.vertex_costs.numpy())
    want = fresh.plan_batch_banded(ts.edge_weights, plan, s, g)
    for k in ("d_pad", "outcome", "path_positions", "path_valid", "cost"):
        assert torch.equal(getattr(after, k), getattr(want, k)), k

    stale = CVPPlanner(ts.mesh, ts.config.planner, grid=ts.grid, max_path_len=96, device="cpu")
    old_ew = ts.planner.prepare_weights(old_costs, ts.config.mesh_map.edge_cost_factor)
    old_plan = stale.prepare_eikonal_plan(old_ew.numpy(), old_costs.numpy())
    kept = stale.plan_batch_banded(ts.edge_weights, old_plan, s, g)     # the reference's answer
    C, Cp = plan.n_cols, plan.n_cols_pad
    near = torch.from_numpy(np.linalg.norm(v - v[center], axis=1) < 1.5)
    near_pad = torch.zeros(plan.n_rows * Cp, dtype=torch.bool)
    vid = torch.arange(len(v))
    near_pad[(vid // C) * Cp + vid % C] = near
    flat = after.d_pad.reshape(-1, after.d_pad.shape[-1])[:, :4]
    for other in (kept, before):
        diff = flat != other.d_pad.reshape(-1, other.d_pad.shape[-1])[:, :4]
        assert bool(diff[near_pad].any())


def test_exe_path_step_refuses_a_result_without_vector_map():
    _, _, ts = _servers("cvp")
    v, _ = _mesh()
    res = ts.get_path_batch(torch.from_numpy(_pose(v, [5, 9])),
                            torch.from_numpy(_pose(v, [150, 160])))
    assert res.vector_map is None
    st = ts.set_plan(ts.get_path(torch.from_numpy(_pose(v, 5)), torch.from_numpy(_pose(v, 150))))
    with pytest.raises(ValueError, match="compute_velocity_cvp"):
        ts.exe_path_step(res, torch.from_numpy(_pose(v, 5)), torch.tensor([0.0, 0, 0, 1]), st)


def test_cvp_server_without_eikonal_plan_takes_the_gather_batch():
    """Without an eikonal plan (the plan builder found no band structure)
    the CVP kind answers a batch with the gather plan_batch (the full
    result), as the reference's server does. Both maps forget their plans
    here."""
    v, js, ts = _servers("cvp", max_path_len=64)
    ts.eikonal_plan = js.eikonal_plan = None
    rng = np.random.default_rng(7)
    ids = rng.integers(0, len(v), 6)
    s, g = _pose(v, ids[:3]), _pose(v, ids[3:])
    got = ts.get_path_batch(torch.from_numpy(s), torch.from_numpy(g))
    ref = js.get_path_batch(jnp.asarray(s), jnp.asarray(g))
    assert got.vector_map is not None and got.potential.shape == (3, len(v))
    _assert_plans_close(got, ref)
    assert (got.outcome == 0).sum() >= 2
