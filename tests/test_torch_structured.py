"""Port vs reference: the structured Dijkstra tier.

The reference's fused sweep is a Pallas kernel with no interpret flag; its
tests never call it. Here it runs on the CPU with `pl.pallas_call` patched to
interpret mode for the length of one test (no file of the reference
changes). The port runs the plain PyTorch version its wrapper takes for CPU
tensors.

Tolerances. Every relaxation is one f32 add and a min, so a sweep, and the
least fixed point a solve reaches, are exact: sweeps, fields, predecessor
ids, sweep counts, paths and outcomes are compared for equality, the
fields against the native heap Dijkstra at rtol 1e-4 (its own summation
order). The vector map and the path costs come from a norm and a sum whose
order may differ: 1e-6 and rtol 1e-5. Controller commands within 1e-5, with
each robot's heading 10 degrees off its path (away from acos's singular
point at 0)."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from mesh_navigation_tpu.api.server import MeshNavServer as JMeshNavServer
from mesh_navigation_tpu.config import ControllerConfig as JControllerConfig
from mesh_navigation_tpu.config import LayerConfig as JLayerConfig
from mesh_navigation_tpu.config import MeshMapConfig as JMeshMapConfig
from mesh_navigation_tpu.config import NavConfig as JNavConfig
from mesh_navigation_tpu.config import PlannerConfig as JPlannerConfig
from mesh_navigation_tpu.control import MeshController as JMeshController
from mesh_navigation_tpu.control.controller import initial_state as j_initial_state
from mesh_navigation_tpu.mesh import reorder as jreorder
from mesh_navigation_tpu.mesh import synthetic
from mesh_navigation_tpu.ops import pallas_sweep as jps
from mesh_navigation_tpu.ops import structured as jst
from mesh_navigation_tpu.ops import sweeps as jsweeps
from mesh_navigation_tpu.planners import DijkstraPlanner as JDijkstraPlanner

from mesh_navigation_torch import convert
from mesh_navigation_torch.api.server import MeshNavServer
from mesh_navigation_torch.config import (
    ControllerConfig, LayerConfig, MeshMapConfig, NavConfig, PlannerConfig,
)
from mesh_navigation_torch.control.controller import MeshController, initial_state
from mesh_navigation_torch.mesh.arrays import build_mesh
from mesh_navigation_torch.native import NativeMesh
from mesh_navigation_torch.ops import structured as tst
from mesh_navigation_torch.ops import sweep_gpu as tsg
from mesh_navigation_torch.ops import sweeps as tsweeps
from mesh_navigation_torch.planners import DijkstraPlanner

from test_torch_reference import reference_build_mesh

torch.set_num_threads(2)

COST_LIMIT, FACTOR = 2.0, 1.0


@pytest.fixture
def interpret(monkeypatch):
    """The reference's fused sweep in Pallas interpret mode, for one test."""
    monkeypatch.setattr(jps.pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


@functools.lru_cache(maxsize=None)
def _case(kind):
    """(v, f, reference mesh, port mesh, costs, W) of an x-major 24 x 24
    terrain or an RCM-reordered 16 x 16 one, both meshes built from the same
    arrays. Costs are the steepness angle, with a wall of lethal vertices on
    the 24 x 24 terrain (row 21 of 24 vertices, x = 10.5) that cuts off its
    last two rows."""
    if kind == "terrain24":
        v, f = synthetic.terrain_mesh(24, 24, spacing=0.5, hills=1.5, roughness=0.02, seed=3)
    else:
        v, f = synthetic.terrain_mesh(16, 16, spacing=0.5, hills=1.5, roughness=0.02, seed=5)
        v, f, _ = jreorder.reorder_mesh(v, f, method="rcm")
    jm = reference_build_mesh(v, f)
    tm = build_mesh(v, f, device="cpu")
    nz = np.clip(np.asarray(jm.vertex_normals)[:, 2], -1.0, 1.0)
    costs = np.arccos(nz).astype(np.float32)
    if kind == "terrain24":
        costs[21 * 24:22 * 24] = np.inf
    W = tsweeps.slot_weights_np(tm, costs, cost_limit=COST_LIMIT, edge_cost_factor=FACTOR)
    return v, f, jm, tm, costs, W


def _plan_arrays(plan):
    return {k: np.asarray(getattr(plan, k)) for k in tst.OFFSET_PLAN_ARRAYS}


def _assert_plans_equal(tp, jp):
    assert tp.offsets == jp.offsets
    assert tp.coverage == jp.coverage
    for k, a in _plan_arrays(jp).items():
        np.testing.assert_array_equal(getattr(tp, k).numpy(), a, err_msg=k)


@pytest.mark.parametrize("kind", ["terrain24", "rcm16"])
def test_offset_plan_and_refresh_match_reference(kind):
    v, f, jm, tm, costs, W = _case(kind)
    np.testing.assert_array_equal(
        W, jsweeps.slot_weights_np(jm, costs, cost_limit=COST_LIMIT, edge_cost_factor=FACTOR))
    jp = jst.build_offset_plan(jm, jnp.asarray(W))
    tp = tst.build_offset_plan(tm, W)
    _assert_plans_equal(tp, jp)
    if kind == "terrain24":
        assert tp.coverage == 1.0 and not tp.has_residual
        assert sorted(tp.offsets) == [-25, -24, -1, 1, 24, 25]
    else:
        assert 0.5 < tp.coverage < 0.9 and tp.has_residual
    # a cost change: the device refresh equals the reference's refresh and a
    # host rebuild on the new weights
    new = costs.copy()
    new[np.random.default_rng(1).integers(0, len(new), 20)] = np.inf
    new[:10] = 2.5
    W2 = tsweeps.slot_weights_np(tm, new, cost_limit=COST_LIMIT, edge_cost_factor=FACTOR)
    got = tst.refresh_offset_planes(tp, torch.from_numpy(W2))
    _assert_plans_equal(got, jst.refresh_offset_planes(jp, jnp.asarray(W2)))
    _assert_plans_equal(got, tst.build_offset_plan(tm, W2))
    # the device slot-weight table equals the host one
    tw = tsweeps.slot_weights(tm, tsweeps.compute_edge_weights(tm, torch.from_numpy(new), FACTOR),
                              torch.from_numpy(new), COST_LIMIT)
    np.testing.assert_array_equal(tw.numpy(), W2)


@pytest.mark.parametrize("tile,Vp,B,n_inner,offsets", [
    (256, 512, 8, 1, (1, -1, 256, -256)),
    (256, 768, 24, 2, (1, -16, -17, 16, 17)),
    (256, 512, 3, 3, (-256, 7, 200)),
    (128, 384, 16, 12, (1, -1, 128, -127)),
])
def test_fused_sweep_matches_reference_kernel(interpret, monkeypatch, tile, Vp, B, n_inner,
                                              offsets):
    rng = np.random.default_rng(tile + Vp + B)
    d = rng.uniform(0, 10, (Vp + 2 * tile, B)).astype(np.float32)
    d[rng.uniform(size=d.shape) < 0.3] = np.inf
    d[:tile] = np.inf
    d[-tile:] = np.inf
    planes = rng.uniform(0, 1, (len(offsets), Vp)).astype(np.float32)
    planes[rng.uniform(size=planes.shape) < 0.2] = np.inf
    ref = np.asarray(jps.fused_sweep(jnp.asarray(d), jnp.asarray(planes), offsets,
                                     tile=tile, n_inner=n_inner))
    d_t = torch.from_numpy(d)
    got = tsg.fused_sweep(d_t, torch.from_numpy(planes), offsets, tile=tile, n_inner=n_inner)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert np.array_equal(d_t.numpy(), d)                  # the input is left as it was
    assert not np.array_equal(ref, d)                      # the sweep did something
    # chunks of one tile give the same matrix
    monkeypatch.setattr(tsg, "_CHUNK_ELEMS", 1)
    again = tsg._fused_sweep_plain(d_t, torch.from_numpy(planes), offsets, tile, n_inner)
    assert torch.equal(again, got)


def test_sweep_loop_matches_reference(interpret):
    rng = np.random.default_rng(9)
    tile, Vp, B, offsets = 128, 256, 4, (1, -1, 128, -128)
    d = np.full((Vp + 2 * tile, B), np.inf, np.float32)
    d[tile + rng.integers(0, Vp, B), np.arange(B)] = 0.0
    planes = rng.uniform(0.1, 1, (len(offsets), Vp)).astype(np.float32)
    ref = np.asarray(jps.sweep_loop(jnp.asarray(d), jnp.asarray(planes), offsets, 5, tile=tile))
    got = tsg.sweep_loop(torch.from_numpy(d), torch.from_numpy(planes), offsets, 5, tile=tile)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_fused_sweep_refuses_what_the_kernel_does_not_take():
    d = torch.full((1024, 4), np.inf)
    planes = torch.zeros(2, 512)
    with pytest.raises(ValueError, match="multiple of the tile"):
        tsg.fused_sweep(d, torch.zeros(2, 500), (1, -1), tile=256)
    with pytest.raises(ValueError, match="exceeds the tile"):
        tsg.fused_sweep(d, planes, (1, 257), tile=256)
    with pytest.raises(ValueError, match="offsets for"):
        tsg.fused_sweep(d, planes, (1,), tile=256)
    with pytest.raises(ValueError, match="tile \\+ Vp \\+ tile"):
        tsg.fused_sweep(d[:768], planes, (1, -1), tile=256)
    with pytest.raises(ValueError, match="apart from the input"):
        tsg.fused_sweep(d, planes, (1, -1), tile=256, out=d)
    with pytest.raises(ValueError, match="unsupported device"):
        tsg.fused_sweep(d.to("meta"), planes.to("meta"), (1, -1), tile=256)


def _native_fields(v, f, tm, costs, seeds):
    nm = NativeMesh(v, f)
    try:
        edges = nm.tables()["edges"]
        np.testing.assert_array_equal(edges, tm.edges.numpy())
        ew = tsweeps.compute_edge_weights(tm, torch.from_numpy(costs), FACTOR).numpy()
        return [nm.dijkstra(ew, costs, int(s), COST_LIMIT) for s in seeds]
    finally:
        nm.close()


@pytest.mark.parametrize("kind", ["terrain24", "rcm16"])
def test_structured_solve_matches_reference(interpret, kind):
    v, f, jm, tm, costs, W = _case(kind)
    seeds = np.random.default_rng(2).integers(0, len(v), 6).astype(np.int32)
    jp = jst.build_offset_plan(jm, jnp.asarray(W))
    tp = tst.build_offset_plan(tm, W)
    kw = dict(tile=256, n_inner=2)
    ref = jst.batched_field_structured(jm, jnp.asarray(W), jp, jnp.asarray(seeds),
                                       use_pallas=True, **kw)
    got = tst.batched_field_structured(tm, torch.from_numpy(W), tp, torch.from_numpy(seeds), **kw)
    np.testing.assert_array_equal(got.dist.numpy(), np.asarray(ref.dist))
    np.testing.assert_array_equal(got.pred.numpy(), np.asarray(ref.pred))
    assert got.pred.dtype == torch.int32
    assert got.sweeps == int(ref.sweeps) and got.converged == bool(ref.converged)
    assert got.converged and got.sweeps > 17
    # the roll formulation reaches the same least fixed point in other sweeps
    roll = jst.batched_field_structured(jm, jnp.asarray(W), jp, jnp.asarray(seeds),
                                        use_pallas=False)
    np.testing.assert_array_equal(got.dist.numpy(), np.asarray(roll.dist))
    np.testing.assert_array_equal(got.pred.numpy(), np.asarray(roll.pred))
    # and the native heap Dijkstra the same field
    dist = got.dist.numpy()
    for b, (nd, _) in enumerate(_native_fields(v, f, tm, costs, seeds)):
        fin = np.isfinite(nd)
        np.testing.assert_array_equal(np.isfinite(dist[b]), fin)
        np.testing.assert_allclose(dist[b][fin], nd[fin], rtol=1e-4, atol=1e-6)
    if kind == "terrain24":
        assert not np.isfinite(dist).all()          # the wall cuts the last rows off


def test_capped_solve_reports_unconverged(interpret):
    _, _, jm, tm, _, W = _case("terrain24")
    seeds = np.asarray([5, 300], np.int32)
    jp = jst.build_offset_plan(jm, jnp.asarray(W))
    tp = tst.build_offset_plan(tm, W)
    kw = dict(tile=256, n_inner=1, max_sweeps=20, block_sweeps=8)
    ref = jst.batched_field_structured(jm, jnp.asarray(W), jp, jnp.asarray(seeds),
                                       use_pallas=True, **kw)
    got = tst.batched_field_structured(tm, torch.from_numpy(W), tp, torch.from_numpy(seeds), **kw)
    assert got.sweeps == int(ref.sweeps) == 25
    assert got.converged is False and not bool(ref.converged)
    np.testing.assert_array_equal(got.dist.numpy(), np.asarray(ref.dist))
    # the bfloat16 solve caps alike
    half = tst.batched_field_structured(tm, torch.from_numpy(W), tp, torch.from_numpy(seeds),
                                        dtype=torch.bfloat16, **kw)
    assert half.sweeps == 25 and half.converged is False


def test_port_tile_rule_holds_the_largest_offset():
    _, _, _, tm, _, W = _case("terrain24")
    tp = tst.build_offset_plan(tm, W)
    assert tst.default_tile(tp) == 256 and tst.default_n_inner(tp, 256) == 11
    wide = tst.OffsetPlan(offsets=(1, -1, 1024, -1025), planes=tp.planes[:4], res_dst=tp.res_dst,
                          res_src=tp.res_src, res_w=tp.res_w, slot_map=tp.slot_map[:4],
                          res_slot=tp.res_slot, coverage=1.0)
    assert tst.default_tile(wide) == 1280 and tst.default_n_inner(wide, 1280) == 2


def _scenarios(jm, kind, B=6):
    """Starts and goals on the surface; on the walled terrain the last
    lane's start lies behind the wall."""
    rng = np.random.default_rng(7)
    vv = np.asarray(jm.vertices)
    hi = vv[:, :2].max(0) - 0.3
    if kind == "terrain24":
        hi[0] = 10.0                      # x rows 0..20 (vertex id = 24 * row + column)
    s = np.concatenate([rng.uniform(0.3, hi, (B, 2)), np.zeros((B, 1))], 1).astype(np.float32)
    g = np.concatenate([rng.uniform(0.3, hi, (B, 2)), np.zeros((B, 1))], 1).astype(np.float32)
    if kind == "terrain24":
        s[-1] = [11.3, 5.0, 0.0]          # row 22, behind the wall of row 21
    return s, g


def _assert_results_equal(tr, jr):
    np.testing.assert_array_equal(tr.outcome.numpy(), np.asarray(jr.outcome))
    np.testing.assert_array_equal(tr.potential.numpy(), np.asarray(jr.potential))
    np.testing.assert_array_equal(tr.pred.numpy(), np.asarray(jr.pred))
    np.testing.assert_array_equal(tr.path_valid.numpy(), np.asarray(jr.path_valid))
    np.testing.assert_array_equal(tr.path_positions.numpy(), np.asarray(jr.path_positions))
    np.testing.assert_allclose(tr.vector_map.numpy(), np.asarray(jr.vector_map), atol=1e-6)
    np.testing.assert_allclose(tr.cost.numpy(), np.asarray(jr.cost), rtol=1e-5)
    # a quaternion component near 0 carries ~2e-4 of noise (test_torch_slice.py)
    np.testing.assert_allclose(tr.path_quats.numpy(), np.asarray(jr.path_quats), atol=5e-4)


@pytest.mark.parametrize("kind", ["terrain24", "rcm16"])
def test_plan_batch_structured_and_control_match_reference(kind):
    _, _, jm, tm, costs, W = _case(kind)
    s, g = _scenarios(jm, kind)
    B = len(s)
    jpl = JDijkstraPlanner(jm, JPlannerConfig(cost_limit=COST_LIMIT), max_path_len=96)
    jres = jpl.plan_batch_structured(jnp.asarray(W), jpl.prepare_offset_plan(jnp.asarray(W)),
                                     jnp.asarray(s), jnp.asarray(g))
    tpl = DijkstraPlanner(tm, PlannerConfig(cost_limit=COST_LIMIT), max_path_len=96, device="cpu")
    tres = tpl.plan_batch_structured(torch.from_numpy(W), tpl.prepare_offset_plan(W),
                                     torch.from_numpy(s), torch.from_numpy(g))
    _assert_results_equal(tres, jres)
    assert tres.converged and tres.rounds > 1
    if kind == "terrain24":
        assert tres.outcome.tolist() == [0] * (B - 1) + [54]    # NO_PATH_FOUND behind the wall
        assert not tres.path_valid[-1].any() and np.isinf(float(tres.cost[-1]))
    else:
        assert (tres.outcome.numpy() == 0).all()
    # one control cycle per robot at its start vertex, each heading 10
    # degrees off its path
    pos = np.asarray(jres.path_positions)
    s = np.ascontiguousarray(pos[:, 0])
    step = pos[:, 1] - pos[:, 0]
    yaw = np.arctan2(step[:, 1], step[:, 0]) + np.deg2rad(10.0)
    q = np.stack([0 * yaw, 0 * yaw, np.sin(yaw / 2), np.cos(yaw / 2)], 1).astype(np.float32)
    jc = JMeshController(jm, JControllerConfig(), grid=jpl.grid)
    tc = MeshController(tm, ControllerConfig(), grid=tpl.grid, device="cpu")
    jstate = jax.vmap(lambda x: j_initial_state(x, jnp.asarray([1.0, 0.0, 0.0])))(jnp.asarray(g))
    tstate = initial_state(torch.from_numpy(g), torch.tensor([1.0, 0.0, 0.0]))
    cases = (
        (jax.vmap(jc.compute_velocity, in_axes=(0, None, 0, 0, 0))(
            jres.vector_map, jnp.asarray(costs), jnp.asarray(s), jnp.asarray(q), jstate),
         tc.compute_velocity(tres.vector_map, torch.from_numpy(costs), torch.from_numpy(s),
                             torch.from_numpy(q), tstate)),
        (jax.vmap(jc.compute_velocity_pred, in_axes=(0, None, 0, 0, 0))(
            jres.pred, jnp.asarray(costs), jnp.asarray(s), jnp.asarray(q), jstate),
         tc.compute_velocity_pred(tres.pred, torch.from_numpy(costs), torch.from_numpy(s),
                                  torch.from_numpy(q), tstate)),
    )
    for (jcmd, jst2), (tcmd, tst2) in cases:
        np.testing.assert_array_equal(tcmd.outcome.numpy(), np.asarray(jcmd.outcome))
        assert (tcmd.outcome.numpy() == 0).sum() >= B - 1       # the walled lane may fail
        for k in ("linear", "angular", "cost", "heading_error"):
            np.testing.assert_allclose(getattr(tcmd, k).numpy(), np.asarray(getattr(jcmd, k)),
                                       atol=1e-5, err_msg=k)
        np.testing.assert_array_equal(tst2.current_face.numpy(), np.asarray(jst2.current_face))
        assert (tcmd.linear.numpy() > 0).sum() >= B // 2


def test_extract_path_and_cost_match_reference():
    _, _, jm, tm, _, W = _case("rcm16")
    tp = tst.build_offset_plan(tm, W)
    seeds = torch.tensor([3, 100, 200])
    res = tst.batched_field_structured(tm, torch.from_numpy(W), tp, seeds)
    pred = res.pred
    starts = np.asarray([250, 17, 200])                 # the last one is its own goal
    path, valid = tsweeps.extract_path(pred, torch.from_numpy(starts), seeds, 40, chunk=16)
    vv = jnp.asarray(np.asarray(jm.vertices))
    for b in range(3):
        jp_, jv_ = jsweeps.extract_path(jnp.asarray(pred[b].numpy()), int(starts[b]),
                                        int(seeds[b]), 40)
        np.testing.assert_array_equal(path[b].numpy(), np.asarray(jp_))
        np.testing.assert_array_equal(valid[b].numpy(), np.asarray(jv_))
        np.testing.assert_allclose(
            float(tsweeps.path_cost(tm.vertices, path[b], valid[b])),
            float(jsweeps.path_cost(vv, jp_, jv_)), rtol=1e-6)
    assert int(valid[2].sum()) == 1 and int(valid[0].sum()) > 3
    rows = tsweeps.vector_rows_from_predecessors(tm, pred, torch.tensor([[0, 5], [9, 9], [1, 2]]))
    full = tsweeps.vector_map_from_predecessors(tm, pred)
    assert torch.equal(rows[1, 0], full[1, 9]) and torch.equal(rows[2, 1], full[2, 2])


def _server_config(NC, MC, PC, LC):
    return NC(
        mesh_map=MC(default_layer="combine", edge_cost_factor=FACTOR),
        planner=PC(cost_limit=COST_LIMIT),
        layers=(
            LC(name="steep", kind="steepness", params=(("threshold", 2.0),)),
            LC(name="obst", kind="obstacle"),
            LC(name="combine", kind="max_combination", inputs=("steep", "obst")),
        ),
    )


def _assert_server_plans_equal(tp, jp):
    """The classification exactly; the weights within one ulp: the reference
    server derives its slot weights with XLA, which contracts the edge-weight
    formula (sweeps.py:45) into other roundings than eager PyTorch and numpy
    (the port's host and device tables agree bit for bit, see
    test_offset_plan_and_refresh_match_reference)."""
    assert tp.offsets == jp.offsets and tp.coverage == jp.coverage
    for k, a in _plan_arrays(jp).items():
        if k in ("planes", "res_w"):
            got = getattr(tp, k).numpy()
            np.testing.assert_array_equal(np.isinf(got), np.isinf(a), err_msg=k)
            np.testing.assert_allclose(got, a, rtol=2.5e-7, err_msg=k)
        else:
            np.testing.assert_array_equal(getattr(tp, k).numpy(), a, err_msg=k)


def _assert_results_close(tr, jr):
    """As _assert_results_equal, with the fields within rtol 1e-6 for the
    one-ulp weights of _assert_server_plans_equal."""
    for k in ("outcome", "pred", "path_valid", "path_positions"):
        np.testing.assert_array_equal(getattr(tr, k).numpy(), np.asarray(getattr(jr, k)), err_msg=k)
    pot, ref = tr.potential.numpy(), np.asarray(jr.potential)
    np.testing.assert_array_equal(np.isinf(pot), np.isinf(ref))
    np.testing.assert_allclose(pot, ref, rtol=1e-6)
    np.testing.assert_allclose(tr.vector_map.numpy(), np.asarray(jr.vector_map), atol=1e-6)
    np.testing.assert_allclose(tr.cost.numpy(), np.asarray(jr.cost), rtol=1e-5)


def test_server_takes_the_structured_branch_like_reference():
    v, f, jm, tm, _, _ = _case("rcm16")
    js = JMeshNavServer(jm, _server_config(JNavConfig, JMeshMapConfig, JPlannerConfig,
                                           JLayerConfig), planner_kind="dijkstra", max_path_len=64)
    ts = MeshNavServer(tm, _server_config(NavConfig, MeshMapConfig, PlannerConfig, LayerConfig),
                       planner_kind="dijkstra", max_path_len=64, device="cpu")
    assert js.banded_plan is None and ts.banded_plan is None
    assert js.offset_plan.coverage > 0.5
    _assert_server_plans_equal(ts.offset_plan, js.offset_plan)
    s, g = _scenarios(jm, "rcm16", B=4)
    before = ts.get_path_batch(torch.from_numpy(s), torch.from_numpy(g))
    _assert_results_close(before, js.get_path_batch(jnp.asarray(s), jnp.asarray(g)))
    assert (before.outcome.numpy() == 0).all()
    # a sensor update: points 0.3 above the vertices nearest the middle
    rng = np.random.default_rng(4)
    ids = np.argsort(np.linalg.norm(v[:, :2] - v[:, :2].mean(0), axis=1))[:6]
    pts = (v[ids] + np.concatenate([rng.uniform(-0.05, 0.05, (6, 2)), np.full((6, 1), 0.3)], 1)
           ).astype(np.float32)
    js.update_point_cloud("obst", jnp.asarray(pts))
    ts.update_point_cloud("obst", torch.from_numpy(pts))
    # the layers' costs agree as in tests/test_torch_replan.py: the same
    # lethal set, the rest within 1e-6
    got, ref = ts.vertex_costs.numpy(), np.asarray(js.vertex_costs)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(ref))
    np.testing.assert_allclose(got[np.isfinite(ref)], ref[np.isfinite(ref)], rtol=0, atol=1e-6)
    assert np.isinf(got).sum() > 0
    _assert_server_plans_equal(ts.offset_plan, js.offset_plan)
    sw, jsw = ts.slot_weights.numpy(), np.asarray(js.slot_weights)
    np.testing.assert_array_equal(np.isinf(sw), np.isinf(jsw))
    np.testing.assert_allclose(sw, jsw, rtol=2.5e-7)
    after = ts.get_path_batch(torch.from_numpy(s), torch.from_numpy(g))
    _assert_results_close(after, js.get_path_batch(jnp.asarray(s), jnp.asarray(g)))
    assert not torch.equal(after.potential, before.potential)


@pytest.mark.parametrize("limit_below_row", [False, True])
def test_server_routes_plans_wider_than_the_pass_to_the_structured_tier(monkeypatch,
                                                                       limit_below_row):
    """A banded plan whose padded rows exceed the pass kernel's column limit
    (banded_gpu.PASS_MAX_COLS, lowered here so the 24 x 24 terrain crosses
    it) is not built: the server answers through the structured tier, as
    the planner's own structured path does. At the limit the plan stays."""
    from mesh_navigation_torch.ops import banded_gpu as tbg

    _, _, jm, tm, _, W = _case("terrain24")
    Cp = tbg.build_banded_kernel_plan(tm, W).n_cols_pad
    monkeypatch.setattr(tbg, "PASS_MAX_COLS", Cp - 8 if limit_below_row else Cp)
    ts = MeshNavServer(tm, _server_config(NavConfig, MeshMapConfig, PlannerConfig, LayerConfig),
                       planner_kind="dijkstra", max_path_len=64, device="cpu")
    s, g = _scenarios(jm, "terrain24", B=4)
    got = ts.get_path_batch(torch.from_numpy(s), torch.from_numpy(g))
    if not limit_below_row:
        assert ts.banded_plan is not None and ts.banded_plan.n_cols_pad == Cp
        assert got.potential is None and got.d_pad is not None
        return
    assert ts.planner.prepare_banded_plan(W) is None
    assert ts.banded_plan is None and ts.offset_plan.coverage > 0.5
    want = ts.planner.plan_batch_structured(ts.slot_weights, ts.offset_plan,
                                            torch.from_numpy(s), torch.from_numpy(g))
    assert got.potential is not None and got.d_pad is None
    assert torch.equal(got.potential, want.potential) and torch.equal(got.pred, want.pred)
    assert torch.equal(got.outcome, want.outcome)
    assert (got.outcome.numpy()[:-1] == 0).all()


def test_server_without_a_plan_raises():
    """A map with neither a banded nor an offset plan: get_path_batch takes
    the planner's plan_batch (it raised NotImplementedError until
    plan_batch was ported)."""
    v, f = synthetic.terrain_mesh(12, 12, spacing=0.5, hills=1.0, seed=2)
    ts = MeshNavServer(build_mesh(v, f, device="cpu"), NavConfig(), planner_kind="dijkstra",
                       device="cpu")
    assert ts.banded_plan is not None and ts.offset_plan is None
    # the map forgets its plans and keeps the slot weights, as it does for
    # a mesh without either plan
    ts.banded_plan = None
    ts.slot_weights = torch.from_numpy(tsweeps.slot_weights_np(
        ts.mesh, ts.vertex_costs.numpy(), cost_limit=ts.config.planner.cost_limit,
        edge_cost_factor=ts.config.mesh_map.edge_cost_factor))
    s, g = torch.zeros(1, 3), torch.ones(1, 3)
    got = ts.get_path_batch(s, g)
    want = ts.planner.plan_batch(ts.slot_weights, s, g)
    assert got.converged and bool((got.outcome == 0).all())
    assert torch.equal(got.potential, want.potential) and torch.equal(got.pred, want.pred)


def test_offset_plan_from_numpy_reproduces_reference_solve():
    _, _, jm, tm, _, W = _case("rcm16")
    jp = jst.build_offset_plan(jm, jnp.asarray(W))
    tp = convert.offset_plan_from_numpy(_plan_arrays(jp), {"offsets": jp.offsets,
                                                           "coverage": jp.coverage},
                                        device="cpu")
    _assert_plans_equal(tp, jp)
    seeds = np.asarray([0, 77, 150], np.int32)
    ref = jst.batched_field_structured(jm, jnp.asarray(W), jp, jnp.asarray(seeds))
    got = tst.batched_field_structured(tm, torch.from_numpy(W), tp, torch.from_numpy(seeds))
    np.testing.assert_array_equal(got.dist.numpy(), np.asarray(ref.dist))
    np.testing.assert_array_equal(got.pred.numpy(), np.asarray(ref.pred))
    with pytest.raises(ValueError, match="missing"):
        convert.offset_plan_from_numpy({}, {"offsets": jp.offsets}, device="cpu")
