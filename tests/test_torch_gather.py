"""The gather solvers and the single-goal planners of the port against the
reference, on the CPU (mesh_navigation_torch against mesh_navigation_tpu on
the same numpy inputs): the four triangle updates, eikonal_field,
batched_eikonal_field, cvp_vector_map, shortest_path_field, the single-point
queries, locate and mesh_ahead, CVPPlanner.plan_one / plan_batch,
DijkstraPlanner.plan_one, the controller's single-pose cycle, goal check and
rollout, and the rotate recovery.

Meshes: a 14 x 14 terrain and a band-reordered 12 x 12 irregular terrain,
both built by the reference's native core. The reference runs its jnp
functions; no Pallas kernel is involved. Tolerances:
- fields: dist rtol 1e-5 (1e-6 for shortest_path_field), as both iterate
  the same f32 expressions to the same fixed point; pred, cutting face,
  sweeps and converged exact. Two exceptions, both rounding-level: a late
  block whose only gains are rounding steps may run in one solver and not
  the other (then the sweeps differ by one block and the shorter solve
  already holds the longer one's field within 1e-5), and the batched
  solver's predecessors, recovered from the final field by the test
  best <= dist + 1e-6 (below one f32 step past |dist| = 8), are held where
  both find a winner and the best candidate beats the second by more than
  1e-5 relative; they may disagree on finding one only at that test's
  edge;
- θ is an arccos: near ±1 one rounding step of its argument (XLA contracts
  multiply-adds, torch does not) moves θ by up to ~4e-4, and the vector
  map's rotated unit vectors move as much. θ and vector maps are held
  within 1e-5 at 95% of the vertices and within 1e-3 at all of them;
- bary and positions within 1e-5; faces exact;
- plans: outcome and valid masks exact, positions within 1e-4, cost within
  rtol 1e-4, pose quaternions within 1e-3 (a pose faces along its segment,
  and the walk's last segment may be short); commands within 1e-5."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mesh_navigation_tpu.config import ControllerConfig as JControllerConfig
from mesh_navigation_tpu.config import PlannerConfig as JPlannerConfig
from mesh_navigation_tpu.control import MeshController as JMeshController
from mesh_navigation_tpu.control import recovery as jrecovery
from mesh_navigation_tpu.control import tracking as jtracking
from mesh_navigation_tpu.control.controller import _quat_mul as j_quat_mul
from mesh_navigation_tpu.control.controller import initial_state as j_initial_state
from mesh_navigation_tpu.mesh import query as jquery
from mesh_navigation_tpu.mesh import synthetic
from mesh_navigation_tpu.ops import eikonal as jeik
from mesh_navigation_tpu.ops import sweeps as jsweeps
from mesh_navigation_tpu.planners import CVPPlanner as JCVPPlanner
from mesh_navigation_tpu.planners import DijkstraPlanner as JDijkstraPlanner

from mesh_navigation_torch import convert
from mesh_navigation_torch.config import ControllerConfig, PlannerConfig
from mesh_navigation_torch.control import recovery
from mesh_navigation_torch.control import tracking
from mesh_navigation_torch.control.controller import MeshController, _quat_mul, initial_state
from mesh_navigation_torch.mesh import query
from mesh_navigation_torch.mesh.arrays import FIELDS, build_mesh
from mesh_navigation_torch.ops import eikonal as teik
from mesh_navigation_torch.ops import sweeps as tsweeps
from mesh_navigation_torch.planners import CVPPlanner, DijkstraPlanner

from test_torch_reference import reference_build_mesh

torch.set_num_threads(2)
MESHES = ["terrain14", "irregular12"]
UPDATES = ["unfolding", "sethian", "fmm", "with_s"]


def _meshes(kind):
    if kind == "terrain14":
        v, f = synthetic.terrain_mesh(14, 14, spacing=0.5, hills=1.5, roughness=0.02, seed=3)
        return reference_build_mesh(v, f), build_mesh(v, f, device="cpu")
    v, f = synthetic.irregular_terrain_mesh(12, 12, spacing=0.5, jitter=0.4, hills=1.0, seed=6)
    jm = reference_build_mesh(v, f, reorder=True)
    return jm, convert.mesh_from_numpy({k: np.asarray(getattr(jm, k)) for k in FIELDS},
                                       device="cpu")


def _costs(jm, seed=0, hi=1.05):
    costs = np.random.default_rng(seed).uniform(0.0, hi, jm.num_vertices).astype(np.float32)
    side = np.asarray(jsweeps.compute_edge_weights(jm, jnp.asarray(costs), 1.0))
    return costs, side


def _t(x):
    return torch.from_numpy(np.array(x))


def _assert_dist(got, ref, rtol):
    got, ref = np.asarray(got), np.asarray(ref)
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    assert fin.sum() > 0.5 * fin.size
    np.testing.assert_allclose(got[fin], ref[fin], rtol=rtol, atol=0)


def _assert_rotated(got, ref, keep=None):
    """θ fields or vector maps: within 1e-5 at 95% of the entries (where
    `keep`), within 1e-3 at all (the arccos conditioning, above)."""
    got, ref = np.asarray(got), np.asarray(ref)
    if keep is not None:
        got, ref = got[keep], ref[keep]
    err = np.abs(got - ref).reshape(len(got), -1).max(axis=1)
    assert np.mean(err <= 1e-5) >= 0.95, np.sort(err)[-10:]
    assert err.max() <= 1e-3, err.max()


def _assert_sweeps(got, ref, rerun):
    """Sweeps and converged equal, or one block apart where the extra block
    only moved labels by rounding steps: `rerun(n)` (the port's solve
    capped at n sweeps) then already gives the longer solve's field."""
    assert got.converged == bool(ref.converged)
    n_ref = int(ref.sweeps)
    if got.sweeps != n_ref:
        lo = min(got.sweeps, n_ref)
        assert abs(got.sweeps - n_ref) <= 8, (got.sweeps, n_ref)
        _assert_dist(rerun(lo).dist, got.dist, 1e-5)


def _winner_margins(jm, side, dist_vb, update="unfolding"):
    """On a [B, V] field: `unique`, where the best incident candidate beats
    the second by more than 1e-5 relative, and `edge`, where the winner
    test best <= dist + 1e-6 sits within 4 f32 rounding steps of its edge
    (past |dist| = 8 the 1e-6 is below one step)."""
    v1, v2, _, ea, eb, ec = (np.asarray(x) for x in jeik._face_corner_tables(jm))
    vf, vc = np.asarray(jm.vertex_faces), np.asarray(jm.vertex_face_corner)
    unique, edge = [], []
    for d in np.asarray(dist_vb):
        cand = np.asarray(jeik._UPDATE_FNS[update](
            *(jnp.asarray(x) for x in (d[v1], d[v2], side[ea], side[eb], side[ec]))).value)
        cv = np.sort(np.where(np.asarray(jm.vertex_faces_mask), cand[vf, vc], np.inf), axis=1)
        with np.errstate(invalid="ignore"):
            unique.append(cv[:, 1] - cv[:, 0] > 1e-5 * np.maximum(1.0, np.abs(cv[:, 0])))
            edge.append(np.abs(cv[:, 0] - d.astype(np.float64) - 1e-6)
                        <= 4 * np.spacing(np.abs(d)) + 1e-7)
    return np.stack(unique), np.stack(edge)


def _triangles(n=256, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 2.0, n).astype(np.float32)
    b = rng.uniform(0.5, 2.0, n).astype(np.float32)
    c = np.clip(rng.uniform(0.5, 2.0, n), np.abs(a - b) + 0.05, a + b - 0.05).astype(np.float32)
    u1 = rng.uniform(0.0, 3.0, n).astype(np.float32)
    u2 = rng.uniform(0.0, 3.0, n).astype(np.float32)
    u1[:12] = np.inf
    u2[12:20] = np.inf
    return u1, u2, a, b, c


@pytest.mark.parametrize("update", ["fmm", "with_s"])
def test_update_variants_match_reference(update):
    args = _triangles(seed=2)
    ref = jeik._UPDATE_FNS[update](*(jnp.asarray(x) for x in args))
    got = teik._UPDATE_FNS[update](*(torch.from_numpy(x) for x in args))
    rv, gv = np.asarray(ref.value), got.value.numpy()
    fin = np.isfinite(rv)
    np.testing.assert_array_equal(np.isfinite(gv), fin)
    np.testing.assert_allclose(gv[fin], rv[fin], rtol=1e-6, atol=0)
    np.testing.assert_array_equal(got.pred_is_v1.numpy(), np.asarray(ref.pred_is_v1))
    np.testing.assert_allclose(got.theta.numpy(), np.asarray(ref.theta), rtol=0, atol=1e-5)
    assert (np.abs(got.theta.numpy()) > 0).sum() > 20     # interior updates exist


@pytest.mark.parametrize("update", UPDATES)
@pytest.mark.parametrize("kind", MESHES)
def test_eikonal_field_matches_reference(kind, update):
    jm, tm = _meshes(kind)
    costs, side = _costs(jm)
    seed = np.full(jm.num_vertices, np.inf, np.float32)
    seed[np.asarray(jm.faces)[77]] = [0.1, 0.2, 0.15]
    mask = costs < 1.0
    ref = jeik.eikonal_field(jm, jnp.asarray(side), jnp.asarray(seed), update=update,
                             target_mask=jnp.asarray(mask))
    def run(max_sweeps=0):
        return teik.eikonal_field(tm, _t(side), _t(seed), update=update, target_mask=_t(mask),
                                  max_sweeps=max_sweeps)

    got = run()
    _assert_dist(got.dist, ref.dist, 1e-5)
    np.testing.assert_array_equal(got.pred.numpy(), np.asarray(ref.pred))
    np.testing.assert_array_equal(got.cutting_face.numpy(), np.asarray(ref.cutting_face))
    _assert_rotated(got.theta, ref.theta)
    _assert_sweeps(got, ref, run)
    assert got.converged and got.pred.dtype == torch.int32


def test_eikonal_field_stops_at_max_sweeps():
    jm, tm = _meshes("terrain14")
    _, side = _costs(jm)
    seed = np.full(jm.num_vertices, np.inf, np.float32)
    seed[np.asarray(jm.faces)[77]] = [0.1, 0.2, 0.15]
    ref = jeik.eikonal_field(jm, jnp.asarray(side), jnp.asarray(seed), max_sweeps=5,
                             block_sweeps=4)
    got = teik.eikonal_field(tm, _t(side), _t(seed), max_sweeps=5, block_sweeps=4)
    assert got.sweeps == int(ref.sweeps) == 8 and not got.converged and not bool(ref.converged)
    _assert_dist(got.dist[np.isfinite(np.asarray(ref.dist))],
                 np.asarray(ref.dist)[np.isfinite(np.asarray(ref.dist))], 1e-5)


@pytest.mark.parametrize("kind", MESHES)
def test_batched_eikonal_field_and_vector_map_match_reference(kind):
    jm, tm = _meshes(kind)
    costs, side = _costs(jm, seed=1)
    faces = np.asarray(jm.faces)
    seeds = np.full((3, jm.num_vertices), np.inf, np.float32)
    for b, fi in enumerate([10, 100, 150]):
        seeds[b, faces[fi]] = [0.1, 0.2, 0.3]
    mask = costs < 1.0
    ref = jeik.batched_eikonal_field(jm, jnp.asarray(side), jnp.asarray(seeds),
                                     target_mask=jnp.asarray(mask))
    def run(max_sweeps=0):
        return teik.batched_eikonal_field(tm, _t(side), _t(seeds), target_mask=_t(mask),
                                          max_sweeps=max_sweeps)

    got = run()
    _assert_dist(got.dist, ref.dist, 1e-5)
    _assert_sweeps(got, ref, run)
    unique, edge = _winner_margins(jm, side, ref.dist)
    has_got, has_ref = got.cutting_face.numpy() >= 0, np.asarray(ref.cutting_face) >= 0
    assert not (has_got != has_ref)[~edge].any()       # winners found alike off the edge
    keep = unique & (has_got == has_ref)
    assert keep.mean() > 0.7
    for k in ("pred", "cutting_face"):
        np.testing.assert_array_equal(getattr(got, k).numpy()[keep],
                                      np.asarray(getattr(ref, k))[keep])
    same = got.pred.numpy() == np.asarray(ref.pred)
    _assert_rotated(got.theta, ref.theta, same)
    vm = teik.cvp_vector_map(tm, got).numpy()                     # [B, V, 3]
    ref_vm = np.stack([np.asarray(jeik.cvp_vector_map(jm, jeik.EikonalResult(
        ref.dist[b], ref.pred[b], ref.theta[b], ref.cutting_face[b], ref.sweeps,
        ref.converged))) for b in range(3)])
    _assert_rotated(vm, ref_vm, same)
    assert (np.abs(vm).sum(-1) > 0).mean() > 0.5


@pytest.mark.parametrize("kind", MESHES)
def test_shortest_path_field_matches_reference(kind):
    jm, tm = _meshes(kind)
    costs, side = _costs(jm, seed=2, hi=1.2)
    costs[[37, 90]] = 0.2                               # the seeds relax out
    W = np.asarray(jsweeps.slot_weights(jm, jnp.asarray(side), jnp.asarray(costs), 1.0))
    for seed_v, kw in ((37, {}), (90, {"block_sweeps": 3})):
        ref = jsweeps.shortest_path_field(jm, jnp.asarray(W), seed_v, **kw)
        got = tsweeps.shortest_path_field(tm, _t(W), seed_v, **kw)
        _assert_dist(got.dist, ref.dist, 1e-6)
        np.testing.assert_array_equal(got.pred.numpy(), np.asarray(ref.pred))
        assert got.sweeps == int(ref.sweeps) and got.converged and bool(ref.converged)


def _query_points(jm, n=24, seed=0):
    """Points inside faces, lifted off the surface, plus two off the map."""
    rng = np.random.default_rng(seed)
    vp, faces = np.asarray(jm.vertices), np.asarray(jm.faces)
    fi = rng.integers(0, len(faces), n)
    w = rng.dirichlet([2.0, 2.0, 2.0], n).astype(np.float32)
    p = np.einsum("nk,nkd->nd", w, vp[faces[fi]])
    p[:, 2] += rng.uniform(-0.1, 0.1, n)
    far = vp.max(0) + np.asarray([5.0, 5.0, 0.0])
    return np.concatenate([p, far[None], (vp.min(0) - 3.0)[None]]).astype(np.float32), fi


@pytest.mark.parametrize("kind", MESHES)
def test_single_queries_and_locate_match_reference(kind):
    jm, tm = _meshes(kind)
    jgrid, tgrid = jquery.build_grid(jm), query.build_grid(tm)
    pts, fi = _query_points(jm)
    nbr = np.asarray(jm.face_neighbors)
    found_some = 0
    for i, p in enumerate(pts):
        jp, tp = jnp.asarray(p), torch.from_numpy(p)
        rv, rd = jquery.nearest_vertex(jm, jgrid, jp)
        gv, gd = query.nearest_vertex(tm, tgrid, tp)
        assert int(gv) == int(rv) and abs(float(gd) - float(rd)) <= 1e-6 * (1 + float(rd))
        ref = jquery.containing_face(jm, jgrid, jp)
        got = query.containing_face(tm, tgrid, tp)
        assert int(got[0]) == int(ref[0]) and bool(got[3]) == bool(ref[3])
        np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), atol=1e-5)
        found_some += bool(ref[3])
        start = int(fi[i % len(fi)])
        for face in (start, int(nbr[start, 0]), 0):
            ref = jquery.neighbour_face_search(jm, jp, jnp.int32(face))
            got = query.neighbour_face_search(tm, tp, torch.tensor(face))
            assert int(got[0]) == int(ref[0]) and bool(got[2]) == bool(ref[2])
            np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), atol=1e-5)
            for cur in (face, -1):
                rfix = jtracking.locate(jm, jgrid, jp, jnp.int32(cur))
                gfix = tracking.locate(tm, tgrid, tp, torch.tensor(cur))
                assert int(gfix.face) == int(rfix.face) and bool(gfix.found) == bool(rfix.found)
                np.testing.assert_allclose(gfix.bary.numpy(), np.asarray(rfix.bary), atol=1e-5)
                np.testing.assert_allclose(gfix.position.numpy(), np.asarray(rfix.position),
                                           atol=1e-5)
    assert found_some >= len(pts) - 4


@pytest.mark.parametrize("kind", MESHES)
def test_mesh_ahead_matches_reference(kind):
    jm, tm = _meshes(kind)
    jgrid, tgrid = jquery.build_grid(jm), query.build_grid(tm)
    rng = np.random.default_rng(5)
    V = jm.num_vertices
    field = rng.normal(size=(V, 3)).astype(np.float32)
    field[:, 2] *= 0.1
    field /= np.linalg.norm(field, axis=1, keepdims=True)
    field[::9] = 0.0                                    # vertices with no direction
    layer = (0.3 * rng.normal(size=(V, 3))).astype(np.float32)
    pts, fi = _query_points(jm, n=16, seed=1)
    moved = 0
    for p, face in zip(pts, list(fi) + [-1, -1]):
        for lv in (None, layer):
            ref = jtracking.mesh_ahead(jm, jgrid, jnp.asarray(field), jnp.asarray(p),
                                       jnp.int32(face), 0.4,
                                       layer_vectors=None if lv is None else jnp.asarray(lv))
            got = tracking.mesh_ahead(tm, tgrid, _t(field), torch.from_numpy(p),
                                      torch.tensor(int(face)), 0.4,
                                      layer_vectors=None if lv is None else _t(lv))
            assert int(got[1]) == int(ref[1]) and bool(got[2]) == bool(ref[2])
            np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=1e-5)
            moved += bool(ref[2])
    assert moved > 16


def _scenario_vertices(jm, B, seed):
    return np.random.default_rng(seed).integers(0, jm.num_vertices, 2 * B)


def _scenarios(jm, B, seed):
    """Starts and goals at vertices, 0.05 above the surface (the containing
    face search needs poses on the surface)."""
    ids = _scenario_vertices(jm, B, seed)
    p = (np.asarray(jm.vertices)[ids] + np.asarray([0.0, 0.0, 0.05])).astype(np.float32)
    return p[:B], p[B:]


def _assert_plans_close(got, ref, *, potential=True):
    np.testing.assert_array_equal(np.asarray(got.outcome), np.asarray(ref.outcome))
    np.testing.assert_array_equal(got.path_valid.numpy(), np.asarray(ref.path_valid))
    np.testing.assert_allclose(got.path_positions.numpy(), np.asarray(ref.path_positions),
                               atol=1e-4)
    ok = np.asarray(ref.path_valid)
    np.testing.assert_allclose(got.path_quats.numpy()[ok], np.asarray(ref.path_quats)[ok],
                               atol=1e-3)
    gc, rc = got.cost.numpy(), np.asarray(ref.cost)
    np.testing.assert_array_equal(np.isfinite(gc), np.isfinite(rc))
    np.testing.assert_allclose(gc[np.isfinite(rc)], rc[np.isfinite(rc)], rtol=1e-4)
    if potential:
        _assert_dist(got.potential, ref.potential, 1e-5)
        np.testing.assert_array_equal(got.pred.numpy(), np.asarray(ref.pred))
        _assert_rotated(got.vector_map.reshape(-1, 3), np.asarray(ref.vector_map).reshape(-1, 3))


def _cvp_planners(jm, tm, max_path_len=96):
    jp = JCVPPlanner(jm, JPlannerConfig(cost_limit=1.0), max_path_len=max_path_len)
    tp = CVPPlanner(tm, PlannerConfig(cost_limit=1.0), max_path_len=max_path_len, device="cpu")
    return jp, tp


@pytest.mark.parametrize("kind", MESHES)
def test_cvp_plan_one_matches_reference(kind):
    jm, tm = _meshes(kind)
    costs, side = _costs(jm, seed=3, hi=1.1)
    jp, tp = _cvp_planners(jm, tm)
    starts, goals = _scenarios(jm, 3, seed=4)
    layer = (0.2 * np.random.default_rng(6).normal(size=(jm.num_vertices, 3))).astype(np.float32)
    reached = 0
    for s, g, lv in zip(starts, goals, (None, layer, None)):
        ref = jp.plan_one(jnp.asarray(side), jnp.asarray(costs), jnp.asarray(s), jnp.asarray(g),
                          layer_vectors=None if lv is None else jnp.asarray(lv))
        got = tp.plan_one(_t(side), _t(costs), torch.from_numpy(s), torch.from_numpy(g),
                          layer_vectors=None if lv is None else _t(lv))
        _assert_plans_close(got, ref)
        assert got.path_positions.shape == (96, 3) and got.outcome.shape == ()
        reached += int(got.outcome) == 0
    assert reached >= 2
    # a goal off the map: INVALID_GOAL, no path
    off = np.asarray(jm.vertices).max(0) + 5.0
    got = tp.plan_one(_t(side), _t(costs), torch.from_numpy(starts[0]), _t(off))
    assert int(got.outcome) == 53 and not bool(got.path_valid.any())


@pytest.mark.parametrize("kind", MESHES)
def test_cvp_plan_batch_matches_reference(kind):
    jm, tm = _meshes(kind)
    costs, side = _costs(jm, seed=7, hi=1.1)
    jp, tp = _cvp_planners(jm, tm, max_path_len=64)
    starts, goals = _scenarios(jm, 4, seed=8)
    goals[3] = np.asarray(jm.vertices).max(0) + 5.0          # off the map
    ref = jp.plan_batch(jnp.asarray(side), jnp.asarray(costs), jnp.asarray(starts),
                        jnp.asarray(goals))
    got = tp.plan_batch(_t(side), _t(costs), torch.from_numpy(starts), torch.from_numpy(goals))
    _assert_plans_close(got, ref)
    assert got.converged and got.rounds > 1
    assert got.outcome[3] == 53 and (got.outcome[:3] == 0).sum() >= 2


@pytest.mark.parametrize("kind", MESHES)
def test_dijkstra_plan_one_matches_reference(kind):
    jm, tm = _meshes(kind)
    costs, _ = _costs(jm, seed=9, hi=1.2)
    starts, goals = _scenarios(jm, 3, seed=10)
    costs[_scenario_vertices(jm, 3, seed=10)] = 0.2     # snap vertices relax out
    jp = JDijkstraPlanner(jm, JPlannerConfig(cost_limit=1.0), max_path_len=64)
    tp = DijkstraPlanner(tm, PlannerConfig(cost_limit=1.0), max_path_len=64, device="cpu")
    W = tp.prepare_weights(_t(costs), 1.0)
    np.testing.assert_array_equal(
        W.numpy(), np.asarray(jp.prepare_weights(jnp.asarray(costs), 1.0)))
    starts, goals = _scenarios(jm, 3, seed=10)
    for s, g in zip(starts, goals):
        ref = jp.plan_one(jnp.asarray(W.numpy()), jnp.asarray(s), jnp.asarray(g))
        got = tp.plan_one(W, torch.from_numpy(s), torch.from_numpy(g))
        _assert_plans_close(got, ref)
    assert tp.cancel() and tp._cancel and JDijkstraPlanner.cancel(jp)


def test_single_pose_cycle_goal_check_and_rollout_match_reference():
    jm, tm = _meshes("terrain14")
    costs, side = _costs(jm, seed=11, hi=0.9)
    jp, tp = _cvp_planners(jm, tm)
    s, g = _scenarios(jm, 1, seed=12)
    plan = tp.plan_one(_t(side), _t(costs), torch.from_numpy(s[0]), torch.from_numpy(g[0]))
    assert int(plan.outcome) == 0
    vm = plan.vector_map
    jc = JMeshController(jm, JControllerConfig())
    tc = MeshController(tm, ControllerConfig(), device="cpu")
    quat = np.asarray([0.0, 0.0, np.sin(0.3), np.cos(0.3)], np.float32)
    jst = j_initial_state(jnp.asarray(g[0]), jnp.asarray([1.0, 0.0, 0.0]))
    tst = initial_state(torch.from_numpy(g[0]), torch.tensor([1.0, 0.0, 0.0]))
    assert tst.current_face.shape == ()
    pos = s[0]
    for _ in range(3):
        rc, jst = jc.compute_velocity(jnp.asarray(vm.numpy()), jnp.asarray(costs),
                                      jnp.asarray(pos), jnp.asarray(quat), jst)
        gc, tst = tc.compute_velocity(vm, _t(costs), torch.from_numpy(pos),
                                      torch.from_numpy(quat), tst)
        for k in ("linear", "angular", "cost", "heading_error"):
            np.testing.assert_allclose(getattr(gc, k).numpy(), np.asarray(getattr(rc, k)),
                                       atol=1e-5, err_msg=k)
        assert int(gc.outcome) == int(rc.outcome) == 0
        assert int(tst.current_face) == int(jst.current_face) >= 0
        pos = pos + np.asarray([0.05, 0.02, 0.0], np.float32)
    for tol in ((0.2, 0.5), (100.0, 3.2), (100.0, 0.1)):
        ref = jc.is_goal_reached(jnp.asarray(pos), jnp.asarray(quat), jst, *tol)
        assert bool(tc.is_goal_reached(torch.from_numpy(pos), torch.from_numpy(quat), tst, *tol)
                    ) == bool(ref)
    traj_r, cmds_r, st_r = jc.rollout(jnp.asarray(vm.numpy()), jnp.asarray(costs),
                                      jnp.asarray(s[0]), jnp.asarray(quat), jst, 24)
    traj_g, cmds_g, st_g = tc.rollout(vm, _t(costs), torch.from_numpy(s[0]),
                                      torch.from_numpy(quat), tst, 24)
    np.testing.assert_allclose(traj_g.numpy(), np.asarray(traj_r), atol=1e-4)
    np.testing.assert_allclose(cmds_g.angular.numpy(), np.asarray(cmds_r.angular), atol=1e-4)
    np.testing.assert_array_equal(cmds_g.outcome.numpy(), np.asarray(cmds_r.outcome))
    assert int(st_g.current_face) == int(st_r.current_face)


def test_quat_mul_and_rotate_in_place_match_reference():
    rng = np.random.default_rng(13)
    q = rng.normal(size=(2, 5, 4)).astype(np.float32)
    np.testing.assert_allclose(_quat_mul(_t(q[0]), _t(q[1])).numpy(),
                               np.asarray(j_quat_mul(jnp.asarray(q[0]), jnp.asarray(q[1]))),
                               atol=1e-5)
    o = q[0, 0] / np.linalg.norm(q[0, 0])
    for params in (recovery.RotateRecovery(), recovery.RotateRecovery(1.0, 1.0, 0.1)):
        jparams = jrecovery.RotateRecovery(*params)
        rl, ra, rq = jrecovery.rotate_in_place(jparams, jnp.asarray(o))
        gl, ga, gq = recovery.rotate_in_place(params, _t(o))
        assert gl.shape == rl.shape and gq.shape == rq.shape
        np.testing.assert_array_equal(ga.numpy(), np.asarray(ra))
        np.testing.assert_allclose(gq.numpy(), np.asarray(rq), atol=1e-5)
