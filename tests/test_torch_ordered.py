"""Port vs reference: the ordered and hybrid batch solves (ops/ordered.py),
DijkstraPlanner.plan_batch and the Dijkstra server's third branch, on a
24 x 24 jittered-Delaunay terrain whose vertex ids are permuted by a seeded
permutation (a scan's native order: no band structure, no offset classes).

Both sides get the same mesh tables (the reference's from its native core,
test_torch_reference.reference_build_mesh) and the same slot weights. The
solves add and compare f32 values in the same order, so fields are held
within 1e-6 relative (bit for bit is what they give); predecessors exactly
wherever the arg-min over the slots is unique, rounds and `converged`
equal. The servers derive their own slot weights (the reference's with
XLA, one ulp apart on some edges), so their fields and costs are held
within 1e-5 relative."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mesh_navigation_tpu.api.server import MeshNavServer as JServer
from mesh_navigation_tpu.config import LayerConfig as JLayerConfig
from mesh_navigation_tpu.config import MeshMapConfig as JMeshMapConfig
from mesh_navigation_tpu.config import NavConfig as JNavConfig
from mesh_navigation_tpu.config import PlannerConfig as JPlannerConfig
from mesh_navigation_tpu.mesh import synthetic
from mesh_navigation_tpu.ops import ordered as jordered
from mesh_navigation_tpu.planners import DijkstraPlanner as JDijkstraPlanner

from mesh_navigation_torch import convert
from mesh_navigation_torch.api.server import MeshNavServer
from mesh_navigation_torch.config import LayerConfig, MeshMapConfig, NavConfig, PlannerConfig
from mesh_navigation_torch.mesh.arrays import build_mesh, host_array
from mesh_navigation_torch.ops import ordered, sweeps
from mesh_navigation_torch.planners import DijkstraPlanner

from test_torch_reference import reference_build_mesh

torch.set_num_threads(2)

N = 24
COST_LIMIT = 2.0
SEEDS = np.asarray([5, 111, 233, 400, 17], np.int32)
MAX_PATH = 96


@functools.lru_cache(maxsize=None)
def _case():
    """(v, f, jm, tm, W): the permuted irregular terrain on both sides and
    its steepness slot weights (cost limit 2.0, edge cost factor 1.0)."""
    v, f = synthetic.irregular_terrain_mesh(N, N, spacing=0.5, jitter=0.45, hills=1.0, seed=1)
    perm = np.random.default_rng(7).permutation(len(v))      # new id -> old id
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(v))
    v, f = v[perm], inv[f].astype(np.int32)
    jm = reference_build_mesh(v, f)
    tm = build_mesh(v, f, device="cpu")
    costs = np.arccos(np.clip(host_array(tm, "vertex_normals")[:, 2], -1.0, 1.0))
    W = sweeps.slot_weights_np(tm, costs.astype(np.float32), cost_limit=COST_LIMIT,
                               edge_cost_factor=1.0)
    return v, f, jm, tm, W


def _unique_argmin(dist_bv, W, adj):
    """[B, V] True where the minimum over the slots of dist[adj] + w is
    taken by one slot only."""
    cand = dist_bv[:, adj] + W[None]                 # [B, V, D]
    best = cand.min(axis=2, keepdims=True)
    return (cand == best).sum(axis=2) == 1


def _same_field(got, ref):
    """Fields within 1e-6 relative, +inf where the reference's is."""
    got, ref = np.asarray(got), np.asarray(ref)
    fin = np.isfinite(ref)
    assert np.array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-6, atol=0)


def _same_result(got, ref, W, adj):
    _same_field(got.dist.numpy(), ref.dist)
    assert got.rounds == int(ref.rounds)
    assert got.converged == bool(ref.converged)
    uniq = _unique_argmin(np.asarray(ref.dist), W, adj)
    assert uniq.mean() > 0.5
    np.testing.assert_array_equal(got.pred.numpy()[uniq], np.asarray(ref.pred)[uniq])


@pytest.mark.parametrize("chunk", [0, 40])
@pytest.mark.parametrize("directions", [1, 2, 4, 8])
def test_sweep_plan_chunks_are_the_references(directions, chunk):
    _, _, jm, tm, _ = _case()
    jp = jordered.build_sweep_plan(jm, chunk=chunk, directions=directions)
    tp = ordered.build_sweep_plan(tm, chunk=chunk, directions=directions)
    assert tp.num_vertices == jp.num_vertices and tp.n_dir == jp.n_dir == directions
    np.testing.assert_array_equal(tp.chunks.numpy(), np.asarray(jp.chunks))


def test_ordered_field_matches_reference():
    _, _, jm, tm, W = _case()
    jp = jordered.build_sweep_plan(jm)
    tp = convert.sweep_plan_from_numpy(np.asarray(jp.chunks), jp.num_vertices, device="cpu")
    ref = jordered.batched_field_ordered(jm, jnp.asarray(W), jp, jnp.asarray(SEEDS))
    got = ordered.batched_field_ordered(tm, torch.from_numpy(W), tp, torch.from_numpy(SEEDS))
    assert got.converged and got.rounds > 1
    _same_result(got, ref, W, host_array(tm, "adj_vertex"))


@pytest.mark.parametrize("rounds", [0, 2])
@pytest.mark.parametrize("warm", [False, True])
def test_hybrid_field_matches_reference(rounds, warm):
    """ordered_rounds 0 and 2, cold and from an upper bound (the converged
    field raised by 0.5 with a few +inf rows), blocks of 16 sweeps."""
    _, _, jm, tm, W = _case()
    V = tm.num_vertices
    jp = jordered.build_sweep_plan(jm)
    tp = ordered.build_sweep_plan(tm) if rounds else None
    init = None
    if warm:
        cold = ordered.batched_field_hybrid(tm, torch.from_numpy(W), None,
                                            torch.from_numpy(SEEDS), ordered_rounds=0)
        init = np.full((V + 1, len(SEEDS)), np.inf, np.float32)
        init[:V] = cold.dist.numpy().T + 0.5
        init[np.arange(0, V, 37)] = np.inf
    kw = dict(ordered_rounds=rounds, block_sweeps=16)
    ref = jordered.batched_field_hybrid(jm, jnp.asarray(W), jp, jnp.asarray(SEEDS), **kw,
                                        init_vb=None if init is None else jnp.asarray(init))
    got = ordered.batched_field_hybrid(tm, torch.from_numpy(W), tp, torch.from_numpy(SEEDS), **kw,
                                       init_vb=None if init is None else torch.from_numpy(init))
    assert got.converged
    _same_result(got, ref, W, host_array(tm, "adj_vertex"))


def _scenarios(v, n=4, seed=3):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, len(v), (2, n))
    return v[idx[0]].astype(np.float32), v[idx[1]].astype(np.float32)


@pytest.mark.parametrize("method", ["batched", "jacobi"])
def test_plan_batch_matches_reference(method):
    v, _, jm, tm, W = _case()
    starts, goals = _scenarios(v)
    cfg = dict(cost_limit=COST_LIMIT, method=method, ordered_rounds=2 if method == "batched" else 0)
    jpl = JDijkstraPlanner(jm, JPlannerConfig(**cfg), max_path_len=MAX_PATH)
    tpl = DijkstraPlanner(tm, PlannerConfig(**cfg), max_path_len=MAX_PATH, device="cpu")
    assert (tpl.sweep_plan is None) == (method != "batched")
    ref = jpl.plan_batch(jnp.asarray(W), jnp.asarray(starts), jnp.asarray(goals))
    got = tpl.plan_batch(torch.from_numpy(W), torch.from_numpy(starts), torch.from_numpy(goals))
    _same_plan(got, ref, W, host_array(tm, "adj_vertex"), rtol=1e-6)


def _same_plan(got, ref, W, adj, rtol):
    np.testing.assert_array_equal(got.outcome.numpy(), np.asarray(ref.outcome))
    assert (got.outcome.numpy() == 0).all()
    pot = np.asarray(ref.potential)
    fin = np.isfinite(pot)
    assert np.array_equal(np.isfinite(got.potential.numpy()), fin)
    np.testing.assert_allclose(got.potential.numpy()[fin], pot[fin], rtol=rtol, atol=0)
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(ref.cost), rtol=max(rtol, 1e-6))
    uniq = _unique_argmin(pot, W, adj)
    np.testing.assert_array_equal(got.pred.numpy()[uniq], np.asarray(ref.pred)[uniq])
    valid = np.asarray(ref.path_valid)
    np.testing.assert_array_equal(got.path_valid.numpy(), valid)
    np.testing.assert_allclose(got.path_positions.numpy()[valid],
                               np.asarray(ref.path_positions)[valid], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.vector_map.numpy(), np.asarray(ref.vector_map), atol=1e-6)


def test_server_third_branch_matches_reference():
    """A Dijkstra server on the permuted mesh has neither a banded plan nor
    offset coverage above 0.5, so get_path_batch takes plan_batch (the
    default hybrid solve, no ordered rounds): the reference server's
    answer."""
    v, f, jm, tm, W = _case()
    starts, goals = _scenarios(v, n=5, seed=9)
    layers = (("steepness", "steepness"),)
    tsrv = MeshNavServer(tm, NavConfig(
        mesh_map=MeshMapConfig(edge_cost_factor=1.0),
        planner=PlannerConfig(cost_limit=COST_LIMIT),
        layers=tuple(LayerConfig(name=n, kind=k) for n, k in layers)),
        planner_kind="dijkstra", max_path_len=MAX_PATH, device="cpu")
    jsrv = JServer(jm, JNavConfig(
        mesh_map=JMeshMapConfig(edge_cost_factor=1.0),
        planner=JPlannerConfig(cost_limit=COST_LIMIT),
        layers=tuple(JLayerConfig(name=n, kind=k) for n, k in layers)),
        planner_kind="dijkstra", max_path_len=MAX_PATH)
    assert tsrv.banded_plan is None and tsrv.offset_plan.coverage <= 0.5
    assert jsrv.banded_plan is None and jsrv.offset_plan.coverage <= 0.5
    got = tsrv.get_path_batch(torch.from_numpy(starts), torch.from_numpy(goals))
    ref = jsrv.get_path_batch(jnp.asarray(starts), jnp.asarray(goals))
    assert got.converged
    _same_plan(got, ref, tsrv.slot_weights.numpy(), host_array(tm, "adj_vertex"), rtol=1e-5)
