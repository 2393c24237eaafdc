"""The banded solve's init_pad propagation mode and the hybrid CVP
transport (eikonal_solve_padded(graph_plan=...)) of the port, on the CPU.

init_pad is held against the min-plus closure of its start field: a heap
Dijkstra (scipy) from a super-source joined to every finite start label,
within the stopping tolerance atol + rtol*|d|. The hybrid field is held
against the port's plain rounds and the JAX package's gather solver
(eikonal.eikonal_field) within 0.5% (rtol 5e-3, atol 1e-3): the fixed
point of the unfolding update depends on the update order
(tests/test_torch_cvp.py), and the graph stage changes that order."""

import dataclasses

import numpy as np
import pytest
import torch
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import dijkstra

import jax.numpy as jnp

from mesh_navigation_tpu.mesh import synthetic
from mesh_navigation_tpu.ops import eikonal as jeik

from mesh_navigation_torch.config import PlannerConfig
from mesh_navigation_torch.mesh.arrays import build_mesh, host_array
from mesh_navigation_torch.ops import banded_gpu as bg
from mesh_navigation_torch.ops import eikonal_gpu as teg
from mesh_navigation_torch.ops import sweeps
from mesh_navigation_torch.planners import CVPPlanner

from test_torch_reference import reference_build_mesh

torch.set_num_threads(2)

ATOL, RTOL = 1e-5, 1e-5


def _graph(n=20, seed=3):
    v, f = synthetic.terrain_mesh(n, n, spacing=0.5, hills=1.5, roughness=0.02, seed=seed)
    mesh = build_mesh(v, f, device="cpu")
    rng = np.random.default_rng(seed)
    costs = rng.uniform(0.0, 0.6, mesh.num_vertices).astype(np.float32)
    costs[rng.integers(0, mesh.num_vertices, mesh.num_vertices // 30)] = np.inf
    W = sweeps.slot_weights_np(mesh, costs, cost_limit=2.0, edge_cost_factor=1.0)
    return mesh, W, bg.build_banded_kernel_plan(mesh, W)


def _closure(mesh, W, start):
    """Min-plus closure of a start field [V] over the slot-weight graph
    (in-edge adj[v, j] -> v of weight W[v, j]): a heap Dijkstra from a
    super-source joined to every finite start label (offset by 1, as the
    sparse graph drops zero weights)."""
    adj = host_array(mesh, "adj_vertex")
    ok = host_array(mesh, "adj_mask") & np.isfinite(W)
    V = adj.shape[0]
    dst, slot = np.nonzero(ok)
    fin = np.nonzero(np.isfinite(start))[0]
    rows = np.concatenate([adj[dst, slot], np.full(len(fin), V)])
    cols = np.concatenate([dst, fin])
    w = np.concatenate([W[dst, slot].astype(np.float64), start[fin].astype(np.float64) + 1.0])
    g = coo_matrix((w, (rows, cols)), shape=(V + 1, V + 1)).tocsr()
    return dijkstra(g, directed=True, indices=V)[:V] - 1.0


def test_init_pad_reaches_the_closure_of_its_start_field():
    mesh, W, plan = _graph()
    R, C, Cp, V = plan.n_rows, plan.n_cols, plan.n_cols_pad, plan.num_vertices
    rng = np.random.default_rng(0)
    B = 6                        # the solve's lanes pad to 8
    start = np.full((R + 3, Cp, 5), np.inf, np.float32)     # 3 rows and 3 lanes to conform
    for b in range(5):
        ids = rng.integers(0, V, 12)
        start[ids // C, ids % C, b] = rng.uniform(0.0, 5.0, 12)
    start[R:] = 1.0              # rows beyond the field are cut
    init = torch.from_numpy(start)
    kept = init.clone()
    res = bg.banded_solve_padded(plan, torch.full((B,), 7), atol=ATOL, rtol=RTOL,
                                 init_pad=init)
    assert res.converged and torch.equal(init, kept)
    assert tuple(res.d_pad.shape) == (R, Cp, 8)
    got = res.d_pad[:, :C].reshape(R * C, 8)[:V].numpy()
    assert np.isinf(got[:, 5:]).all()          # lanes the start lacked, and no seed injected
    for b in range(5):
        ref = _closure(mesh, W, start[:R, :C, b].reshape(-1)[:V])
        fin = np.isfinite(ref)
        assert fin.sum() > V // 2
        np.testing.assert_array_equal(np.isfinite(got[:, b]), fin)
        err = np.abs(got[fin, b] - ref[fin])
        assert np.all(err <= ATOL + RTOL * np.abs(ref[fin])), float(err.max())


@pytest.mark.parametrize("converge", ["round", "check"])
def test_init_pad_leaves_the_callers_field(converge):
    """Same shape as the solve's field: the solve still works on a copy,
    and a converged start field comes back within the tolerance (the
    forced first round writes the sub-tolerance gains it finds)."""
    _, _, plan = _graph(16, 5)
    seeds = torch.tensor([3, 77, 150, 201, 9, 40, 100, 180])
    d = bg.banded_solve_padded(plan, seeds, atol=ATOL, rtol=RTOL).d_pad
    kept = d.clone()
    res = bg.banded_solve_padded(plan, torch.zeros(8, dtype=torch.int64), atol=ATOL, rtol=RTOL,
                                 init_pad=d, converge=converge)
    assert res.converged and res.d_pad.data_ptr() != d.data_ptr()
    assert torch.equal(d, kept)
    fin = torch.isfinite(d)
    assert torch.equal(torch.isfinite(res.d_pad), fin)
    assert bool(((res.d_pad[fin] - d[fin]).abs() <= ATOL + RTOL * d[fin].abs()).all())
    with pytest.raises(ValueError):
        bg.banded_solve_padded(plan, seeds, init_pad=d, warm_d=d, converge="check")


def _cvp_problem():
    """The 12 x 12 terrain of tests/test_torch_cvp.py's orderings test, with
    the CVP planner's eikonal plan and its Dijkstra warm plan (the graph
    plan: the same side lengths, the CVP '>=' skip)."""
    v, f = synthetic.terrain_mesh(12, 12, spacing=0.5, hills=1.5, roughness=0.02, seed=4)
    jm, tm = reference_build_mesh(v, f), build_mesh(v, f, device="cpu")
    side = np.asarray(jm.edge_dist)
    planner = CVPPlanner(tm, PlannerConfig(cost_limit=2.0), device="cpu")
    plan = planner.prepare_eikonal_plan(side, np.zeros(tm.num_vertices, np.float32))
    assert plan is not None and planner._dij_plan is not None
    return jm, tm, side, plan, planner._dij_plan


def _assert_half_percent(got, ref):
    ok = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(got), ok)
    np.testing.assert_allclose(got[ok], ref[ok], rtol=5e-3, atol=1e-3)


@pytest.mark.parametrize("orderings", [4, 2])
def test_hybrid_field_matches_the_plain_rounds_and_the_reference(orderings, monkeypatch):
    jm, tm, side, plan, graph = _cvp_problem()
    seed_v = torch.tensor([[3, 4, 5], [100, 101, 99]])
    seed_d = torch.tensor([[0.1, 0.2, 0.15], [0.0, 0.3, 0.2]])
    kw = dict(atol=1e-6, rtol=1e-6, orderings=orderings)
    plain, _, c0 = teg.eikonal_field_banded(tm, plan, seed_v, seed_d, **kw)
    calls = []
    solve = bg.banded_solve_padded
    monkeypatch.setattr(bg, "banded_solve_padded",
                        lambda *a, **k: calls.append(k) or solve(*a, **k))
    hybrid, rounds, c1 = teg.eikonal_field_banded(tm, plan, seed_v, seed_d, graph_plan=graph,
                                                  **kw)
    assert c0 and c1
    assert len(calls) == rounds and all(k["max_rounds"] == 32 for k in calls)
    _assert_half_percent(hybrid.numpy(), plain.numpy())
    for b in range(2):
        keep = torch.isfinite(seed_d[b])
        sd = jnp.full(jm.num_vertices, jnp.inf).at[jnp.asarray(seed_v[b][keep].numpy())].set(
            jnp.asarray(seed_d[b][keep].numpy()))
        ref = np.asarray(jeik.eikonal_field(jm, jnp.asarray(side), sd, update="unfolding").dist)
        _assert_half_percent(hybrid[b].numpy(), ref)


def test_hybrid_graph_plan_must_share_the_eikonal_grid():
    _, _, _, plan, graph = _cvp_problem()
    seed_v, seed_d = torch.tensor([[3, 4, 5]]), torch.tensor([[0.1, 0.2, 0.15]])
    for bad in (dict(n_rows=graph.n_rows + 1), dict(n_cols=graph.n_cols - 1),
                dict(n_cols_pad=graph.n_cols_pad + 8)):
        with pytest.raises(ValueError):
            teg.eikonal_solve_padded(plan, seed_v, seed_d,
                                     graph_plan=dataclasses.replace(graph, **bad))
