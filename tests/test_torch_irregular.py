"""Port vs reference: irregular (residual) meshes through the banded solver.

Jittered-Delaunay terrains, band-reordered, have edges outside the eight
banded classes: the extended lanes relax the frequent leftover offsets
inside the pass, and a residual scatter-min relaxes every leftover edge
after each round. The reference runs its Pallas kernels in interpret mode
on the CPU; the port runs the plain PyTorch versions its wrappers take for
CPU tensors. Reference meshes come from
test_torch_reference.reference_build_mesh.

Tolerances. Passes and solves agree within the stopping tolerance
atol + rtol*|d| (the port scans base = row0 where the reference drops
sub-tolerance gains, and rows past 32 columns associate the scan's sums
differently); solves are held against the heap Dijkstra oracle within
rtol = atol = 1e-3, as tests/test_irregular.py holds the reference. Fed
one and the same padded field, the predecessor tables, res_choice and the
decoded paths are compared exactly where the argmin is unique; path costs
within 1e-3 relative. The roll-based predecessors_banded, fed the
reference's field, is compared exactly but where the reference's
residual scatter-set depends on its list order (ROADMAP "Departures")."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mesh_navigation_tpu.config import PlannerConfig as JPlannerConfig
from mesh_navigation_tpu.mesh import reorder as jreorder
from mesh_navigation_tpu.mesh import synthetic
from mesh_navigation_tpu.mesh.arrays import host_array as jhost_array
from mesh_navigation_tpu.ops import pallas_banded as jpb
from mesh_navigation_tpu.ops import sweeps as jsweeps
from mesh_navigation_tpu.planners import DijkstraPlanner as JDijkstraPlanner

from mesh_navigation_torch.api.server import MeshNavServer
from mesh_navigation_torch.config import (
    LayerConfig, MeshMapConfig, NavConfig, PlannerConfig,
)
from mesh_navigation_torch.mesh import reorder as treorder
from mesh_navigation_torch.mesh.arrays import host_array
from mesh_navigation_torch.ops import banded as tbanded
from mesh_navigation_torch.ops import banded_gpu as tbg
from mesh_navigation_torch.planners import DijkstraPlanner
from mesh_navigation_torch.utils import oracle

import roll_pred_checks as checks
from test_torch_reference import reference_build_mesh

torch.set_num_threads(2)

ATOL, RTOL = 1e-4, 2e-3
COST_LIMIT = 2.0
# (n, seed): 32 x 32 seed 4 has the lanes (2, 0), (0, -2), (0, 2); 40 x 40
# seed 2 adds a lane of the carried row (1, 2) and shifts of 3
MESHES = {"irr32": (32, 4), "irr40": (40, 2)}
SEEDS = np.asarray([5, 111, 233, 207, 900, 17, 600, 1000, 3], np.int32)


@functools.lru_cache(maxsize=None)
def _case(kind):
    """(v, jm, tm, costs, W, jplan, tplan): the reordered mesh on both
    sides, seeded costs, slot weights and both plans."""
    n, seed = MESHES[kind]
    v, f = synthetic.irregular_terrain_mesh(n, n, spacing=0.5, hills=1.0, seed=seed)
    jm = reference_build_mesh(v, f, reorder=True)
    tm = treorder.build_reordered_mesh(v, f, device="cpu")
    rng = np.random.default_rng(3)
    costs = rng.uniform(0.0, 0.6, tm.num_vertices).astype(np.float32)
    W = jsweeps.slot_weights_np(jm, costs, cost_limit=COST_LIMIT, edge_cost_factor=1.0)
    return (host_array(tm, "vertices"), jm, tm, costs, W,
            jpb.build_banded_kernel_plan(jm, W), tbg.build_banded_kernel_plan(tm, W))


@functools.lru_cache(maxsize=None)
def _ref_field(kind):
    """The reference's converged padded field of SEEDS (quiet round)."""
    *_, jplan, _ = _case(kind)
    res = jpb.banded_solve_padded(jplan, jnp.asarray(SEEDS), atol=ATOL, rtol=RTOL)
    assert bool(res.converged)
    return np.array(res.d_pad)


def _within(got, ref, k=1.0):
    fin = np.isfinite(ref)
    assert np.array_equal(fin, np.isfinite(got))
    err = np.abs(got[fin] - ref[fin])
    assert np.all(err <= k * (ATOL + RTOL * np.abs(ref[fin]))), float(err.max())


def _oracle_fields(jm, tm, costs, seeds):
    """The port's heap oracle on the port's mesh with the reference's edge
    weights."""
    adj = oracle.mesh_adjacency(tm)
    ew = np.asarray(jsweeps.compute_edge_weights(jm, jnp.asarray(costs), 1.0))
    return [oracle.dijkstra_oracle(tm.num_vertices, adj, ew, costs, int(s), COST_LIMIT)[0]
            for s in seeds]


@pytest.mark.parametrize("method", ["band", "rcm"])
def test_reorder_matches_reference(method):
    """Permutations, relabelled faces and band_hint equal the reference's;
    the band order's plans, built from the hint, are structurally equal."""
    v, f = synthetic.irregular_terrain_mesh(24, 20, spacing=0.5, hills=1.0, seed=6)
    v2j, f2j, hj = jreorder.reorder_mesh(v, f, method=method)
    v2t, f2t, ht = treorder.reorder_mesh(v, f, method=method)
    assert ht == hj and (ht > 0) == (method == "band")
    np.testing.assert_array_equal(v2t, v2j)
    np.testing.assert_array_equal(f2t, f2j)
    if method == "band":
        perm_j, n_j = jreorder.band_order(v)
        perm_t, n_t = treorder.band_order(v)
    else:
        edges = np.unique(np.sort(np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]]),
                                  axis=1), axis=0)
        perm_j, perm_t = jreorder.rcm_order(edges, len(v)), treorder.rcm_order(edges, len(v))
        n_j = n_t = 0
    np.testing.assert_array_equal(perm_t, perm_j)
    assert n_t == n_j
    if method != "band":
        return
    jm = reference_build_mesh(v, f, reorder=True)
    tm = treorder.build_reordered_mesh(v, f, device="cpu")
    assert int(host_array(tm, "band_hint")) == hj == tbanded.infer_band_width(tm)
    assert int(tm.to("cpu").host["band_hint"]) == hj
    W = jsweeps.slot_weights_np(jm, np.zeros(len(v), np.float32), cost_limit=COST_LIMIT,
                                edge_cost_factor=1.0)
    jp, tp = jpb.build_banded_kernel_plan(jm, W), tbg.build_banded_kernel_plan(tm, W)
    for k in tbg.PLAN_META:
        want = getattr(jp, k)
        assert getattr(tp, k) == (tuple(want) if k.startswith("xlanes") else want), k
    for k in ("slot_map", "res_dst", "res_src", "res_row_map", "res_jump"):
        np.testing.assert_array_equal(getattr(tp, k).numpy(), np.asarray(getattr(jp, k)), k)
    np.testing.assert_array_equal(np.asarray(jhost_array(jm, "faces")), host_array(tm, "faces"))


def test_extended_lane_cases_cover_every_source_row():
    """The pass cases below hold lanes of all three kinds: the row's own
    values (sel 0), the carried row (sel 1), the second carried row (sel 2)."""
    sels = set()
    for kind in MESHES:
        *_, tplan = _case(kind)
        assert tplan.n_residual > 0
        sels |= {sel for sel, _ in tplan.xlanes_down + tplan.xlanes_up}
    assert sels == {0, 1, 2}


@pytest.mark.parametrize("kind", list(MESHES))
def test_extended_lane_pass_plain_matches_pallas_interpret(kind):
    """A forced down pass and a dirty-driven up pass with the plan's
    extended lanes, from the seeded field: the plain pass against the
    reference's _directional_pass_pallas in interpret mode, fields within
    the stopping tolerance, flags equal."""
    *_, jplan, tplan = _case(kind)
    jprob = jpb.prepare_padded(jplan, jnp.asarray(SEEDS), rb=2, bb=8)
    tprob = tbg.prepare_padded(tplan, torch.from_numpy(SEEDS), rb=2, bb=8)
    for name in ("d0", "down", "up", "xdown", "xup"):
        np.testing.assert_array_equal(getattr(tprob, name).numpy(),
                                      np.asarray(getattr(jprob, name)), name)
    Rp, _, Bp = tprob.d0.shape
    d_j, d_t = jprob.d0, tprob.d0.clone()
    dirty_j = jnp.zeros((Bp // 8, Rp), jnp.int32)
    dirty_t = torch.zeros((Bp // 8, Rp), dtype=torch.int32)
    for reverse, force in ((False, True), (True, False)):
        name = "up" if reverse else "down"
        xlanes = getattr(tplan, f"xlanes_{name}")
        d_j, chg_j, dirty_j = jpb._directional_pass_pallas(
            d_j, getattr(jprob, name), jprob.a_fwd, jprob.a_bwd, getattr(jprob, f"x{name}"),
            jprob.l2_fwd, jprob.l2_bwd, jprob.wback, dirty_j, reverse=reverse, rb=2, bb=8,
            n_scan=jprob.a_fwd.shape[1], n_scan2=jplan.n_scan2, atol=ATOL, rtol=RTOL,
            interpret=True, skip=True, force=force, use_dirty=True, xlanes=tuple(xlanes),
        )
        chg_t = tbg.directional_pass(
            d_t, getattr(tprob, name), tprob.a_fwd, tprob.a_bwd, reverse=reverse, bb=8,
            atol=ATOL, rtol=RTOL, force=force, dirty=dirty_t,
            xcross=getattr(tprob, f"x{name}"), xlanes=xlanes,
        )
        assert bool(chg_t.item()) == bool(chg_j)
        _within(d_t.numpy(), np.asarray(d_j))


@pytest.mark.parametrize("kind", list(MESHES))
def test_extended_lane_plain_pass_walks_two_rows_after_a_needed_row(kind):
    """The plain pass's rows walked with the dirty table: needed rows, the
    row after each and, where a lane has sel 2, the second row after."""
    *_, tplan = _case(kind)
    prob = tbg.prepare_padded(tplan, torch.from_numpy(SEEDS))
    Rp, _, Bp = prob.d0.shape
    nb = Bp // 8
    d = tbg.banded_solve_padded(tplan, torch.from_numpy(SEEDS), atol=ATOL, rtol=RTOL).d_pad
    d[10] = torch.where(torch.isfinite(d[10]), d[10] + 1.0, d[10])
    dirty = torch.zeros((nb, Rp), dtype=torch.int32)
    dirty[:, 20] = 1
    walked = torch.zeros(1, dtype=torch.int64)
    before = d.clone()
    tbg.directional_pass(d, prob.down, prob.a_fwd, prob.a_bwd, reverse=False, atol=ATOL,
                         rtol=RTOL, dirty=dirty, rows_walked=walked, xcross=prob.xdown,
                         xlanes=tplan.xlanes_down)
    assert not torch.equal(d[10], before[10])
    extra = 2 if tbg.pass_needs_two_rows(tplan.xlanes_down) else 1
    assert 2 * (1 + extra) <= int(walked) / nb < Rp / 2


@pytest.mark.parametrize("converge", ["round", "check"])
def test_residual_solve_matches_reference_and_oracle(converge):
    """The port's residual solve (extended lanes, dirty passes, residual
    scatter-min) against the reference's banded_solve_padded and the heap
    oracle (rtol = atol = 1e-3), converged."""
    v, jm, tm, costs, W, jplan, tplan = _case("irr32")
    res = tbg.banded_solve_padded(tplan, torch.from_numpy(SEEDS), atol=ATOL, rtol=RTOL,
                                  converge=converge)
    assert res.converged and res.rounds > 1
    ref = _ref_field("irr32")
    d = res.d_pad.numpy()
    _within(d, ref, k=2.0)
    R, C, V = tplan.n_rows, tplan.n_cols, tplan.num_vertices
    dist = d[:R, :C, :len(SEEDS)].reshape(R * C, -1)[:V]
    for b, od in enumerate(_oracle_fields(jm, tm, costs, SEEDS[:3])):
        np.testing.assert_allclose(dist[:, b], od, rtol=1e-3, atol=1e-3)
    assert tbg.check_converged_banded(tplan, res.d_pad, atol=ATOL, rtol=RTOL)
    assert bool(jpb.check_converged_banded(jplan, jnp.asarray(d), atol=ATOL, rtol=RTOL,
                                           interpret=True))
    # a residual edge lowered below its fixed point fails the certificate
    bad = res.d_pad.clone().view(-1, res.d_pad.shape[2])
    e = int(torch.nonzero(torch.isfinite(tplan.res_w[:tplan.n_residual]))[0])
    bad[tplan.res_dst[e].long(), 0] += 1.0
    assert not tbg.check_converged_banded(tplan, bad.view(res.d_pad.shape), atol=ATOL,
                                          rtol=RTOL)
    with pytest.raises(AssertionError, match="n_residual"):
        tbg.banded_solve_padded(tplan, torch.from_numpy(SEEDS), atol=ATOL, rtol=RTOL,
                                converge="pred")


def _near_tie_classes(d_pad, w8, R, C, V, tol, gap=1e-5):
    """[V, Bp] bool: where the best class in-edge is within `gap` (relative)
    of another or of the `has` threshold (cur * (1 + tol) + tol) — there
    the argmin is not unique and an ulp may decide it."""
    Rp, Cp, Bp = d_pad.shape
    cur, srcs = tbg._class_sources(torch.from_numpy(d_pad), 0, Rp)
    cand = torch.stack([srcs[k] + torch.from_numpy(w8)[:, k, :, None] for k in range(8)])
    top2 = torch.topk(cand, 2, dim=0, largest=False).values
    scale = torch.clamp(cur.abs(), min=1.0) * gap
    tie = ((top2[1] - top2[0]) <= scale) & torch.isfinite(top2[0])
    tie |= (top2[0] - (cur * (1 + tol) + tol)).abs() <= scale
    return tie[:R, :C].reshape(R * C, Bp)[:V].numpy()


def test_residual_predecessors_match_reference_on_one_field():
    """Fed the port's own field, the reference's residual class table,
    res_choice, id post-pass, decoded paths and pred_at_vertices against
    the port's: equal where the argmin is unique (classes, ids), equal
    outright (res_choice, paths), and every residual-only vertex reads a
    real predecessor."""
    v, jm, tm, costs, W, jplan, tplan = _case("irr32")
    res = tbg.banded_solve_padded(tplan, torch.from_numpy(SEEDS), atol=ATOL, rtol=RTOL)
    d = res.d_pad.numpy()
    dj = jnp.asarray(d)
    R, C, V, B = tplan.n_rows, tplan.n_cols, tplan.num_vertices, len(SEEDS)
    tol = max(1e-5, 3.0 * RTOL)
    cls_t, ch_t = tbg.predecessors_banded_classes_residual(tplan, res.d_pad, tol=tol)
    cls_j, ch_j = jpb.predecessors_banded_classes_residual(jplan, dj, tol=tol, interpret=True)
    tie = _near_tie_classes(d, tbg._w8_planes(tplan, d.shape[0]).numpy(), R, C, V, tol)
    cls_t, cls_j = cls_t.numpy(), np.asarray(cls_j)
    assert np.array_equal(cls_t[~tie], cls_j[~tie]) and (cls_t == 9).any()
    np.testing.assert_array_equal(ch_t.numpy(), np.asarray(ch_j))
    ids_t = tbg.predecessors_banded_ids(tplan, res.d_pad, tol=1e-4).numpy()
    ids_j = np.asarray(jpb.predecessors_banded_pallas(jplan, dj, tol=1e-4, interpret=True))
    tie_i = _near_tie_classes(d, tbg._w8_planes(tplan, d.shape[0]).numpy(), R, C, V, 1e-4)
    assert np.array_equal(ids_t[~tie_i], ids_j[~tie_i])
    # the walk with the class-9 decode, from the port's own tables
    starts = np.asarray([800, 20, 400, 1010, 55, 666, 7, 300, 500], np.int64)
    kw_t = dict(res_row_map=tplan.res_row_map, res_jump=tplan.res_jump,
                res_choice=torch.from_numpy(np.array(ch_j))[:, :B])
    path_t, valid_t = tbg.extract_paths_cls(torch.from_numpy(cls_j)[:, :B],
                                            torch.from_numpy(starts), torch.from_numpy(SEEDS),
                                            400, C, **kw_t)
    path_j, valid_j = jpb.extract_paths_cls(
        jnp.asarray(cls_j)[:, :B], jnp.asarray(starts, jnp.int32), jnp.asarray(SEEDS), 400, C,
        res_row_map=jplan.res_row_map, res_jump=jplan.res_jump, res_choice=ch_j[:, :B])
    np.testing.assert_array_equal(valid_t.numpy(), np.asarray(valid_j))
    np.testing.assert_array_equal(path_t.numpy(), np.asarray(path_j))
    assert all(path_t[b][valid_t[b]][-1] == SEEDS[b] for b in range(B))
    # pred_at_vertices with the residual probe: every vertex of every lane
    vids = torch.arange(V)[None].expand(B, V)
    got = tbg.pred_at_vertices(tplan, res.d_pad.view(-1, d.shape[2]), vids, tol=1e-4).numpy()
    want = np.asarray(jpb.pred_at_vertices(jplan, dj.reshape(-1, d.shape[2]),
                                           jnp.asarray(vids.numpy()), tol=1e-4,
                                           lane_minor=True, padded_flat=True))
    assert np.array_equal(got.T[~tie_i[:, :B]], want.T[~tie_i[:, :B]])
    res_only = (ids_t[:, :B] != np.arange(V)[:, None]) & (cls_t[:, :B] == 9)
    assert res_only.any()
    assert np.all(got.T[res_only] != np.nonzero(res_only)[0])


PRED_TOL = max(ATOL, 1e-6)      # the full result's predecessor tolerance


@functools.lru_cache(maxsize=None)
def _roll_pair(kind):
    """The reference's converged field unpadded to [V, B] and the roll-based
    tables of the port and of the reference on it."""
    *_, jplan, tplan = _case(kind)
    R, C, V = tplan.n_rows, tplan.n_cols, tplan.num_vertices
    dist = np.ascontiguousarray(_ref_field(kind)[:R, :C, :len(SEEDS)].reshape(R * C, -1)[:V])
    ref = np.asarray(jpb.predecessors_banded(jplan, jnp.asarray(dist), tol=PRED_TOL))
    got = tbg.predecessors_banded(tplan, torch.from_numpy(dist), tol=PRED_TOL).numpy()
    return dist, got, ref


def _residual_takes(tplan, dist):
    """Per real residual entry (list order): its real dst and src, and [n,
    B] whether it takes (finite candidate at most the vertex's best
    in-edge)."""
    dst, src, w = checks.residual_entries(tplan)
    cand = dist[src] + w[:, None]
    best = checks.best_in_edge(tplan, dist)
    return dst, src, np.isfinite(cand) & (cand <= best[dst])


@pytest.mark.parametrize("kind", ["irr32", "irr40"])
def test_roll_predecessors_match_the_reference_but_for_its_residual_scatter_set(kind):
    """predecessors_banded against the reference's on one field of an
    irregular plan: equal but at vertices that two or more residual entries
    of the reference's list reach (its padding entries reach vertex 0), one
    of them taking, where the reference's scatter-set keeps whichever entry
    it writes last; every non-self predecessor of the port explains its
    label."""
    *_, tplan = _case(kind)
    dist, got, ref = _roll_pair(kind)
    dst, _, take = _residual_takes(tplan, dist)
    Cp, C, V = tplan.n_cols_pad, tplan.n_cols, tplan.num_vertices
    pad_dst = tplan.res_dst.numpy().astype(np.int64)
    reach = np.bincount((pad_dst // Cp) * C + pad_dst % Cp, minlength=V)
    n_take = np.zeros(dist.shape, np.int64)
    np.add.at(n_take, dst, take.astype(np.int64))
    scatter_set = (reach[:, None] >= 2) & (n_take >= 1)
    differ = got != ref
    assert differ.any() and not np.any(differ & ~scatter_set)
    assert (got == ref).mean() > 0.95
    assert not checks.unexplained(tplan, dist, got, PRED_TOL).any()


def test_roll_predecessors_pick_the_taking_residual_entry():
    """The reference's scatter-set fault, pinned on irr32's field: where a
    vertex has two residual in-edges, the first in the list takes and the
    second does not, and no class in-edge explains the label, the port
    picks the first's source and the reference the class in-edge that the
    second entry wrote back, which does not explain the label."""
    *_, tplan = _case("irr32")
    dist, got, ref = _roll_pair("irr32")
    dst, src, take = _residual_takes(tplan, dist)
    no_res = dataclasses.replace(tplan, n_residual=0)
    cls_best = checks.best_in_edge(no_res, dist)
    gate = dist * np.float32(1 + PRED_TOL) + np.float32(PRED_TOL)
    cases = []
    for v in np.unique(dst):
        e = np.nonzero(dst == v)[0]
        if v == 0 or len(e) != 2:
            continue
        for b in np.nonzero(take[e[0]] & ~take[e[1]] & (cls_best[v] > gate[v]))[0]:
            cases.append((v, b, src[e[0]]))
    assert cases
    bad = checks.unexplained(tplan, dist, ref, PRED_TOL)
    for v, b, s in cases:
        assert got[v, b] == s
        assert ref[v, b] != s and bad[v, b]


def test_roll_predecessors_do_not_depend_on_the_lane_chunk():
    """40 lanes in chunks of 32 (a partial last chunk) give the table of one
    call over all 40."""
    *_, tplan = _case("irr32")
    dist, got, _ = _roll_pair("irr32")
    lanes = np.arange(40) % dist.shape[1]
    d40 = torch.from_numpy(np.ascontiguousarray(dist[:, lanes]))
    whole = tbg.predecessors_banded(tplan, d40, tol=PRED_TOL)
    assert torch.equal(tbg.predecessors_banded(tplan, d40, tol=PRED_TOL, max_lanes=32), whole)
    np.testing.assert_array_equal(whole.numpy(), got[:, lanes])


@pytest.mark.parametrize("kind", ["irr32", "irr40"])
def test_roll_predecessors_on_the_transposed_plan(kind):
    """On transpose_banded_plan's plan and the transposed field the table,
    mapped back, explains every label and keeps the same vertices their own
    predecessor: the extended lanes' edges, the dropped ones (irr40's
    column shifts of 3) included, are on the residual list."""
    *_, tplan = _case(kind)
    dist, got, _ = _roll_pair(kind)
    plan_t = tbg.transpose_banded_plan(tplan)
    assert bool(plan_t.xlanes_dropped) == (kind == "irr40")
    R, C, B = tplan.n_rows, tplan.n_cols, dist.shape[1]
    assert tplan.num_vertices == R * C
    d_t = dist.reshape(R, C, B).transpose(1, 0, 2).reshape(C * R, B)
    p_t = tbg.predecessors_banded(plan_t, torch.from_numpy(d_t), tol=PRED_TOL).numpy()
    back = ((p_t % R) * C + p_t // R).reshape(C, R, B).transpose(1, 0, 2).reshape(R * C, B)
    assert not checks.unexplained(tplan, dist, back, PRED_TOL).any()
    vid = np.arange(R * C)[:, None]
    np.testing.assert_array_equal(back == vid, got == vid)


def _planners(kind):
    v, jm, tm, costs, W, jplan, tplan = _case(kind)
    jp = JDijkstraPlanner(jm, JPlannerConfig(cost_limit=COST_LIMIT), max_path_len=256)
    tp = DijkstraPlanner(tm, PlannerConfig(cost_limit=COST_LIMIT), max_path_len=256,
                         device="cpu")
    rng = np.random.default_rng(11)
    ids = rng.integers(0, len(v), (2, 12))
    return v, jp, tp, W, jplan, tplan, v[ids[0]].astype(np.float32), v[ids[1]].astype(np.float32)


def _weighted_cost(tm, W, positions, valid):
    """Each lane's path cost in slot weights (what the solve minimizes): the
    sum over steps a -> b of the weight of the edge into a from b; and each
    path's first vertex."""
    verts = host_array(tm, "vertices")
    adj = host_array(tm, "adj_vertex")
    key = {tuple(p): i for i, p in enumerate(verts)}
    cost, first = [], []
    for lane in range(positions.shape[0]):
        ids = [key[tuple(p)] for p in positions[lane][valid[lane]]]
        cost.append(sum(W[a, np.nonzero(adj[a] == b)[0][0]] for a, b in zip(ids, ids[1:])))
        first.append(ids[0])
    return np.asarray(cost), np.asarray(first)


@pytest.mark.parametrize("light", [True, False])
def test_planner_on_irregular_plan_matches_reference(light):
    """plan_batch_banded on an irregular plan, light (quiet-round solve, the
    residual class table, the class-9 walk, then one compute_velocity_banded
    cycle through the residual probe) and full (the id table's residual
    post-pass): outcomes equal, path costs within 1e-3 relative. The full
    results' predecessors follow different contracts where a class and a
    residual in-edge both explain a label: the id post-pass keeps the class
    edge, the reference's roll-based recovery lets the residual edge win,
    and where several residual edges reach one vertex its scatter-set can
    put back a class edge that does not explain the label (ROADMAP queue
    C). So the full paths are held at their weighted cost, the cost the
    solve minimizes: within 1e-3 of the reference's potential at the start,
    and never above the reference path's; the Euclidean cost is compared
    where the two paths are the same."""
    from mesh_navigation_tpu.config import ControllerConfig as JControllerConfig
    from mesh_navigation_tpu.control import MeshController as JMeshController
    from mesh_navigation_tpu.control.controller import initial_state as j_initial_state
    from mesh_navigation_torch.config import ControllerConfig
    from mesh_navigation_torch.control import MeshController
    from mesh_navigation_torch.control.controller import initial_state

    v, jp, tp, W, jplan, tplan, s, g = _planners("irr32")
    atol, rtol = 1e-3, 2e-3
    assert tp.prepare_banded_plan(W) is not None
    got = tp.plan_batch_banded(tplan, torch.from_numpy(s), torch.from_numpy(g), light=light,
                               atol=atol, rtol=rtol)
    want = jp.plan_batch_banded(jnp.asarray(W), jplan, jnp.asarray(s), jnp.asarray(g),
                                light=light, atol=atol, rtol=rtol)
    assert got.converged
    np.testing.assert_array_equal(got.outcome.numpy(), np.asarray(want.outcome))
    ok = got.outcome.numpy() == 0
    assert ok.all()
    if not light:
        _within(got.potential.numpy(), np.asarray(want.potential), k=2.0)
        pos_t, val_t = got.path_positions.numpy(), got.path_valid.numpy()
        pos_j, val_j = np.asarray(want.path_positions), np.asarray(want.path_valid)
        wt, first = _weighted_cost(tp.mesh, W, pos_t, val_t)
        wj, _ = _weighted_cost(tp.mesh, W, pos_j, val_j)
        pot = np.asarray(want.potential)[np.arange(len(s)), first]
        np.testing.assert_allclose(wt, pot, rtol=1e-3)
        assert np.all(wt <= wj * (1 + 1e-5))
        same = np.asarray([np.array_equal(val_t[b], val_j[b]) and
                           np.array_equal(pos_t[b][val_t[b]], pos_j[b][val_j[b]])
                           for b in range(len(s))])
        assert same.sum() >= len(s) // 2
        np.testing.assert_allclose(got.cost.numpy()[same], np.asarray(want.cost)[same],
                                   rtol=1e-3)
        return
    np.testing.assert_allclose(got.cost.numpy()[ok], np.asarray(want.cost)[ok], rtol=1e-3)
    costs = _case("irr32")[3]
    q = np.tile(np.asarray([0, 0, 0, 1], np.float32), (len(s), 1))
    tc = MeshController(tp.mesh, ControllerConfig(), grid=tp.grid, device="cpu")
    cmd_t, _ = tc.compute_velocity_banded(
        tplan, got.d_pad.reshape(-1, got.d_pad.shape[-1]), torch.from_numpy(costs),
        torch.from_numpy(s), torch.from_numpy(q),
        initial_state(torch.from_numpy(g), torch.tensor([1.0, 0.0, 0.0])), tol=1e-5,
        lane_map=got.lane_map)
    jc = JMeshController(jp.mesh, JControllerConfig(), grid=jp.grid)
    st_b = jax.vmap(lambda gg: j_initial_state(gg, jnp.asarray([1.0, 0.0, 0.0])))(
        jnp.asarray(g))
    cmd_j, _ = jc.compute_velocity_banded(
        jplan, want.d_pad.reshape(-1, want.d_pad.shape[-1]), jnp.asarray(costs), jnp.asarray(s),
        jnp.asarray(q), st_b, tol=1e-5, lane_minor=True, lane_map=want.lane_map,
        padded_flat=True)
    np.testing.assert_array_equal(cmd_t.outcome.numpy(), np.asarray(cmd_j.outcome))
    np.testing.assert_allclose(cmd_t.linear.numpy(), np.asarray(cmd_j.linear), atol=1e-4)
    np.testing.assert_allclose(cmd_t.angular.numpy(), np.asarray(cmd_j.angular), atol=1e-4)


def test_residual_weight_refresh_matches_reference():
    """refresh_banded_planes_from_costs on an irregular plan: the residual
    weights equal the reference's within one ulp (XLA may contract the
    weight's multiply-add, ROADMAP queue C), the planes as before; the
    row-windowed refresh gives the same residual weights."""
    v, jm, tm, costs, W, jplan, tplan = _case("irr40")
    new = costs.copy()
    new[::13] = np.inf
    new[5::17] = 2.5
    tp = tbg.refresh_banded_planes_from_costs(tplan, torch.from_numpy(new),
                                              edge_cost_factor=1.0, cost_limit=COST_LIMIT)
    jp = jpb.refresh_banded_planes_from_costs(jplan, jnp.asarray(new), edge_cost_factor=1.0,
                                              cost_limit=COST_LIMIT)
    want, got = np.asarray(jp.res_w), tp.res_w.numpy()
    assert np.array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    assert np.all(np.abs(got[fin] - want[fin]) <= np.spacing(np.abs(want[fin])))
    for k in ("xdown", "xup", "down"):
        np.testing.assert_allclose(getattr(tp, k).numpy(), np.asarray(getattr(jp, k)),
                                   rtol=1e-6)
    rows = tbg.refresh_banded_planes_rows(tplan, torch.from_numpy(costs), torch.from_numpy(new),
                                          edge_cost_factor=1.0, cost_limit=COST_LIMIT,
                                          row_window=8)
    assert torch.equal(rows.res_w, tp.res_w)


def _server(tm):
    cfg = NavConfig(
        mesh_map=MeshMapConfig(default_layer="combined", edge_cost_factor=1.0),
        planner=PlannerConfig(cost_limit=COST_LIMIT),
        layers=(
            LayerConfig(name="steep", kind="steepness", params=(("threshold", 2.0),)),
            LayerConfig(name="obst", kind="obstacle"),
            LayerConfig(name="combined", kind="max_combination", inputs=("steep", "obst")),
        ),
    )
    return MeshNavServer(tm, cfg, planner_kind="dijkstra", max_path_len=256, device="cpu")


def test_server_replans_on_an_irregular_mesh():
    """MeshNavServer on an irregular mesh: a banded plan with residual
    edges, GetPath answers every lane, and a warm replan step (an obstacle
    cloud, the residual weights refreshed, residual endpoints in the
    changed set, the scatter-min inside the warm rounds, the certificate
    with the residual edges) matches an exact cold solve on the same planes
    (atol 1e-7, rtol 1e-8) within twice atol + rtol*|d|, as the grid's warm
    fields are held (tests/test_torch_replan.py). A cold solve at the
    step's own tolerance is no sharper reference: on this mesh it stops
    2.3 tolerances above the exact field, where the warm field is within
    one."""
    v, jm, tm, costs, W, jplan, tplan = _case("irr40")
    srv = _server(tm)
    assert srv.banded_plan is not None and srv.banded_plan.n_residual > 0
    rng = np.random.default_rng(4)
    ids = rng.integers(0, len(v), (2, 8))
    got = srv.get_path_batch(torch.from_numpy(v[ids[0]]), torch.from_numpy(v[ids[1]]))
    assert bool((got.outcome == 0).all())
    step = srv.make_replan_step("obst")
    seeds = torch.from_numpy(ids[1]).long()
    base = tbg.banded_solve_padded(srv.banded_plan, seeds, atol=1e-4, rtol=2e-3,
                                   converge="check")
    centre = v[int(len(v) * 0.45)]
    pts = centre[None] + rng.normal(0.0, 0.6, (64, 3)).astype(np.float32)
    pts[:, 2] = centre[2] + 0.3
    costs0 = srv.vertex_costs
    new_costs, d_warm, rounds = step(torch.from_numpy(pts), costs0, base.d_pad, seeds)
    assert step.last["converged"]
    assert bool((new_costs != costs0).any())
    kp = step.last["plan"]
    assert not torch.equal(kp.res_w, srv.banded_plan.res_w)
    cold = tbg.banded_solve_padded(kp, seeds, atol=1e-7, rtol=1e-8, max_rounds=500,
                                   converge="check")
    assert cold.converged
    c, w = cold.d_pad.numpy(), d_warm.numpy()
    fin = np.isfinite(c)
    assert np.array_equal(fin, np.isfinite(w))
    assert np.all(np.abs(w[fin] - c[fin]) <= 2 * (1e-4 + 2e-3 * np.abs(c[fin])))


@pytest.mark.parametrize("limit_below_row", [False, True])
def test_two_row_lanes_route_plans_past_their_limit_to_the_structured_tier(
        monkeypatch, limit_below_row):
    """A plan with a sel-2 lane whose padded rows exceed PASS_MAX_COLS_X2
    (lowered here so the 32-column plan crosses it) is not built, though it
    fits PASS_MAX_COLS: prepare_banded_plan returns None. At the limit the
    plan stays."""
    v, jm, tm, costs, W, jplan, tplan = _case("irr32")
    assert tbg.pass_needs_two_rows(tplan.xlanes_down)
    Cp = tplan.n_cols_pad
    monkeypatch.setattr(tbg, "PASS_MAX_COLS_X2", Cp - 8 if limit_below_row else Cp)
    tp = DijkstraPlanner(tm, PlannerConfig(cost_limit=COST_LIMIT), max_path_len=64,
                         device="cpu")
    plan = tp.prepare_banded_plan(W)
    assert (plan is None) == limit_below_row
