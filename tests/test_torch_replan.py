"""Port vs reference: the live-replan path below the layers.

The reference runs its Pallas kernels in interpret mode on the CPU, as its
own tests do; the port runs the plain PyTorch versions its wrappers take for
CPU tensors. Both sides get one plan, carried across with
convert.plan_from_numpy, and inputs made with numpy from a seed.

Tolerances. Weight planes from the incremental refresh agree within rtol
1e-6 with the reference's (float32 from identical inputs), and exactly with
the port's own full refresh. The changed, raised and dilated planes, the
certificate's flag, the dirty tables and the pass flags are compared
exactly. Fields are held within atol + rtol*|d| at the replan tolerances
(atol 1e-4, rtol 2e-3), with the same finite set and no NaN: a pass gates its
writes on supra-tolerance gains, so sub-tolerance differences of summation
order may be kept by one side and dropped by the other. A warm field against
a cold one on the same planes, or against an exact solve, is held at twice
that: the warm field is certified only edge by edge, and a label may sit up
to the tolerance above its best in-edge on every edge of its path. On the
jump / drift / clear chain below the reference's warm field sits 1.06-1.09
tolerances above an exact solve: its warm pass drops the sub-tolerance
gains of the rows it scans. The port keeps them and sits within 2e-4
tolerances of it; over the 20 chained updates of
test_chained_updates_stay_near_an_exact_solve it sits 0-0.96 tolerances
from an exact solve (0 after the last), with no growth along the chain."""

import numpy as np
import pytest
import torch
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import dijkstra

import jax.numpy as jnp

from mesh_navigation_tpu.api.server import MeshNavServer as JMeshNavServer
from mesh_navigation_tpu.config import LayerConfig as JLayerConfig
from mesh_navigation_tpu.config import MeshMapConfig as JMeshMapConfig
from mesh_navigation_tpu.config import NavConfig as JNavConfig
from mesh_navigation_tpu.config import PlannerConfig as JPlannerConfig
from test_torch_reference import reference_build_mesh as jax_build_mesh
from mesh_navigation_tpu.mesh import synthetic
from mesh_navigation_tpu.mesh.arrays import host_array as jhost_array
from mesh_navigation_tpu.ops import pallas_banded as jpb
from mesh_navigation_tpu.ops import sweeps as jsweeps

from mesh_navigation_torch import convert
from mesh_navigation_torch.api.server import MeshNavServer
from mesh_navigation_torch.config import LayerConfig, MeshMapConfig, NavConfig, PlannerConfig
from mesh_navigation_torch.mesh.arrays import build_mesh
from mesh_navigation_torch.ops import banded_gpu as tbg

torch.set_num_threads(2)

ATOL, RTOL = 1e-4, 2e-3
FACTOR, LIMIT = 1.0, 2.0
PLANES = ("down", "up", "a_fwd", "a_bwd", "lat_fwd", "lat_bwd",
          "l2_fwd", "l2_bwd", "wback_fwd", "wback_bwd")


def _costs(v, seed):
    rng = np.random.default_rng(seed)
    c = rng.uniform(0.0, 0.6, len(v)).astype(np.float32)
    c[rng.integers(0, len(v), len(v) // 40)] = np.inf           # scattered lethal
    c[rng.integers(0, len(v), len(v) // 40)] = 3.0               # above cost_limit
    return c


def _problem(nx=24, ny=24, seed=3):
    v, f = synthetic.terrain_mesh(nx, ny, spacing=0.5, hills=1.5, roughness=0.02, seed=seed)
    jm = jax_build_mesh(v, f)
    costs = _costs(v, seed)
    W = jsweeps.slot_weights_np(jm, costs, cost_limit=LIMIT, edge_cost_factor=FACTOR)
    jplan = jpb.build_banded_kernel_plan(jm, W)
    arrays = {k: (None if getattr(jplan, k) is None else np.asarray(getattr(jplan, k)))
              for k in tbg.PLAN_ARRAYS}
    tplan = convert.plan_from_numpy(arrays, {k: getattr(jplan, k) for k in tbg.PLAN_META},
                                    device="cpu")
    return v, f, jm, costs, jplan, tplan


def _assert_planes(tp, jp, exact=False):
    for k in PLANES:
        a, b = getattr(tp, k), getattr(jp, k)
        if b is None:
            assert a is None, k
            continue
        a, b = a.numpy(), np.asarray(b)
        np.testing.assert_array_equal(np.isinf(a), np.isinf(b), k)
        if exact:
            np.testing.assert_array_equal(a, b, k)
        else:
            np.testing.assert_allclose(a[np.isfinite(b)], b[np.isfinite(b)], rtol=1e-6, atol=0,
                                       err_msg=k)


def _within(got, ref, k=1.0):
    assert not np.isnan(got).any()
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    err = np.abs(got[fin] - ref[fin])
    assert np.all(err <= k * (ATOL + RTOL * np.abs(ref[fin]))), float(err.max())


def _dijkstra_padded(jm, costs, seeds, shape, n_cols):
    """The exact field of every seed on the padded [Rp, Cp, Bp] grid: a heap
    Dijkstra (scipy) over the reference's slot weights for `costs`, in-edge
    adj[v, j] -> v of weight W[v, j], vertex v at (v // n_cols, v % n_cols)."""
    W = jsweeps.slot_weights_np(jm, costs, cost_limit=LIMIT, edge_cost_factor=FACTOR)
    adj = jhost_array(jm, "adj_vertex")
    V = W.shape[0]
    dst, slot = np.nonzero(np.isfinite(W))
    g = coo_matrix((W[dst, slot].astype(np.float64), (adj[dst, slot], dst)),
                   shape=(V, V)).tocsr()
    out = np.full(shape, np.inf)
    ids = np.arange(V)
    out[ids // n_cols, ids % n_cols, :len(seeds)] = dijkstra(g, indices=np.asarray(seeds)).T
    return out


@pytest.mark.parametrize("shape,rows,row_window,fits", [
    ((24, 24), (10, 12), 12, True),     # the slab branch
    ((24, 24), (5, 19), 12, False),     # the changed rows do not fit: full
    ((24, 72), (9, 10), 10, True),      # wide rows: the two-level tables too
    ((24, 24), None, 12, True),         # nothing changed
])
def test_refresh_rows_matches_reference(shape, rows, row_window, fits):
    v, _, _, costs, jplan, tplan = _problem(*shape)
    C = shape[1]
    new = costs.copy()
    if rows is not None:
        for r in rows:
            new[r * C + np.arange(3, 9)] = np.inf
            new[r * C + np.arange(12, 15)] = 0.05
    changed_rows = np.nonzero((new != costs).reshape(-1, C).any(axis=1))[0]
    if len(changed_rows):
        assert (changed_rows.max() - changed_rows.min() + 1 + 6 <= row_window - 2) == fits
    kw = dict(edge_cost_factor=FACTOR, cost_limit=LIMIT)
    jbase = jpb.refresh_banded_planes_from_costs(jplan, jnp.asarray(costs), **kw)
    tbase = tbg.refresh_banded_planes_from_costs(tplan, torch.from_numpy(costs), **kw)
    _assert_planes(tbase, jbase)
    jrows = jpb.refresh_banded_planes_rows(jbase, jnp.asarray(costs), jnp.asarray(new),
                                           row_window=row_window, **kw)
    trows = tbg.refresh_banded_planes_rows(tbase, torch.from_numpy(costs), torch.from_numpy(new),
                                           row_window=row_window, **kw)
    _assert_planes(trows, jrows)
    tfull = tbg.refresh_banded_planes_from_costs(tplan, torch.from_numpy(new), **kw)
    _assert_planes(trows, tfull, exact=True)
    if shape[1] == 72:
        assert trows.n_scan2 > 0 and trows.l2_fwd is not None


def test_changed_raised_dilated_planes_identical():
    v, _, _, costs, jplan, tplan = _problem()
    rng = np.random.default_rng(9)
    new = costs.copy()
    idx = rng.integers(0, len(v), 30)
    new[idx[:10]] = np.inf                                    # raised
    new[idx[10:20]] = 0.0                                     # mostly dropped
    new[idx[20:]] = np.where(np.isinf(costs[idx[20:]]), 0.2, np.inf)
    old = costs.copy()
    old[idx[25:]] = np.nan                                    # nan on both paths
    new[idx[27:]] = np.nan
    for fn in ("changed_plane_from_costs", "raised_plane_from_costs"):
        jp = np.asarray(getattr(jpb, fn)(jplan, jnp.asarray(old), jnp.asarray(new)))
        tp = getattr(tbg, fn)(tplan, torch.from_numpy(old), torch.from_numpy(new))
        np.testing.assert_array_equal(tp.numpy(), jp, fn)
        np.testing.assert_array_equal(
            tbg._dilate_changed(tplan, tp).numpy(),
            np.asarray(jpb._dilate_changed(jplan, jnp.asarray(jp))), fn)
        assert 0 < tp.sum() < tp.numel()


def _fields(jplan, seeds):
    conv = jpb.banded_solve_padded(jplan, jnp.asarray(seeds), atol=ATOL, rtol=RTOL)
    one = jpb.banded_solve_padded(jplan, jnp.asarray(seeds), atol=ATOL, rtol=RTOL, max_rounds=1)
    return np.array(conv.d_pad), np.array(one.d_pad)


@pytest.mark.parametrize("case", ["converged", "one_round", "lowered", "raised", "inf_lane"])
def test_check_plain_matches_reference(case):
    _, _, _, _, jplan, tplan = _problem()
    seeds = np.asarray([30, 300, 451, 77, 500, 123, 222, 8], np.int32)
    conv, one = _fields(jplan, seeds)
    d = one if case == "one_round" else conv.copy()
    R, C = tplan.n_rows, tplan.n_cols
    fin = np.argwhere(np.isfinite(d[:R, :C, :]))
    r, c, b = fin[len(fin) // 2]
    if case == "lowered":     # a neighbour of the element now relaxes through it
        d[r, c, b] = max(d[r, c, b] - 1.0, 0.0) * 0.5
    elif case == "raised":    # the element is no longer at its fixed point
        d[r, c, b] = d[r, c, b] * 1.5 + 1.0
    elif case == "inf_lane":
        d[:, :, 3] = np.inf
    ok_j = bool(jpb.check_converged_banded(jplan, jnp.asarray(d), atol=ATOL, rtol=RTOL,
                                           interpret=True))
    viol_t = bool(tbg.check_plain(torch.from_numpy(d), tbg._w8_planes(tplan, d.shape[0]),
                                  atol=ATOL, rtol=RTOL))
    assert viol_t == (not ok_j)
    assert tbg.check_converged_banded(tplan, torch.from_numpy(d), atol=ATOL, rtol=RTOL) == ok_j
    assert ok_j == (case in ("converged", "inf_lane"))


def _warm_inputs(v, costs, tplan, jplan):
    """A converged field on `costs`, then new costs with a raised patch and a
    dropped one, and the refreshed planes of both sides."""
    C = tplan.n_cols
    new = costs.copy()
    for r in (10, 11, 12):
        new[r * C + np.arange(8, 12)] = np.inf
    new[4 * C + np.arange(2, 6)] = 0.0
    kw = dict(edge_cost_factor=FACTOR, cost_limit=LIMIT)
    jp1 = jpb.refresh_banded_planes_from_costs(jplan, jnp.asarray(new), **kw)
    tp1 = tbg.refresh_banded_planes_from_costs(tplan, torch.from_numpy(new), **kw)
    return new, jp1, tp1


def test_warm_pass_plain_matches_reference():
    """The cut + dirty down pass and the dirty up pass against the
    reference's. The port keeps the sub-tolerance cross-row gains of rows
    needed only because they are dirty, where the reference drops them
    (queue C); on this update that leaves the flags and dirty tables equal
    and the fields within tolerance."""
    v, f, jm, costs, jplan, tplan = _problem()
    seeds = np.asarray([30, 300, 451, 77, 500, 123, 222, 8, 260], np.int32)
    d_prev = np.array(jpb.banded_solve_padded(jplan, jnp.asarray(seeds), atol=ATOL, rtol=RTOL).d_pad)
    new, jp1, tp1 = _warm_inputs(v, costs, tplan, jplan)
    old_t, new_t = torch.from_numpy(costs), torch.from_numpy(new)
    changed = tbg.changed_plane_from_costs(tplan, old_t, new_t)
    raised = tbg.raised_plane_from_costs(tplan, old_t, new_t)
    pos = tbg.position_planes(tplan, build_mesh(v, f, device="cpu"))
    Rp = d_prev.shape[0]
    d_t, dirty_t, (lb, th, seedrc) = tbg._warm_start(
        tp1, torch.from_numpy(seeds).long(), torch.from_numpy(d_prev), changed, raised, pos,
        Rp=Rp, bb=8, atol=ATOL, rtol=RTOL)
    assert np.array_equal(d_t.numpy(), d_prev)            # a copy; warm_d stays
    assert torch.isfinite(th[:len(seeds)]).all() and torch.isinf(th[len(seeds):]).all()
    jprob = jpb.prepare_padded(jp1, jnp.asarray(seeds), rb=2, bb=8)
    tprob = tbg.prepare_padded(tp1, torch.from_numpy(seeds), bb=8, seeded=False)
    n_scan = jprob.a_fwd.shape[1]
    d_j = jnp.asarray(d_prev)
    dirty_j = jnp.asarray(dirty_t.numpy())
    cut_j = (jnp.asarray(lb.numpy()), jnp.asarray(th.numpy())[None, :], jnp.asarray(seedrc.numpy()))
    for reverse, cut in ((False, True), (True, False)):
        cross_j, cross_t = (jprob.up, tprob.up) if reverse else (jprob.down, tprob.down)
        d_j, chg_j, dirty_j = jpb._directional_pass_pallas(
            d_j, cross_j, jprob.a_fwd, jprob.a_bwd, jprob.xdown, jprob.l2_fwd, jprob.l2_bwd,
            jprob.wback, dirty_j, cut_j if cut else None, reverse=reverse, rb=2, bb=8,
            n_scan=n_scan, atol=ATOL, rtol=RTOL, interpret=True, skip=True,
            use_dirty=True)
        chg_t = tbg.directional_pass(
            d_t, cross_t, tprob.a_fwd, tprob.a_bwd, reverse=reverse, bb=8, atol=ATOL,
            rtol=RTOL, dirty=dirty_t, warm_cut=(lb, th, seedrc) if cut else None)
        assert bool(chg_t.item()) == bool(chg_j)
        np.testing.assert_array_equal(dirty_t.numpy(), np.asarray(dirty_j))
        _within(d_t.numpy(), np.asarray(d_j))
    assert bool(chg_t.item()) and dirty_t.any()
    # the cut invalidated labels behind the raised patch
    assert np.isinf(np.asarray(d_j)).sum() >= np.isinf(d_prev).sum()
    # the cut is a mode of the warm resolve only, which keeps the dirty table
    with pytest.raises(ValueError, match="dirty"):
        tbg.directional_pass(d_t, tprob.down, tprob.a_fwd, tprob.a_bwd, reverse=False, bb=8,
                             atol=ATOL, rtol=RTOL, warm_cut=(lb, th, seedrc))


def test_warm_solve_matches_reference_and_cold():
    v, f, jm, costs, jplan, tplan = _problem()
    seeds = np.asarray([30, 300, 451, 77, 500, 123, 222, 8, 260], np.int32)
    d_prev = np.array(jpb.banded_solve_padded(jplan, jnp.asarray(seeds), atol=ATOL, rtol=RTOL).d_pad)
    new, jp1, tp1 = _warm_inputs(v, costs, tplan, jplan)
    jpos = jpb.position_planes(jplan, jm)
    tpos = tbg.position_planes(tplan, build_mesh(v, f, device="cpu"))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    jres = jpb.banded_solve_padded(
        jp1, jnp.asarray(seeds), atol=ATOL, rtol=RTOL, max_rounds=64, converge="check",
        warm_d=jnp.asarray(d_prev),
        warm_changed=jpb.changed_plane_from_costs(jplan, jnp.asarray(costs), jnp.asarray(new)),
        warm_raised=jpb.raised_plane_from_costs(jplan, jnp.asarray(costs), jnp.asarray(new)),
        warm_pos=jpos)
    old_t, new_t = torch.from_numpy(costs), torch.from_numpy(new)
    warm_d = torch.from_numpy(d_prev.copy())
    tres = tbg.banded_solve_padded(
        tp1, torch.from_numpy(seeds), atol=ATOL, rtol=RTOL, max_rounds=64, converge="check",
        warm_d=warm_d, warm_changed=tbg.changed_plane_from_costs(tplan, old_t, new_t),
        warm_raised=tbg.raised_plane_from_costs(tplan, old_t, new_t), warm_pos=tpos)
    assert np.array_equal(warm_d.numpy(), d_prev)
    assert tres.converged and bool(jres.converged)
    assert tres.rounds == int(jres.rounds)
    _within(tres.d_pad.numpy(), np.asarray(jres.d_pad))
    cold = tbg.banded_solve_padded(tp1, torch.from_numpy(seeds), atol=ATOL, rtol=RTOL)
    _within(tres.d_pad.numpy(), cold.d_pad.numpy(), k=2.0)
    # a cold solve that the certificate ends agrees with the round-ended one
    certified = tbg.banded_solve_padded(tp1, torch.from_numpy(seeds), atol=ATOL, rtol=RTOL,
                                        converge="check")
    assert certified.converged
    _within(certified.d_pad.numpy(), cold.d_pad.numpy())
    # the windowed resolve: a window as tall as this 24-row field is not
    # used, so the step is the one above; a window that is no positive
    # multiple of 128 is refused (tests/test_torch_window.py runs the slab)
    kw = dict(atol=ATOL, rtol=RTOL, max_rounds=64, converge="check", warm_d=warm_d,
              warm_changed=tbg.changed_plane_from_costs(tplan, old_t, new_t),
              warm_raised=tbg.raised_plane_from_costs(tplan, old_t, new_t), warm_pos=tpos)
    windowed = tbg.banded_solve_padded(tp1, torch.from_numpy(seeds), warm_window=128, **kw)
    assert windowed.window is None and windowed.rounds == tres.rounds
    assert torch.equal(windowed.d_pad, tres.d_pad)
    with pytest.raises(ValueError):
        tbg.banded_solve_padded(tp1, torch.from_numpy(seeds), warm_window=96, **kw)
    with pytest.raises(AssertionError):
        tbg.banded_solve_padded(tp1, torch.from_numpy(seeds), converge="round",
                                warm_d=warm_d, warm_changed=tbg.changed_plane_from_costs(
                                    tplan, old_t, new_t))


N_REPLAN = 24


def _replan_config(NC, MC, PC, LC):
    return NC(
        mesh_map=MC(default_layer="combine", edge_cost_factor=1.0),
        planner=PC(cost_limit=2.0),
        layers=(
            LC(name="steep", kind="steepness", params=(("threshold", 2.0),)),
            LC(name="obst", kind="obstacle"),
            LC(name="infl", kind="inflation", inputs=("obst",),
               params=(("repulsive_field", 0.0),)),
            LC(name="combine", kind="max_combination", inputs=("steep", "obst", "infl")),
        ),
    )


def _replan_mesh():
    return synthetic.terrain_mesh(N_REPLAN, N_REPLAN, spacing=0.5, hills=1.0, roughness=0.02,
                                  seed=4)


def _port_server(v, f):
    return MeshNavServer(build_mesh(v, f, device="cpu"),
                         _replan_config(NavConfig, MeshMapConfig, PlannerConfig, LayerConfig),
                         planner_kind="dijkstra", device="cpu")


def _replan_servers():
    v, f = _replan_mesh()
    js = JMeshNavServer(jax_build_mesh(v, f),
                        _replan_config(JNavConfig, JMeshMapConfig, JPlannerConfig, JLayerConfig),
                        planner_kind="dijkstra", max_path_len=64)
    return v, js, _port_server(v, f)


def _cloud(v, rng, center, z_off=0.3, n=96):
    """bench.py's replan clouds: points over a +-2-row/col patch of vertices
    (jittered inside the cell, so no ray grazes an edge)."""
    ids = np.clip(center + rng.integers(-2, 3, n) * N_REPLAN + rng.integers(-2, 3, n),
                  0, len(v) - 1)
    jit = np.concatenate([rng.uniform(-0.1, 0.1, (n, 2)), np.zeros((n, 1))], axis=1)
    return (v[ids] + jit + np.asarray([0, 0, z_off])).astype(np.float32)


def test_make_replan_step_chain_matches_reference_and_cold():
    v, js, ts = _replan_servers()
    assert ts.banded_plan is not None
    window = (24, 32)
    jstep = js.make_replan_step("obst", inflation_window=window)
    tstep = ts.make_replan_step("obst", inflation_window=window)
    seeds = np.sort(np.random.default_rng(1).integers(0, len(v), 9)).astype(np.int32)
    jb = jpb.banded_solve_padded(js.banded_plan, jnp.asarray(seeds), atol=ATOL, rtol=RTOL)
    tb = tbg.banded_solve_padded(ts.banded_plan, torch.from_numpy(seeds).long(), atol=ATOL,
                                 rtol=RTOL)
    _within(tb.d_pad.numpy(), np.asarray(jb.d_pad))
    rng = np.random.default_rng(2)
    c0 = 9 * N_REPLAN + 10
    drift = c0 + 3 * N_REPLAN + 3
    jc, jd, tc, td = js.vertex_costs, jb.d_pad, ts.vertex_costs, tb.d_pad
    for name, pts in (("jump", _cloud(v, rng, c0)), ("drift", _cloud(v, rng, drift)),
                      ("clear", _cloud(v, rng, c0, z_off=1e4))):
        tc_prev = tc
        jc, jd, jr = jstep(jnp.asarray(pts), jc, jd, jnp.asarray(seeds))
        tc, td, tr = tstep(torch.from_numpy(pts), tc, td, torch.from_numpy(seeds).long())
        got, ref = tc.numpy(), np.asarray(jc)
        np.testing.assert_array_equal(np.isinf(got), np.isinf(ref), name)
        np.testing.assert_allclose(got[np.isfinite(ref)], ref[np.isfinite(ref)], rtol=0,
                                   atol=1e-6, err_msg=name)
        assert tstep.last["converged"], name
        assert tr == tstep.last["rounds"]
        # the reference's warm pass drops the sub-tolerance gains of the rows
        # it scans, and its field sits about one tolerance above the exact
        # one; the port keeps them (ROADMAP queue C). So the port's field is
        # held against the reference's at twice the tolerance, as a warm field
        # against an exact solve, and within one tolerance of the exact field
        _within(td.numpy(), np.asarray(jd), k=2.0)
        exact = _dijkstra_padded(js.mesh, np.asarray(jc), seeds, td.shape, ts.banded_plan.n_cols)
        _within(td.numpy(), exact)
        cold = tbg.banded_solve_padded(tstep.last["plan"], torch.from_numpy(seeds).long(),
                                       atol=ATOL, rtol=RTOL)
        _within(td.numpy(), cold.d_pad.numpy(), k=2.0)
        raised = tbg.raised_plane_from_costs(ts.banded_plan, tc_prev, tc)
        if name == "clear":
            # no raised cost: the threshold is +inf and the cut leaves the field
            assert np.isinf(got).sum() == 0 and not raised.any()
            _, _, (lb, th, _) = tbg._warm_start(
                tstep.last["plan"], torch.from_numpy(seeds).long(), td,
                tbg.changed_plane_from_costs(ts.banded_plan, tc_prev, tc), raised, None,
                Rp=td.shape[0], bb=8, atol=ATOL, rtol=RTOL)
            assert torch.isinf(th).all()
            assert not bool((td >= lb[:, :, None] + th).logical_and(torch.isfinite(td)).any())
        else:
            assert np.isinf(got).sum() > 0 and raised.any()


def test_chained_updates_stay_near_an_exact_solve():
    """20 chained jump / drift / clear updates, each warm-started from the
    last: the warm resolve's edge-by-edge drift must not compound from one
    update to the next. The last field is held against an exact solve on the
    last update's planes."""
    v, f = _replan_mesh()
    ts = _port_server(v, f)
    step = ts.make_replan_step("obst", inflation_window=(24, 32))
    seeds = torch.from_numpy(np.sort(np.random.default_rng(1).integers(0, len(v), 9))).long()
    d = tbg.banded_solve_padded(ts.banded_plan, seeds, atol=ATOL, rtol=RTOL).d_pad
    costs = ts.vertex_costs
    rng = np.random.default_rng(7)
    centre = 9 * N_REPLAN + 10
    for i in range(20):
        if i % 3 == 0:
            centre = int(rng.integers(3 * N_REPLAN, len(v) - 3 * N_REPLAN))
            pts = _cloud(v, rng, centre)
        elif i % 3 == 1:
            centre = min(centre + 3 * N_REPLAN + 3, len(v) - 1)
            pts = _cloud(v, rng, centre)
        else:
            pts = _cloud(v, rng, centre, z_off=1e4)
        costs, d, _ = step(torch.from_numpy(pts), costs, d, seeds)
        assert step.last["converged"], i
    exact = tbg.banded_solve_padded(step.last["plan"], seeds, atol=1e-7, rtol=1e-8,
                                    max_rounds=500)
    assert exact.converged
    _within(d.numpy(), exact.d_pad.numpy(), k=2.0)


def test_update_point_cloud_refreshes_like_a_rebuild():
    v, js, ts = _replan_servers()
    plan0 = ts.banded_plan
    pts = _cloud(v, np.random.default_rng(5), 11 * N_REPLAN + 11)
    ts.update_point_cloud("obst", torch.from_numpy(pts))
    js.update_point_cloud("obst", jnp.asarray(pts))
    assert ts.banded_plan.n_residual == plan0.n_residual
    assert "obstacle:obst:points" not in ts.layer_state
    np.testing.assert_allclose(np.nan_to_num(ts.vertex_costs.numpy(), posinf=9.0),
                               np.nan_to_num(np.asarray(js.vertex_costs), posinf=9.0),
                               rtol=0, atol=1e-6)
    _assert_planes(ts.banded_plan, js.banded_plan)
    # the refreshed planes equal a structural rebuild with the same cloud
    ts.layer_state["obstacle:obst:points"] = torch.from_numpy(pts)
    ts._refresh_costs(structural=True)
    ts.layer_state.pop("obstacle:obst:points")
    refreshed = js.banded_plan
    _assert_planes(ts.banded_plan, refreshed)
    # the windowed step is built (tests/test_torch_window.py drives it); a
    # window that is no positive multiple of 128 is refused
    assert ts.make_replan_step("obst", warm_window=128).last is None
    with pytest.raises(ValueError):
        ts.make_replan_step("obst", warm_window=100)


def test_warm_resolve_repairs_a_stale_chain_the_reference_keeps():
    """Reference fault (ROADMAP queue C): the reference's warm pass scans a
    row that is needed only because it is dirty from base = cur, dropping its
    sub-tolerance cross-row gains. A field whose labels sit 0.3*rtol*k above
    their distance k rows away from each seed passes the per-edge
    certificate, so the reference's warm resolve returns it as it is, more
    than 1% high 20 rows out. The port keeps those gains and returns the
    distances."""
    *_, jplan, tplan = _problem()
    seeds = np.asarray([30, 300, 451, 77, 500, 123, 222, 8], np.int32)
    exact = tbg.banded_solve_padded(tplan, torch.from_numpy(seeds), atol=1e-7, rtol=1e-8,
                                    max_rounds=500).d_pad.numpy()
    Rp, Cp, Bp = exact.shape
    seed_row = np.full(Bp, Rp, np.int64)
    seed_row[:len(seeds)] = seeds // tplan.n_cols
    rows_out = np.abs(np.arange(Rp)[:, None, None] - seed_row[None, None, :])
    stale = (exact * (1.0 + 0.3 * RTOL * rows_out)).astype(np.float32)
    assert tbg.check_converged_banded(tplan, torch.from_numpy(stale), atol=ATOL, rtol=RTOL)
    every_row = np.ones((tplan.n_rows, Cp), bool)
    no_raise = np.zeros((tplan.n_rows, Cp), bool)
    jres = jpb.banded_solve_padded(
        jplan, jnp.asarray(seeds), atol=ATOL, rtol=RTOL, converge="check",
        warm_d=jnp.asarray(stale), warm_changed=jnp.asarray(every_row),
        warm_raised=jnp.asarray(no_raise))
    tres = tbg.banded_solve_padded(
        tplan, torch.from_numpy(seeds), atol=ATOL, rtol=RTOL, converge="check",
        warm_d=torch.from_numpy(stale), warm_changed=torch.from_numpy(every_row),
        warm_raised=torch.from_numpy(no_raise))
    assert tres.converged and bool(jres.converged)
    fin = np.isfinite(exact)

    def max_rel(d):
        return float(((np.asarray(d)[fin] - exact[fin]) / np.maximum(exact[fin], 1e-3)).max())

    assert max_rel(jres.d_pad) > 0.01                  # the reference keeps the drift
    assert max_rel(tres.d_pad) < 2 * RTOL              # the port removes it
