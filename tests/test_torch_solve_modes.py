"""Port vs reference: the banded and structured solvers' opt-in modes.

bfloat16 fields (banded and structured tiers), partial scan depth
(`scan_steps`), the unskipped pass (`skip_rows=False`), the scan-deferring
down pass (`scan_dirs="up"`), and four_dir's column passes on the plan of
`transpose_banded_plan`. The reference runs its Pallas pass in interpret
mode on the CPU only where nothing cheaper serves (single passes, and one
solve of each mode on a 16 x 16 terrain); elsewhere the port is held against
the heap Dijkstra oracle (utils/oracle.py) and the reference's structured
roll path. Reference meshes come from test_torch_reference.reference_build_mesh.

Tolerances.
- Transposed plans: planes, chain weights, lanes and residual ids bit for
  bit, except the lanes two rows or more away, which the port leaves out
  (ROADMAP "Departures").
- A single pass at zero tolerance: bit for bit (on rows of at most 32
  columns the port's exact scan is the reference's flat scan; at zero
  tolerance the port's dirty rule, base = row0 and a needed row writing its
  scan, writes what the reference's imp ? row0 : cur and simp ? scan : base
  write).
- f32 solves: within rtol = atol = 1e-3 of the heap oracle (the
  reference's own bound, tests/test_irregular.py), and within twice the
  stopping tolerance atol + rtol*|d| of the reference's field (two fields
  each stopped within one tolerance of the fixed point).
- bfloat16 banded solves: the same finite support as the reference's and
  within twice the bfloat16 stopping tolerance (1e-3 + 4e-3*|d|) of it.
- bfloat16 structured solves: bit for bit the reference's roll path, and
  within the reference's own bounds of the f32 field (tests/test_ordered.py:
  worst 2%, mean 0.5%).
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mesh_navigation_tpu.config import PlannerConfig as JPlannerConfig
from mesh_navigation_tpu.mesh import synthetic
from mesh_navigation_tpu.ops import pallas_banded as jpb
from mesh_navigation_tpu.ops import structured as jst
from mesh_navigation_tpu.ops import sweeps as jsweeps
from mesh_navigation_tpu.planners import DijkstraPlanner as JDijkstraPlanner

from mesh_navigation_torch import convert
from mesh_navigation_torch.config import PlannerConfig
from mesh_navigation_torch.mesh import reorder as treorder
from mesh_navigation_torch.mesh.arrays import build_mesh
from mesh_navigation_torch.ops import banded_gpu as tbg
from mesh_navigation_torch.ops import structured as tst
from mesh_navigation_torch.ops import sweep_gpu as tsg
from mesh_navigation_torch.planners import DijkstraPlanner
from mesh_navigation_torch.utils import oracle

from test_torch_reference import reference_build_mesh

torch.set_num_threads(2)

ATOL, RTOL = 1e-5, 1e-5               # the reference solve's defaults
BF_ATOL, BF_RTOL = tbg.BF16_ATOL, tbg.BF16_RTOL
ORACLE_TOL = 1e-3
# (n, seed, cost_limit, costs): the reference's 16 x 16 partial-depth terrain
# (tests/test_irregular.py:108-127); its irregular cases, band-reordered
# Delaunay terrains (:130-146 scan_steps, :180-195 four_dir); and the port
# tests' irr32 / irr40 (tests/test_torch_irregular.py), whose transposed
# plans hold lanes three and four rows away
CASES = {
    "grid16": ("grid", 16, 3, 1.0),
    "irr14": ("irregular", 14, 11, 2.0),
    "irr12": ("irregular", 12, 9, 2.0),
    "irr32": ("irregular", 32, 4, 2.0),
    "irr40": ("irregular", 40, 2, 2.0),
}
SEEDS = {"grid16": [17, 100, 255], "irr14": [3, 99], "irr12": [7, 120],
         "irr32": [5, 111, 233], "irr40": [5, 900, 1000]}


@functools.lru_cache(maxsize=None)
def _case(kind):
    """(v, f, jm, tm, costs, W, ew, jplan, tplan): both meshes, seeded costs,
    slot and edge weights, the reference's plan and the port's copy of it."""
    mesh_kind, n, seed, limit = CASES[kind]
    if mesh_kind == "grid":
        v, f = synthetic.terrain_mesh(n, n, spacing=0.5, hills=1.5, roughness=0.02, seed=seed)
        jm = reference_build_mesh(v, f)
        tm = build_mesh(v, f, device="cpu")
        costs = np.random.default_rng(1).uniform(0.0, 0.8, len(v)).astype(np.float32)
    else:
        hills = 1.0
        v, f = synthetic.irregular_terrain_mesh(n, n, spacing=0.5, jitter=0.45, hills=hills,
                                                roughness=0.01, seed=seed)
        jm = reference_build_mesh(v, f, reorder=True)
        tm = treorder.build_reordered_mesh(v, f, device="cpu")
        costs = (np.zeros(tm.num_vertices, np.float32) if kind in ("irr14", "irr12") else
                 np.random.default_rng(3).uniform(0.0, 0.6, tm.num_vertices).astype(np.float32))
    W = jsweeps.slot_weights_np(jm, costs, cost_limit=limit, edge_cost_factor=1.0)
    ew = np.asarray(jsweeps.compute_edge_weights(jm, jnp.asarray(costs), 1.0))
    jplan = jpb.build_banded_kernel_plan(jm, W)
    arrays = {k: (None if getattr(jplan, k) is None else np.asarray(getattr(jplan, k)))
              for k in tbg.PLAN_ARRAYS}
    meta = {k: getattr(jplan, k) for k in tbg.PLAN_META}
    tplan = convert.plan_from_numpy(arrays, meta, device="cpu")
    return v, f, jm, tm, costs, W, ew, jplan, tplan


@functools.lru_cache(maxsize=None)
def _oracle(kind):
    """[B, V] heap-Dijkstra fields of the case's seeds."""
    _, _, _, tm, costs, _, ew, _, _ = _case(kind)
    limit = CASES[kind][3]
    adj = oracle.mesh_adjacency(tm)
    return np.stack([oracle.dijkstra_oracle(tm.num_vertices, adj, ew, costs, int(s), limit)[0]
                     for s in SEEDS[kind]])


def _fields(plan, d_pad, B):
    R, C, V = plan.n_rows, plan.n_cols, plan.num_vertices
    d = d_pad.float().numpy() if isinstance(d_pad, torch.Tensor) else np.asarray(d_pad, np.float32)
    return d[:R, :C, :B].reshape(R * C, B)[:V].T


def _port(kind, **kw):
    *_, tplan = _case(kind)
    res = tbg.banded_solve_padded(tplan, torch.tensor(SEEDS[kind]), **kw)
    assert res.converged
    return res


@functools.lru_cache(maxsize=None)
def _ref(kind, **kw):
    *_, jplan, _ = _case(kind)
    res = jpb.banded_solve_padded(jplan, jnp.asarray(SEEDS[kind], jnp.int32), **kw)
    assert bool(res.converged)
    return np.asarray(res.d_pad.astype(jnp.float32))


def _hold_oracle(kind, got):
    ref = _oracle(kind)
    assert np.array_equal(np.isfinite(got), np.isfinite(ref))
    np.testing.assert_allclose(got, ref, rtol=ORACLE_TOL, atol=ORACLE_TOL)


def _within(got, ref, atol, rtol, k=2.0):
    fin = np.isfinite(ref)
    assert np.array_equal(fin, np.isfinite(got))
    err = np.abs(got[fin] - ref[fin])
    assert np.all(err <= k * (atol + rtol * np.abs(ref[fin]))), float(err.max())


# --------------------------------------------------------------------------
# transpose_banded_plan
# --------------------------------------------------------------------------

# the transposed lanes (dr_t, dc_t) the port leaves out: an original lane
# (dr, dc) with |dc| = 3 or 4 maps to |dr_t| > 2
DROPPED = {"grid16": (), "irr12": (), "irr32": (), "irr40": ((3, 0), (-3, 0))}


@pytest.mark.parametrize("kind", ["grid16", "irr12", "irr32", "irr40"])
def test_transposed_plan_matches_reference_but_the_far_lanes(kind):
    *_, jplan, tplan = _case(kind)
    jt = jpb.transpose_banded_plan(jplan)
    tt = tbg.transpose_banded_plan(tplan)
    assert (tt.n_rows, tt.n_cols, tt.n_cols_pad, tt.n_scan) == (
        jt.n_rows, jt.n_cols, jt.n_cols_pad, jt.n_scan)
    for name in ("down", "up", "a_fwd", "a_bwd", "lat_fwd", "lat_bwd", "res_dst", "res_src",
                 "res_w"):
        np.testing.assert_array_equal(getattr(tt, name).numpy(), np.asarray(getattr(jt, name)),
                                      err_msg=name)
    for side in ("down", "up"):
        jl = getattr(jt, f"xlanes_{side}")
        keep = [i for i, (sel, _) in enumerate(jl) if sel <= 2]
        assert getattr(tt, f"xlanes_{side}") == tuple(jl[i] for i in keep)
        if keep:
            np.testing.assert_array_equal(getattr(tt, f"x{side}").numpy(),
                                          np.asarray(getattr(jt, f"x{side}"))[:, keep])
    far = sorted({(-sel if side == "down" else sel, dc)
                  for side in ("down", "up") for sel, dc in getattr(jt, f"xlanes_{side}")
                  if sel > 2})
    assert sorted(set(tt.xlanes_dropped)) == far == sorted(DROPPED[kind])


def test_dropped_lanes_edges_stay_on_the_residual_list():
    """Every edge of an extended lane (irr40's (0, +-3) lanes, transposed
    to (+-3, 0)) is on the plan's residual list, which the round's
    scatter-min relaxes whatever the passes do."""
    _, _, _, tm, _, _, _, _, tplan = _case("irr40")
    C, Cp = tplan.n_cols, tplan.n_cols_pad
    res = {(int(d), int(s)) for d, s in zip(tplan.res_dst[:tplan.n_residual],
                                            tplan.res_src[:tplan.n_residual])}
    adj = tm.adj_vertex.numpy()
    n_far = 0
    for side, sign in (("down", -1), ("up", 1)):
        for i, (sel, dc) in enumerate(getattr(tplan, f"xlanes_{side}")):
            if abs(dc) <= 2:
                continue
            slots = getattr(tplan, f"xslot_{side}")[i].numpy()
            for v in np.nonzero(slots >= 0)[0]:
                u = adj[v, slots[v]]
                n_far += 1
                assert ((v // C) * Cp + v % C, (u // C) * Cp + u % C) in res
    assert n_far > 0


def test_reference_far_lane_relaxes_nothing_or_from_the_wrong_source():
    """The search for a transposed lane (|dr_t| > 2, dc_t != 0), which the
    reference would relax from the wrong source: the original lanes
    (+-1 | +-2, +-3 | +-4) appear on none of the irregular cases here
    (every far transposed lane is (+-3, 0), from the own-row lanes
    (0, +-3)); on those the reference's own-row read at column offset 0
    adds cur + w >= cur, which relaxes nothing, so four_dir reaches the
    same field either way (test_four_dir_meets_oracle)."""
    for kind in ("irr12", "irr32", "irr40"):
        *_, jplan, _ = _case(kind)
        jt = jpb.transpose_banded_plan(jplan)
        far = [(sel, dc) for sel, dc in jt.xlanes_down + jt.xlanes_up if sel > 2]
        assert all(dc == 0 for _, dc in far), (kind, far)


# --------------------------------------------------------------------------
# single passes against the reference's Pallas pass (interpret mode)
# --------------------------------------------------------------------------

def _ref_pass(jprob, d, dirty, *, reverse, force, mode, n_scan, use_dirty, defer=False):
    af, ab = jprob.a_fwd[:, :max(1, n_scan)], jprob.a_bwd[:, :max(1, n_scan)]
    cross = jprob.up if reverse else jprob.down
    return jpb._directional_pass_pallas(
        d, cross, af, ab, jprob.xdown if not reverse else jprob.xup, jprob.l2_fwd,
        jprob.l2_bwd, jprob.wback, dirty, reverse=reverse, rb=2, bb=8, n_scan=n_scan,
        n_scan2=0, atol=0.0, rtol=0.0, interpret=True, skip=mode != "noskip", force=force,
        use_dirty=use_dirty, defer=defer)


@pytest.mark.parametrize("mode", ["noskip", "partial2", "defer", "bf16", "bf16_partial2"])
def test_one_pass_matches_reference_kernel(mode):
    """A forced down pass then an up pass from the seeds (the deferring
    pass: a deferring down pass, then a full-depth up pass that reads its
    dirty table) at zero tolerance, each bit for bit the reference's,
    with equal flags and dirty tables."""
    *_, jplan, tplan = _case("grid16")
    seeds = SEEDS["grid16"]
    bf16 = mode.startswith("bf16")
    jprob = jpb.prepare_padded(jplan, jnp.asarray(seeds, jnp.int32), rb=2, bb=8,
                               dtype=jnp.bfloat16 if bf16 else jnp.float32)
    tprob = tbg.prepare_padded(tplan, torch.tensor(seeds), bb=8,
                               dtype=torch.bfloat16 if bf16 else torch.float32)
    steps = 2 if mode.endswith("partial2") else 0
    full = jplan.n_scan
    use_dirty = mode != "noskip" and (steps or mode == "defer")
    Rp = tprob.down.shape[0]
    dirty_t = torch.zeros((1, Rp), dtype=torch.int32) if use_dirty else None
    dirty_j = jnp.zeros((1, Rp) if use_dirty else (1, 1), jnp.int32)
    d_j, d_t = jprob.d0, tprob.d0.clone()
    for reverse in (False, True):
        defer = mode == "defer" and not reverse
        n_j = 0 if defer else (steps or full)
        d_j, chg_j, dirty_j = _ref_pass(jprob, d_j, dirty_j, reverse=reverse, force=not reverse,
                                        mode=mode, n_scan=n_j, use_dirty=bool(use_dirty),
                                        defer=defer)
        chg_t = tbg.directional_pass(
            d_t, tprob.up if reverse else tprob.down, tprob.a_fwd, tprob.a_bwd,
            reverse=reverse, bb=8, atol=0.0, rtol=0.0, force=not reverse, dirty=dirty_t,
            skip=mode != "noskip", defer=defer, scan_steps=steps)
        assert d_t.dtype == (torch.bfloat16 if bf16 else torch.float32)
        np.testing.assert_array_equal(d_t.float().numpy(), np.asarray(d_j.astype(jnp.float32)))
        assert bool(chg_t.item()) == bool(chg_j)
        if use_dirty:
            np.testing.assert_array_equal(dirty_t.numpy(), np.asarray(dirty_j))
    assert (d_t.float() < np.inf).any()


# --------------------------------------------------------------------------
# solves
# --------------------------------------------------------------------------

@pytest.mark.parametrize("steps", [1, 2, 3])
def test_partial_depth_meets_oracle_and_reference(steps):
    *_, tplan = _case("grid16")
    res = _port("grid16", scan_steps=steps)
    got = _fields(tplan, res.d_pad, 3)
    _hold_oracle("grid16", got)
    _within(got, _fields(tplan, _ref("grid16", scan_steps=steps), 3), ATOL, RTOL)


def test_irregular_partial_depth_meets_oracle():
    *_, tplan = _case("irr14")
    assert tplan.n_residual > 0
    _hold_oracle("irr14", _fields(tplan, _port("irr14", scan_steps=2).d_pad, 2))


@pytest.mark.parametrize("kind", ["irr12", "irr40"])
def test_four_dir_meets_oracle(kind):
    """Four-direction rounds reach the two-direction fixed point; on irr40
    the transposed plan leaves (+-3, 0) out."""
    *_, tplan = _case(kind)
    B = len(SEEDS[kind])
    tt = tbg.transpose_banded_plan(tplan)
    four = _port(kind, four_dir=True, plan_t=tt)
    two = _port(kind)
    got = _fields(tplan, four.d_pad, B)
    _hold_oracle(kind, got)
    _within(got, _fields(tplan, two.d_pad, B), ATOL, RTOL)
    assert four.rounds <= two.rounds


def test_four_dir_matches_reference_on_its_case():
    *_, tplan = _case("irr12")
    got = _fields(tplan, _port("irr12", four_dir=True).d_pad, 2)
    _within(got, _fields(tplan, _ref("irr12", four_dir=True), 2), ATOL, RTOL)


@pytest.mark.parametrize("kw", [{"scan_dirs": "up"}, {"skip_rows": False}],
                         ids=["defer", "noskip"])
@pytest.mark.parametrize("kind", ["grid16", "irr14"])
def test_exact_modes_meet_oracle(kind, kw):
    *_, tplan = _case(kind)
    B = len(SEEDS[kind])
    got = _fields(tplan, _port(kind, **kw).d_pad, B)
    _hold_oracle(kind, got)
    if kind == "grid16":
        _within(got, _fields(tplan, _ref(kind, **kw), B), ATOL, RTOL)


def test_warm_resolve_in_the_opt_in_modes():
    """A warm resolve (cut, forced first round) with partial depth, the
    deferring pass, unskipped rows and four_dir lands within the stopping
    tolerance of a cold full-depth solve on the new costs."""
    _, _, _, tm, costs, _, _, _, tplan = _case("grid16")
    seeds = torch.tensor(SEEDS["grid16"])
    kw = dict(edge_cost_factor=1.0, cost_limit=1.0)
    new = torch.from_numpy(costs).clone()
    new[7 * 16 + 4: 7 * 16 + 10] = np.inf
    plan0 = tbg.refresh_banded_planes_from_costs(tplan, torch.from_numpy(costs), **kw)
    plan1 = tbg.refresh_banded_planes_from_costs(tplan, new, **kw)
    d_prev = tbg.banded_solve_padded(plan0, seeds, atol=ATOL, rtol=RTOL).d_pad
    cold = _fields(plan1, tbg.banded_solve_padded(plan1, seeds, atol=ATOL, rtol=RTOL).d_pad, 3)
    warm = dict(warm_d=d_prev, warm_changed=tbg.changed_plane_from_costs(plan1, torch.from_numpy(costs), new),
                warm_raised=tbg.raised_plane_from_costs(plan1, torch.from_numpy(costs), new),
                warm_pos=tbg.position_planes(plan1, tm), converge="check", atol=ATOL, rtol=RTOL)
    for mode in ({"scan_steps": 2}, {"scan_dirs": "up"}, {"skip_rows": False},
                 {"four_dir": True}):
        res = tbg.banded_solve_padded(plan1, seeds, **warm, **mode)
        assert res.converged, mode
        _within(_fields(plan1, res.d_pad, 3), cold, ATOL, RTOL)


def test_reference_exclusions_raise():
    *_, tplan = _case("grid16")
    seeds = torch.tensor(SEEDS["grid16"])
    with pytest.raises(ValueError, match="four_dir"):
        tbg.banded_solve_padded(tplan, seeds, converge="pred", four_dir=True)
    with pytest.raises(ValueError, match="scan_dirs"):
        tbg.banded_solve_padded(tplan, seeds, scan_dirs="down")
    with pytest.raises(ValueError, match="transpose"):
        tbg.banded_solve_padded(tplan, seeds, four_dir=True,
                                plan_t=tbg.transpose_banded_plan(_case("irr12")[-1]))
    prob = tbg.prepare_padded(tplan, seeds)
    d = prob.d0.clone()
    dirty = torch.zeros((1, d.shape[0]), dtype=torch.int32)
    with pytest.raises(ValueError, match="skip=False"):
        tbg.directional_pass(d, prob.down, prob.a_fwd, prob.a_bwd, reverse=False, atol=ATOL,
                             rtol=RTOL, dirty=dirty, skip=False)
    with pytest.raises(ValueError, match="defer"):
        tbg.directional_pass(d, prob.down, prob.a_fwd, prob.a_bwd, reverse=False, atol=ATOL,
                             rtol=RTOL, defer=True)


# --------------------------------------------------------------------------
# bfloat16 in the banded tier
# --------------------------------------------------------------------------

def test_bf16_banded_solve_matches_reference():
    *_, tplan = _case("grid16")
    res = _port("grid16", dtype=torch.bfloat16)
    assert res.d_pad.dtype == torch.bfloat16
    got = _fields(tplan, res.d_pad, 3)
    assert not np.isnan(got).any()
    _within(got, _fields(tplan, _ref("grid16", dtype=jnp.bfloat16), 3), BF_ATOL, BF_RTOL)


def test_bf16_class_and_check_read_the_field_in_f32():
    """class_pred (int8, the certificate, ids) and check on a bfloat16 field
    equal themselves on the field widened to f32."""
    *_, tplan = _case("grid16")
    d = _port("grid16", dtype=torch.bfloat16).d_pad
    w8 = tbg._w8_planes(tplan, d.shape[0])
    kw = dict(R=tplan.n_rows, C=tplan.n_cols, V=tplan.num_vertices, tol=1e-2)
    for extra in ({"check": (BF_ATOL, BF_RTOL)}, {"as_class": False}):
        a, fa = tbg.class_pred(d, w8, **kw, **extra)
        b, fb = tbg.class_pred(d.float(), w8, **kw, **extra)
        assert torch.equal(a, b) and (fa is None or bool(fa) == bool(fb))
    assert bool(tbg.check(d, w8, atol=BF_ATOL, rtol=BF_RTOL)) == bool(
        tbg.check(d.float(), w8, atol=BF_ATOL, rtol=BF_RTOL))


def _scenarios(v, B=4):
    rng = np.random.default_rng(11)
    ids = rng.integers(0, len(v), (2, B))
    return v[ids[0]].astype(np.float32), v[ids[1]].astype(np.float32)


@pytest.mark.parametrize("light", [True, False], ids=["light", "full"])
def test_bf16_plan_batch_banded_matches_reference(light):
    v, _, jm, tm, _, W, _, jplan, tplan = _case("grid16")
    s, g = _scenarios(v)
    jpl = JDijkstraPlanner(jm, JPlannerConfig(cost_limit=1.0), max_path_len=96)
    jres = jpl.plan_batch_banded(jnp.asarray(W), jplan, jnp.asarray(s), jnp.asarray(g),
                                 light=light, dtype=jnp.bfloat16)
    tpl = DijkstraPlanner(tm, PlannerConfig(cost_limit=1.0), max_path_len=96, device="cpu")
    tres = tpl.plan_batch_banded(tplan, torch.from_numpy(s), torch.from_numpy(g), light=light,
                                 dtype=torch.bfloat16)
    np.testing.assert_array_equal(tres.outcome.numpy(), np.asarray(jres.outcome))
    reached = tres.outcome.numpy() == 0
    assert reached.all()
    # paths of the two bf16 fields: equal where the tables agree, each cost
    # within the bf16 tolerance of the other's
    np.testing.assert_allclose(tres.cost.numpy(), np.asarray(jres.cost), rtol=2e-2)
    if not light:
        assert tres.potential.dtype == torch.float32
        _within(tres.potential.numpy(), np.asarray(jres.potential), BF_ATOL, BF_RTOL)
        assert (tres.pred.numpy() == np.asarray(jres.pred)).mean() > 0.9


# --------------------------------------------------------------------------
# bfloat16 in the structured tier
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _structured_case():
    v, f = synthetic.terrain_mesh(24, 24, spacing=0.5, hills=2.0, roughness=0.02, seed=3)
    jm = reference_build_mesh(v, f)
    tm = build_mesh(v, f, device="cpu")
    costs = np.random.default_rng(0).uniform(0, 0.6, len(v)).astype(np.float32)
    W = jsweeps.slot_weights_np(jm, costs, cost_limit=1.0, edge_cost_factor=1.0)
    return jm, tm, W, np.asarray([3, 300, 511], np.int32)


@pytest.mark.parametrize("tile,n_inner", [(0, 0), (256, 1)])
def test_bf16_structured_bit_for_bit_the_reference_roll_path(tile, n_inner):
    """The port's fused sweeps (tile and n_inner of either schedule) against
    the reference's Jacobi roll path: a monotone rounded min-plus operator
    iterated from +inf reaches the same greatest fixed point under any
    schedule, so the bfloat16 fields agree bit for bit."""
    jm, tm, W, seeds = _structured_case()
    jp = jst.build_offset_plan(jm, jnp.asarray(W))
    tp = tst.build_offset_plan(tm, W)
    ref = jst.batched_field_structured(jm, jnp.asarray(W), jp, jnp.asarray(seeds),
                                       use_pallas=False, dtype=jnp.bfloat16)
    got = tst.batched_field_structured(tm, torch.from_numpy(W), tp, torch.from_numpy(seeds),
                                       dtype=torch.bfloat16, tile=tile, n_inner=n_inner)
    assert got.converged and bool(ref.converged)
    assert got.dist.dtype == torch.float32
    np.testing.assert_array_equal(got.dist.numpy(), np.asarray(ref.dist))
    same = got.pred.numpy() == np.asarray(ref.pred)
    assert same.mean() > 0.99


def test_bf16_structured_within_the_reference_bounds_of_f32():
    jm, tm, W, seeds = _structured_case()
    tp = tst.build_offset_plan(tm, W)
    a = tst.batched_field_structured(tm, torch.from_numpy(W), tp, torch.from_numpy(seeds))
    b = tst.batched_field_structured(tm, torch.from_numpy(W), tp, torch.from_numpy(seeds),
                                     dtype=torch.bfloat16)
    a, b = a.dist.numpy(), b.dist.numpy()
    fin = np.isfinite(a)
    assert (np.isfinite(b) == fin).all()
    rel = np.abs(b[fin] - a[fin]) / np.maximum(a[fin], 0.5)
    assert rel.max() < 0.02, rel.max()
    assert rel.mean() < 0.005, rel.mean()


def test_bf16_fused_sweep_is_a_bf16_add_and_min():
    """One plain fused sweep on a bfloat16 matrix: every candidate is the f32
    sum of two bfloat16 values rounded to nearest-even, the min taken in
    bfloat16."""
    rng = np.random.default_rng(5)
    T, Vp, B = 8, 32, 4
    d = torch.from_numpy(rng.uniform(0, 50, (Vp + 2 * T, B)).astype(np.float32)).bfloat16()
    d[:T] = np.inf
    d[T + Vp:] = np.inf
    planes = torch.from_numpy(rng.uniform(0, 3, (2, Vp)).astype(np.float32)).bfloat16()
    out = tsg.fused_sweep(d, planes, (1, -1), tile=T, n_inner=1)
    c = d[T:T + Vp].float()
    src_p, src_m = d[T + 1:T + Vp + 1].float(), d[T - 1:T + Vp - 1].float()
    # offsets reach out of the tile into the input's neighbours, as the tile's halo
    ref = torch.minimum(c, torch.minimum((src_p + planes[0, :, None].float()).bfloat16().float(),
                                         (src_m + planes[1, :, None].float()).bfloat16().float()))
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(out[T:T + Vp].float().numpy(), ref.numpy())


def test_deferring_pass_stops_where_the_reference_does_at_a_loose_tolerance():
    """At the main path's tolerance (atol 1e-4, rtol 2e-3) the deferring
    pass's quiet round stops farther above the fixed point than the
    default's (its down pass writes a row only where a gain passes the
    tolerance and scans nothing), and the reference's deferring solve stops
    as far: within twice the stopping tolerance of the port's field, each
    reading the heap oracle at more than ten times the default's error."""
    *_, jplan, tplan = _case("grid16")
    kw = dict(atol=1e-4, rtol=2e-3)
    B = len(SEEDS["grid16"])
    port = _fields(tplan, _port("grid16", scan_dirs="up", **kw).d_pad, B)
    default = _fields(tplan, _port("grid16", **kw).d_pad, B)
    ref = _fields(tplan, _ref("grid16", scan_dirs="up", **kw), B)
    _within(port, ref, 1e-4, 2e-3)
    orc = _oracle("grid16")
    fin = np.isfinite(orc)
    err = lambda x: float((np.abs(x[fin] - orc[fin]) / orc[fin].clip(1e-3)).max())   # noqa: E731
    assert err(port) > 10 * err(default) and err(ref) > 10 * err(default)
