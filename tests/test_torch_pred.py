"""Port vs reference: the class-pred pass's int32-id mode, the roll-based
predecessors_banded, the full-result batched_field_banded_pallas and the
full (non-light) banded plan result.

The reference runs `predecessors_banded_pallas` with its Pallas kernel in
interpret mode on the CPU (as tests/test_pallas_banded.py runs it); the port
runs the plain PyTorch version its wrapper takes for CPU tensors. Both sides
read one and the same padded field (the reference's solve), so the int32
tables are compared exactly.

The reference's full plan result recovers predecessors with the roll-based
`predecessors_banded`, which visits the classes in another order than
`_pred_kernel`: where two in-edges tie under the strict <, the two pick
different ids of equal cost. Ids are compared exactly where the argmin is
unique, and every differing id is checked to be an in-edge of the best
cost. Fed one and the same [V, B] field, the port's predecessors_banded
is the reference's bit for bit, ties included (the same f32 sums in the
same class order); its irregular cases are in test_torch_irregular.py.

Tolerances. The port's banded solve and the reference's agree within the
stopping tolerance atol + rtol*|d| (tests/test_torch_banded.py); path costs
are Euclidean sums along paths of equal weighted cost, within 1e-4
relative; vector maps, a norm and a division, within 1e-6 where the
predecessors agree."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mesh_navigation_tpu.config import PlannerConfig as JPlannerConfig
from mesh_navigation_tpu.ops import pallas_banded as jpb
from mesh_navigation_tpu.ops import sweeps as jsweeps
from mesh_navigation_tpu.planners import DijkstraPlanner as JDijkstraPlanner

from mesh_navigation_torch.config import PlannerConfig
from mesh_navigation_torch.mesh.arrays import build_mesh
from mesh_navigation_torch.ops import banded_gpu as tbg
from mesh_navigation_torch.ops import sweeps as tsweeps
from mesh_navigation_torch.planners import DijkstraPlanner

import roll_pred_checks as checks
from test_torch_banded import ATOL, RTOL, _problem

torch.set_num_threads(2)

PRED_TOL = max(ATOL, 1e-6)      # the full result's predecessor tolerance
COST_LIMIT = 1.0                # the cost limit of _problem's slot weights

_case = functools.lru_cache(maxsize=None)(_problem)


@functools.lru_cache(maxsize=None)
def _field(kind, converged):
    """The reference's padded field of _problem(kind)'s seeds: converged, or
    after one round (where the certificate still reports a violation)."""
    *_, jplan, _, seeds = _case(kind)
    kw = {} if converged else {"max_rounds": 1}
    d_pad = jpb.banded_solve_padded(jplan, jnp.asarray(seeds), atol=ATOL, rtol=RTOL, **kw).d_pad
    return np.array(d_pad)


def _candidates(tplan, d_pad):
    """[8, V, Bp] candidate costs d[src_k] + w_k in class order and the
    [8] real-id offsets of the classes."""
    R, C, V = tplan.n_rows, tplan.n_cols, tplan.num_vertices
    d = torch.from_numpy(d_pad)
    w8 = tbg._w8_planes(tplan, d.shape[0])
    _, srcs = tbg._class_sources(d, 0, d.shape[0])
    cand = torch.stack([srcs[k] + w8[:, k, :, None] for k in range(8)])
    cand = cand[:, :R, :C].reshape(8, R * C, -1)[:, :V]
    return cand.numpy(), np.asarray(tbg._class_offsets(C))


@pytest.mark.parametrize("converged", [False, True])
@pytest.mark.parametrize("kind", ["walls24", "terrain16"])
def test_plain_ids_match_reference_kernel(kind, converged):
    *_, jplan, tplan, _ = _case(kind)
    d_pad = _field(kind, converged)
    ref = np.asarray(jpb.predecessors_banded_pallas(jplan, jnp.asarray(d_pad), tol=PRED_TOL))
    got = tbg.predecessors_banded_ids(tplan, torch.from_numpy(d_pad), tol=PRED_TOL)
    assert got.dtype == torch.int32 and tuple(got.shape) == (tplan.num_vertices, d_pad.shape[2])
    np.testing.assert_array_equal(got.numpy(), ref)
    # the same table straight from the wrapper, with the flag of the field
    ids, viol = tbg.class_pred(
        torch.from_numpy(d_pad), tbg._w8_planes(tplan, d_pad.shape[0]), R=tplan.n_rows,
        C=tplan.n_cols, V=tplan.num_vertices, tol=PRED_TOL, check=(ATOL, RTOL), as_class=False,
    )
    np.testing.assert_array_equal(ids.numpy(), ref)
    _, ok = jpb.predecessors_banded_classes(jplan, jnp.asarray(d_pad), tol=PRED_TOL,
                                            check=(ATOL, RTOL))
    assert bool(viol) == (not bool(ok))
    if kind == "walls24":       # one round leaves the walled field unconverged
        assert bool(viol) == (not converged)


@pytest.mark.parametrize("kind", ["walls24", "terrain16"])
def test_ids_equal_roll_based_recovery_where_the_argmin_is_unique(kind):
    *_, jplan, tplan, seeds = _case(kind)
    d_pad = _field(kind, True)
    R, C, V, B = tplan.n_rows, tplan.n_cols, tplan.num_vertices, len(seeds)
    dist = d_pad[:R, :C, :B].reshape(R * C, B)[:V]
    roll = np.asarray(jpb.predecessors_banded(jplan, jnp.asarray(dist), tol=PRED_TOL))
    ids = tbg.predecessors_banded_ids(tplan, torch.from_numpy(d_pad), tol=PRED_TOL)[:, :B].numpy()
    cand, off = _candidates(tplan, d_pad)
    cand = cand[..., :B]
    best = cand.min(axis=0)
    unique = (cand == best).sum(axis=0) == 1
    assert unique.mean() > 0.5
    np.testing.assert_array_equal(ids[unique], roll[unique])
    vid = np.arange(V)[:, None]
    for got, ref in ((ids, roll), (roll, ids)):
        differ = got != ref
        assert not np.any(differ & (got == vid)), "one side found no predecessor"
        k = np.argmax(vid[..., None] + off == got[..., None], axis=-1)   # class of each id
        ok = np.take_along_axis(cand, k[None], axis=0)[0] == best
        assert np.all(ok[differ]), "a differing id is not an in-edge of the best cost"


def _unpad(tplan, d_pad, B):
    R, C, V = tplan.n_rows, tplan.n_cols, tplan.num_vertices
    return np.ascontiguousarray(d_pad[:R, :C, :B].reshape(R * C, B)[:V])


def _pad(tplan, dist):
    """[R, Cp, B] +inf-padded copy of a [V, B] field."""
    R, C, Cp = tplan.n_rows, tplan.n_cols, tplan.n_cols_pad
    V, B = dist.shape
    out = np.full((R * C, B), np.inf, np.float32)
    out[:V] = dist
    d = np.full((R, Cp, B), np.inf, np.float32)
    d[:, :C] = out.reshape(R, C, B)
    return d


@pytest.mark.parametrize("kind", ["walls24", "terrain16"])
def test_roll_predecessors_equal_the_reference_bit_for_bit(kind):
    """predecessors_banded against the reference's, fed one and the same
    [V, B] field: the same f32 sums in the same class order, so the tables
    are equal everywhere, ties included; every non-self predecessor
    explains its label."""
    *_, jplan, tplan, seeds = _case(kind)
    d_pad = _field(kind, True)
    dist = _unpad(tplan, d_pad, len(seeds))
    ref = np.asarray(jpb.predecessors_banded(jplan, jnp.asarray(dist), tol=PRED_TOL))
    got = tbg.predecessors_banded(tplan, torch.from_numpy(dist), tol=PRED_TOL)
    assert got.dtype == torch.int32 and tuple(got.shape) == dist.shape
    np.testing.assert_array_equal(got.numpy(), ref)
    cand, _ = _candidates(tplan, d_pad)
    cand = cand[..., :len(seeds)]
    best = cand.min(axis=0)
    tie = ((cand == best).sum(axis=0) > 1) & np.isfinite(best)
    assert tie.any() == (kind == "walls24")      # zero costs: in-edges of equal length
    assert not checks.unexplained(tplan, dist, got.numpy(), PRED_TOL).any()


def _near_tie(tplan, dist, gap):
    """[V, B] bool: the best class in-edge of the field is within `gap`
    (relative) of another."""
    cand, _ = _candidates(tplan, _pad(tplan, dist))
    top2 = np.sort(cand, axis=0)[:2]
    scale = np.maximum(np.abs(dist), 1.0) * gap
    return ((top2[1] - top2[0]) <= scale) & np.isfinite(top2[0])


def test_full_result_matches_the_reference():
    """batched_field_banded_pallas against the reference's on terrain16:
    [B, V] f32 fields within the stopping tolerance, [B, V] int32
    predecessors equal where the argmin is unique by more than the two
    fields differ, each explaining its own label everywhere; converged."""
    v, f, costs, jm, jplan, tplan, seeds = _case("terrain16")
    W = jsweeps.slot_weights_np(jm, costs, cost_limit=COST_LIMIT, edge_cost_factor=1.0)
    want = jpb.batched_field_banded_pallas(jm, jnp.asarray(W), jplan, jnp.asarray(seeds),
                                           atol=ATOL, rtol=RTOL)
    got = tbg.batched_field_banded_pallas(build_mesh(v, f, device="cpu"), torch.from_numpy(W),
                                          tplan, torch.from_numpy(seeds), atol=ATOL, rtol=RTOL)
    B, V = len(seeds), tplan.num_vertices
    assert isinstance(got, tbg.BandedPallasResult) and got.converged is True
    assert bool(want.converged) and got.rounds >= 1
    assert tuple(got.dist.shape) == tuple(got.pred.shape) == (B, V)
    assert got.dist.dtype == torch.float32 and got.pred.dtype == torch.int32
    _assert_within_stop_tol(got.dist.numpy(), np.asarray(want.dist))
    dist, pred = got.dist.numpy().T, got.pred.numpy().T
    assert not checks.unexplained(tplan, dist, pred, PRED_TOL).any()
    tie = _near_tie(tplan, dist, 4 * (ATOL + RTOL))
    assert (~tie).mean() > 0.9
    np.testing.assert_array_equal(pred[~tie], np.asarray(want.pred).T[~tie])


def test_bf16_full_result_explains_its_labels_at_its_tolerance():
    """A bfloat16 full result: its field is the port's own bf16 solve,
    unpadded and widened, and every non-self predecessor explains its label
    at the bf16 predecessor tolerance 1e-2."""
    *_, tplan, seeds = _case("terrain16")
    s = torch.from_numpy(seeds)
    got = tbg.batched_field_banded_pallas(None, None, tplan, s, atol=ATOL, rtol=RTOL,
                                          dtype=torch.bfloat16)
    res = tbg.banded_solve_padded(tplan, s, atol=ATOL, rtol=RTOL, dtype=torch.bfloat16)
    assert got.converged and res.d_pad.dtype == torch.bfloat16
    own = torch.from_numpy(_unpad(tplan, res.d_pad.float().numpy(), len(seeds)))
    assert torch.equal(got.dist, own.T)
    pred = got.pred.numpy().T
    assert (pred != np.arange(tplan.num_vertices)[:, None]).mean() > 0.9
    assert not checks.unexplained(tplan, own.numpy(), pred, 1e-2).any()
    np.testing.assert_array_equal(pred, tbg.predecessors_banded(tplan, own, tol=1e-2).numpy())


@pytest.mark.parametrize("converged", [False, True])
@pytest.mark.parametrize("kind", ["walls24", "terrain16"])
def test_ids_and_classes_agree(kind, converged):
    *_, tplan, _ = _case(kind)
    d = torch.from_numpy(_field(kind, converged))
    cls = tbg.predecessors_banded_classes(tplan, d, tol=PRED_TOL).numpy().astype(np.int64)
    ids = tbg.predecessors_banded_ids(tplan, d, tol=PRED_TOL).numpy()
    delta = np.asarray(tbg._class_offsets(tplan.n_cols) + [0])
    vid = np.arange(tplan.num_vertices)[:, None]
    np.testing.assert_array_equal(ids, vid + delta[cls])
    assert (cls < 8).any() and (cls == 8).any()


def _scenarios(v, B=5):
    """Starts and goals on mesh vertices (the snap is exact), from a seed."""
    rng = np.random.default_rng(11)
    ids = rng.integers(0, len(v), (2, B))
    return v[ids[0]].astype(np.float32), v[ids[1]].astype(np.float32)


@functools.lru_cache(maxsize=None)
def _port_full(kind):
    v, f, costs, *_, tplan, _ = _case(kind)
    tm = build_mesh(v, f, device="cpu")
    tpl = DijkstraPlanner(tm, PlannerConfig(cost_limit=COST_LIMIT), max_path_len=96, device="cpu")
    s, g = _scenarios(v)
    res = tpl.plan_batch_banded(tplan, torch.from_numpy(s), torch.from_numpy(g), light=False,
                                atol=ATOL, rtol=RTOL)
    return tpl, res


def _assert_within_stop_tol(got, ref):
    fin = np.isfinite(ref)
    assert np.array_equal(fin, np.isfinite(got))
    assert np.all(np.abs(got[fin] - ref[fin]) <= ATOL + RTOL * np.abs(ref[fin]))


@pytest.mark.parametrize("kind", ["walls24", "terrain16"])
def test_full_banded_plan_matches_reference(kind):
    v, _, costs, jm, jplan, tplan, _ = _case(kind)
    s, g = _scenarios(v)
    W = jsweeps.slot_weights_np(jm, costs, cost_limit=COST_LIMIT, edge_cost_factor=1.0)
    jpl = JDijkstraPlanner(jm, JPlannerConfig(cost_limit=COST_LIMIT), max_path_len=96)
    jres = jpl.plan_batch_banded(jnp.asarray(W), jplan, jnp.asarray(s), jnp.asarray(g),
                                 light=False, atol=ATOL, rtol=RTOL)
    _, tres = _port_full(kind)
    B, V = len(s), tplan.num_vertices
    assert tres.converged
    assert tuple(tres.potential.shape) == (B, V) and tres.pred.dtype == torch.int32
    assert tuple(tres.vector_map.shape) == (B, V, 3)
    np.testing.assert_array_equal(tres.outcome.numpy(), np.asarray(jres.outcome))
    _assert_within_stop_tol(tres.potential.numpy(), np.asarray(jres.potential))
    reached = tres.outcome.numpy() == 0
    assert reached.sum() >= B - 1
    np.testing.assert_allclose(tres.cost.numpy()[reached], np.asarray(jres.cost)[reached],
                               rtol=1e-4)
    same = tres.pred.numpy() == np.asarray(jres.pred)
    assert same.mean() > 0.9
    np.testing.assert_allclose(tres.vector_map.numpy()[same], np.asarray(jres.vector_map)[same],
                               atol=1e-6)


@pytest.mark.parametrize("kind", ["walls24", "terrain16"])
def test_full_banded_plan_matches_structured_full_result(kind):
    """The banded full result against the structured tier's on the same mesh,
    weights and scenarios (an exact least fixed point, so the banded
    potential sits within the stopping tolerance above it)."""
    v, _, costs, *_ = _case(kind)
    tpl, tres = _port_full(kind)
    W = tsweeps.slot_weights_np(tpl.mesh, costs, cost_limit=COST_LIMIT, edge_cost_factor=1.0)
    s, g = _scenarios(v)
    sres = tpl.plan_batch_structured(torch.from_numpy(W), tpl.prepare_offset_plan(W),
                                     torch.from_numpy(s), torch.from_numpy(g))
    np.testing.assert_array_equal(tres.outcome.numpy(), sres.outcome.numpy())
    _assert_within_stop_tol(tres.potential.numpy(), sres.potential.numpy())
    reached = tres.outcome.numpy() == 0
    np.testing.assert_allclose(tres.cost.numpy()[reached], sres.cost.numpy()[reached], rtol=1e-4)
    np.testing.assert_array_equal(tres.path_valid.numpy().sum(1) > 0,
                                  sres.path_valid.numpy().sum(1) > 0)


def test_weight_stack_is_built_once_per_plan_and_rows():
    _, _, costs, _, _, tplan, _ = _case("terrain16")
    tplan.w8_cache.clear()
    Rp = tplan.n_rows + 2
    a = tbg._w8_planes(tplan, Rp)
    assert tbg._w8_planes(tplan, Rp) is a and tuple(a.shape) == (Rp, 8, tplan.n_cols_pad)
    assert tbg._w8_planes(tplan, tplan.n_rows) is not a
    assert torch.equal(a[tplan.n_rows:], torch.full_like(a[tplan.n_rows:], np.inf))
    refreshed = tbg.refresh_banded_planes_from_costs(
        tplan, torch.from_numpy(costs) * 2, edge_cost_factor=1.0, cost_limit=COST_LIMIT)
    assert refreshed.w8_cache == {}
    b = tbg._w8_planes(refreshed, Rp)
    assert b is not a and not torch.equal(a, b)
