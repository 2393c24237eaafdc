"""The row-scan banded solver (ops/banded.py) and the banded path walks
(extract_paths_vb, descend_paths) of the port against the JAX package, on
the CPU, with the same numpy inputs.

Plans are bit-equal (the same numpy classification). The fields agree
within the stopping tolerance atol + rtol*|d|: both stop on a quiet round,
and the port's doubling scan associates the lateral sums otherwise than
the reference's associative_scan. Predecessors are equal where the arg-min
over the slots is unique by more than the fields' difference allows; path
ids, walked from the same tables, are equal."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mesh_navigation_tpu.mesh import synthetic
from mesh_navigation_tpu.ops import banded as jbanded
from mesh_navigation_tpu.ops import pallas_banded as jpb
from mesh_navigation_tpu.ops import sweeps as jsweeps

from mesh_navigation_torch import convert
from mesh_navigation_torch.mesh.arrays import FIELDS, build_mesh
from mesh_navigation_torch.ops import banded as tbanded
from mesh_navigation_torch.ops import banded_gpu as tbg

from test_torch_reference import reference_build_mesh

torch.set_num_threads(2)

ATOL, RTOL = 1e-5, 1e-5


def _problem(kind):
    if kind == "grid":
        v, f = synthetic.terrain_mesh(24, 20, spacing=0.5, hills=1.5, roughness=0.02, seed=3)
        jm = reference_build_mesh(v, f)
        tm = build_mesh(v, f, device="cpu")
    else:
        v, f = synthetic.irregular_terrain_mesh(16, 16, spacing=0.5, jitter=0.4, hills=1.0,
                                                seed=6)
        jm = reference_build_mesh(v, f, reorder=True)
        tm = convert.mesh_from_numpy({k: np.asarray(getattr(jm, k)) for k in FIELDS},
                                     device="cpu")
    rng = np.random.default_rng(1)
    costs = rng.uniform(0.0, 0.6, jm.num_vertices).astype(np.float32)
    costs[rng.integers(0, jm.num_vertices, jm.num_vertices // 25)] = np.inf
    W = jsweeps.slot_weights_np(jm, costs, cost_limit=2.0, edge_cost_factor=1.0)
    return jm, tm, W


@pytest.mark.parametrize("kind", ["grid", "irregular"])
def test_build_banded_plan_matches_reference(kind):
    jm, tm, W = _problem(kind)
    jp = jbanded.build_banded_plan(jm, jnp.asarray(W))
    tp = tbanded.build_banded_plan(tm, W)
    assert (tp.n_rows, tp.n_cols) == (jp.n_rows, jp.n_cols)
    assert tp.coverage == jp.coverage
    if kind == "irregular":
        assert tp.coverage < 1.0
    for k in ("lat_fwd", "lat_bwd", "down", "up", "res_dst", "res_src", "res_w"):
        np.testing.assert_array_equal(getattr(tp, k).numpy(), np.asarray(getattr(jp, k)), k)


def test_minplus_combine_folds_to_the_row_closure():
    """The doubling scan of _row_closure against a left fold of
    _minplus_combine over the row (forward) and its mirror (backward)."""
    rng = np.random.default_rng(4)
    C, B = 13, 3
    wf = rng.uniform(0.1, 1.0, (1, C)).astype(np.float32)
    wb = rng.uniform(0.1, 1.0, (1, C)).astype(np.float32)
    wf[0, [0, 6]] = np.inf
    wb[0, [C - 1, 9]] = np.inf
    row = rng.uniform(0.0, 8.0, (C, B)).astype(np.float32)
    row[[2, 7]] = np.inf
    t = torch.from_numpy
    got = tbanded._row_closure(
        t(row).clone(), [x[0] for x in tbanded._chain_levels(t(wf), True)],
        [x[0] for x in tbanded._chain_levels(t(wb), False)])
    acc = (t(wf[0, :1]), t(row[0]))
    fwd = [acc[1]]
    for i in range(1, C):
        acc = tbanded._minplus_combine(acc, (t(wf[0, i:i + 1]), t(row[i])))
        fwd.append(acc[1])
    acc = (t(wb[0, C - 1:]), fwd[C - 1])
    out = [acc[1]]
    for i in range(C - 2, -1, -1):
        acc = tbanded._minplus_combine(acc, (t(wb[0, i:i + 1]), fwd[i]))
        out.append(acc[1])
    ref = torch.stack(out[::-1]).numpy()
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(got.numpy()), fin)
    np.testing.assert_allclose(got.numpy()[fin], ref[fin], rtol=1e-6, atol=1e-6)


def _unique_argmin(jm, W, dist_vb, margin):
    """[V, B] True where the best slot of dist[u] + w beats every other
    slot by more than `margin`."""
    adj = np.asarray(jm.adj_vertex)
    cand = dist_vb[adj] + W[:, :, None]                # [V, D, B]
    cand = np.where(np.isfinite(cand), cand, np.inf)
    s = np.sort(cand, axis=1)
    with np.errstate(invalid="ignore"):
        return (s[:, 1] - s[:, 0] > margin) | ~np.isfinite(s[:, 1])


@pytest.mark.parametrize("kind", ["grid", "irregular"])
def test_batched_field_banded_matches_reference(kind):
    jm, tm, W = _problem(kind)
    V = jm.num_vertices
    seeds = np.asarray([0, 17, V // 2, (3 * V) // 4, V - 1], np.int32)
    jres = jbanded.batched_field_banded(jm, jnp.asarray(W), jbanded.build_banded_plan(
        jm, jnp.asarray(W)), jnp.asarray(seeds), atol=ATOL, rtol=RTOL)
    tres = tbanded.batched_field_banded(tm, torch.from_numpy(W), tbanded.build_banded_plan(tm, W),
                                        torch.from_numpy(seeds), atol=ATOL, rtol=RTOL)
    assert tres.converged and bool(jres.converged)
    ref, got = np.asarray(jres.dist), tres.dist.numpy()
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    err = np.abs(got[fin] - ref[fin])
    assert np.all(err <= ATOL + RTOL * np.abs(ref[fin])), float(err.max())
    uniq = _unique_argmin(jm, W, ref.T, 4 * (ATOL + RTOL * np.nanmax(ref[fin]))).T
    jpred, tpred = np.asarray(jres.pred), tres.pred.numpy()
    assert uniq.mean() > 0.5
    np.testing.assert_array_equal(tpred[uniq], jpred[uniq])


def test_walks_match_reference():
    """extract_paths_vb over the reference's [V, B] predecessor table and
    descend_paths over its [B, V] field, both with the same plan: path ids
    and valid masks equal."""
    jm, tm, W = _problem("grid")
    jplan = jpb.build_banded_kernel_plan(jm, W)
    arrays = {k: (None if getattr(jplan, k) is None else np.asarray(getattr(jplan, k)))
              for k in tbg.PLAN_ARRAYS}
    tplan = convert.plan_from_numpy(arrays, {k: getattr(jplan, k) for k in tbg.PLAN_META},
                                    device="cpu")
    goals = np.asarray([5, 120, 301, 402, 77, 250], np.int32)
    starts = np.asarray([400, 3, 60, 0, 470, 250], np.int32)
    field = jbanded.batched_field_banded(jm, jnp.asarray(W), jbanded.build_banded_plan(
        jm, jnp.asarray(W)), jnp.asarray(goals), atol=ATOL, rtol=RTOL)
    dist, pred = np.asarray(field.dist), np.asarray(field.pred)
    L = 96
    jp, jv = jpb.extract_paths_vb(jnp.asarray(pred.T), jnp.asarray(starts), jnp.asarray(goals), L)
    tp, tv = tbg.extract_paths_vb(torch.from_numpy(np.ascontiguousarray(pred.T)),
                                  torch.from_numpy(starts), torch.from_numpy(goals), L, chunk=32)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert tv.numpy().sum(axis=1).max() > 10
    jp, jv = jpb.descend_paths(jplan, jnp.asarray(dist), jnp.asarray(starts), jnp.asarray(goals),
                               L, tol=1e-4)
    tp, tv = tbg.descend_paths(tplan, torch.from_numpy(dist.copy()), torch.from_numpy(starts),
                               torch.from_numpy(goals), L, tol=1e-4, chunk=32)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    # each descent ends at its goal where the start is reached
    last = tp.numpy()[np.arange(len(starts)), tv.numpy().sum(axis=1) - 1]
    reached = np.isfinite(dist[np.arange(len(starts)), starts])
    np.testing.assert_array_equal(last[reached], goals[reached])
