"""Port vs reference for the two kernels' plain versions and the solve loop.

The reference runs its Pallas kernels in interpret mode on the CPU, as its
own tests do; the port runs the plain PyTorch versions (what its wrappers
take for CPU tensors). Both sides are fed the same plan, carried across with
convert.plan_from_numpy.

Tolerances. A pass's writes and flags are gated on
cand*(1+rtol)+atol < cur, and the in-row scans may sum chain weights in
another order (the reference uses a two-level scan on wide rows), so fields
agree within the stopping tolerance atol + rtol*|d|. The int8 class table
and the violation flag are compared exactly on one and the same field.
Against the native heap Dijkstra the fields match within rtol 1e-3 /
atol 1e-4, as tests/test_pallas_banded.py holds the reference.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_reference import reference_build_mesh as jax_build_mesh
from mesh_navigation_tpu.mesh import synthetic
from mesh_navigation_tpu.ops import pallas_banded as jpb
from mesh_navigation_tpu.ops import sweeps as jsweeps

from mesh_navigation_torch import convert
from mesh_navigation_torch.mesh.arrays import build_mesh
from mesh_navigation_torch.native import NativeMesh
from mesh_navigation_torch.ops import banded_gpu as tbg

torch.set_num_threads(2)

ATOL, RTOL = 1e-5, 1e-5


def _problem(kind):
    if kind == "terrain16":
        v, f = synthetic.terrain_mesh(16, 16, spacing=0.5, hills=1.5, roughness=0.02, seed=3)
        costs = np.asarray(0.1 * np.sin(np.arange(len(v))) ** 2, np.float32)
        seeds = [5, 200, 77, 130]
    elif kind == "wide64":
        v, f = synthetic.terrain_mesh(6, 64, spacing=0.5, hills=1.0, roughness=0.01, seed=1)
        costs = np.zeros(len(v), np.float32)
        seeds = [3, 300, 129]
    else:   # column walls: the geodesics go down, up and down again, so the
        # solve needs two or more rounds; a walled pocket stays inf
        n = 24
        v, f = synthetic.terrain_mesh(n, n, spacing=0.5, hills=1.0, seed=2)
        costs = np.zeros(len(v), np.float32)
        costs[np.arange(0, 21) * n + 8] = np.inf
        costs[np.arange(3, 24) * n + 16] = np.inf
        costs[20 * n + np.arange(19, 24)] = np.inf
        costs[np.arange(20, 24) * n + 19] = np.inf
        seeds = [2 * n + 4, 12 * n + 12, 0]
    jm = jax_build_mesh(v, f)
    W = jsweeps.slot_weights_np(jm, costs, cost_limit=1.0, edge_cost_factor=1.0)
    jplan = jpb.build_banded_kernel_plan(jm, W)
    arrays = {k: (None if getattr(jplan, k) is None else np.asarray(getattr(jplan, k)))
              for k in tbg.PLAN_ARRAYS}
    meta = {k: getattr(jplan, k) for k in tbg.PLAN_META}
    tplan = convert.plan_from_numpy(arrays, meta, device="cpu")
    return v, f, costs, jm, jplan, tplan, np.asarray(seeds, np.int32)


def _within_stop_tol(got, ref):
    fin = np.isfinite(ref)
    assert np.array_equal(fin, np.isfinite(got))
    err = np.abs(got[fin] - ref[fin])
    assert np.all(err <= ATOL + RTOL * np.abs(ref[fin])), float(err.max())


@pytest.mark.parametrize("kind", ["terrain16", "wide64"])
def test_pass_plain_matches_pallas_interpret(kind):
    _, _, _, _, jplan, tplan, seeds = _problem(kind)
    jprob = jpb.prepare_padded(jplan, jnp.asarray(seeds), rb=2, bb=8)
    tprob = tbg.prepare_padded(tplan, torch.from_numpy(seeds), rb=2, bb=8)
    for name in ("d0", "down", "up", "a_fwd", "a_bwd"):
        np.testing.assert_array_equal(getattr(tprob, name).numpy(), np.asarray(getattr(jprob, name)))
    n_scan2 = jplan.n_scan2
    af, ab = jprob.a_fwd, jprob.a_bwd
    if n_scan2:
        af, ab = af[:, :3], ab[:, :3]
    dirty = jnp.zeros((1, 1), jnp.int32)
    d_j = jprob.d0
    d_t = tprob.d0.clone()
    for reverse, force, cross_j, cross_t in (
        (False, True, jprob.down, tprob.down), (True, False, jprob.up, tprob.up),
    ):
        d_j, chg_j, _ = jpb._directional_pass_pallas(
            d_j, cross_j, af, ab, jprob.xdown, jprob.l2_fwd, jprob.l2_bwd,
            jprob.wback, dirty, reverse=reverse, rb=2, bb=8,
            n_scan=af.shape[1], n_scan2=n_scan2, atol=ATOL, rtol=RTOL,
            interpret=True, skip=True, force=force, use_dirty=False,
        )
        chg_t = tbg.directional_pass(
            d_t, cross_t, tprob.a_fwd, tprob.a_bwd, reverse=reverse, bb=8,
            atol=ATOL, rtol=RTOL, force=force,
        )
        assert bool(chg_t.item()) == bool(chg_j)
        _within_stop_tol(d_t.numpy(), np.asarray(d_j))


def _flat_scan(row, af, ab):
    """The reference's flat Hillis-Steele lateral scan (pallas_banded.py:
    958-966) in numpy f32: row [C, B], chain-weight stacks af/ab [S, C]."""
    def shift(x, k):
        out = np.full_like(x, np.inf)
        if k > 0:
            out[k:] = x[:-k]
        else:
            out[:k] = x[-k:]
        return out

    row = row.copy()
    for s in range(af.shape[0]):
        row = np.minimum(row, shift(row, 1 << s) + af[s][:, None])
    for s in range(ab.shape[0]):
        row = np.minimum(row, shift(row, -(1 << s)) + ab[s][:, None])
    return row


@pytest.mark.parametrize("kind", ["terrain16", "walls24"])
def test_scan_row_is_the_flat_scan_within_one_warp(kind):
    """Rows of at most 32 columns are scanned one column a thread in one
    warp: the reference's flat scan over its chain tables, bit for bit.
    Wider rows sum in the kernel's association (several columns a thread),
    within the stopping tolerance of the flat scan."""
    *_, tplan, _ = _problem(kind)
    Cp = tplan.n_cols_pad
    assert Cp <= 32 and tbg.pass_cols_per_thread(Cp) == 1
    rng = np.random.default_rng(Cp)
    for r in range(0, tplan.n_rows, 5):
        row = rng.uniform(0, 20, (Cp, 8)).astype(np.float32)
        row[rng.uniform(size=row.shape) < 0.4] = np.inf
        af, ab = tplan.a_fwd[r].numpy(), tplan.a_bwd[r].numpy()
        got = tbg._scan_row(torch.from_numpy(row), tplan.a_fwd[r], tplan.a_bwd[r]).numpy()
        np.testing.assert_array_equal(got, _flat_scan(row, af, ab))
    wide = _problem("wide64")[-2]
    assert wide.n_cols_pad == 64 and tbg.pass_cols_per_thread(64) > 1
    for r in range(wide.n_rows):
        row = rng.uniform(0, 20, (64, 8)).astype(np.float32)
        got = tbg._scan_row(torch.from_numpy(row), wide.a_fwd[r], wide.a_bwd[r]).numpy()
        ref = _flat_scan(row, wide.a_fwd[r].numpy(), wide.a_bwd[r].numpy())
        assert np.all(np.abs(got - ref) <= ATOL + RTOL * np.abs(ref))


@pytest.mark.parametrize("kind", ["terrain16", "walls24"])
def test_solve_matches_reference_and_oracle(kind):
    v, f, costs, jm, jplan, tplan, seeds = _problem(kind)
    jres = jpb.banded_solve_padded(jplan, jnp.asarray(seeds), atol=ATOL, rtol=RTOL, converge="pred")
    tres = tbg.banded_solve_padded(tplan, torch.from_numpy(seeds), atol=ATOL, rtol=RTOL, converge="pred")
    assert tres.converged and bool(jres.converged)
    if kind == "walls24":
        assert tres.rounds >= 2
    R, C, V, B = tplan.n_rows, tplan.n_cols, tplan.num_vertices, len(seeds)
    got = tres.d_pad[:R, :C, :B].reshape(R * C, B)[:V].numpy()
    ref = np.asarray(jres.d_pad)[:R, :C, :B].reshape(R * C, B)[:V]
    _within_stop_tol(got, ref)
    nm = NativeMesh(v, f)
    edges = nm.tables()["edges"]
    dist = np.linalg.norm(v[edges[:, 1]] - v[edges[:, 0]], axis=1).astype(np.float32)
    c1, c2 = costs[edges[:, 0]], costs[edges[:, 1]]
    ew = np.where(np.isinf(c1) | np.isinf(c2), np.inf,
                  dist + dist * (c1 + c2) * 0.5).astype(np.float32)
    for b, s in enumerate(seeds):
        od, _ = nm.dijkstra(ew, costs, int(s), 1.0)
        fin = np.isfinite(od)
        assert np.array_equal(fin, np.isfinite(got[:, b]))
        if kind == "walls24":
            assert not fin.all()
        np.testing.assert_allclose(got[fin, b], od[fin], rtol=1e-3, atol=1e-4)
    nm.close()


@pytest.mark.parametrize("converged", [False, True])
def test_class_pred_identical_on_reference_field(converged):
    _, _, _, _, jplan, tplan, seeds = _problem("walls24")
    if converged:
        d_pad = jpb.banded_solve_padded(jplan, jnp.asarray(seeds), atol=ATOL, rtol=RTOL).d_pad
    else:   # one round only: the certificate must report the violation
        d_pad = jpb.banded_solve_padded(jplan, jnp.asarray(seeds), atol=ATOL, rtol=RTOL, max_rounds=1).d_pad
    tol = max(ATOL, 3 * RTOL)
    cls_j, ok_j = jpb.predecessors_banded_classes(jplan, d_pad, tol=tol, check=(ATOL, RTOL))
    cls_t, ok_t = tbg.predecessors_banded_classes(
        tplan, torch.from_numpy(np.array(d_pad)), tol=tol, check=(ATOL, RTOL)
    )
    np.testing.assert_array_equal(cls_t.numpy(), np.asarray(cls_j))
    assert ok_t == bool(ok_j) == converged


def test_extract_and_pred_at_vertices_identical():
    _, _, _, _, jplan, tplan, seeds = _problem("terrain16")
    jres = jpb.banded_solve_padded(jplan, jnp.asarray(seeds), atol=ATOL, rtol=RTOL, converge="pred")
    cls = np.array(jres.cls)
    C, V = tplan.n_cols, tplan.num_vertices
    starts = np.asarray([250, 17, 100, 3], np.int32)
    pj, vj = jpb.extract_paths_cls(jnp.asarray(cls), jnp.asarray(starts), jnp.asarray(seeds), 64, C)
    pt, vt = tbg.extract_paths_cls(torch.from_numpy(cls), torch.from_numpy(starts),
                                   torch.from_numpy(seeds), 64, C, chunk=16)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    d_pad = np.array(jres.d_pad)
    dflat = d_pad.reshape(-1, d_pad.shape[-1])
    rng = np.random.default_rng(4)
    vids = rng.integers(0, V, (4, 3)).astype(np.int32)
    vids[1, 0] = seeds[1]                       # a seed: pred = self
    lane_map = np.asarray([2, 0, 3, 1], np.int32)
    qj = jpb.pred_at_vertices(jplan, jnp.asarray(dflat), jnp.asarray(vids), tol=1e-5,
                              lane_minor=True, lane_map=jnp.asarray(lane_map), padded_flat=True)
    qt = tbg.pred_at_vertices(tplan, torch.from_numpy(dflat), torch.from_numpy(vids), tol=1e-5,
                              lane_map=torch.from_numpy(lane_map))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))


def test_zero_tolerance_pred_convergence_refused():
    *_, tplan, seeds = _problem("terrain16")
    with pytest.raises(AssertionError):
        tbg.banded_solve_padded(tplan, torch.from_numpy(seeds), atol=0.0, rtol=0.0, converge="pred")
