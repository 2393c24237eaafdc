"""The row-sharded banded solve (mesh_navigation_torch/parallel/sharded_banded.py)
against the reference's plan builder, the port's single-device solve and
the heap oracle.

The port's plan tables are held bit for bit against the reference's
build_sharded_banded_plan(..., interpret=True) on the owned and ghost rows
(the reference pads a shard's rows to its row block; the port's pass has
none). The solves run in n gloo ranks on the CPU, spawned from
tests/torch_parallel_ranks.py, on the plain pass; they are held against the
port's single-device banded_solve_padded (rtol 1e-6: block-Jacobi across
the cuts reaches the same fixed point up to the last bit of a chain sum)
and the heap oracle (rtol 1e-5, as tests/test_sharded_banded.py holds the
reference). The reference's Pallas interpret path is not run: the oracle
is the cheaper comparator that reaches the same fixed point.
"""

import functools

import numpy as np
import pytest
import torch

from test_torch_reference import reference_build_mesh
from mesh_navigation_tpu.mesh import synthetic
from mesh_navigation_tpu.ops import pallas_banded as jpb
from mesh_navigation_tpu.ops import sweeps as jsweeps
from mesh_navigation_tpu.parallel import sharded_banded as jsb

from mesh_navigation_torch.mesh import reorder as treorder
from mesh_navigation_torch.mesh.arrays import build_mesh
from mesh_navigation_torch.ops import banded_gpu as tbg
from mesh_navigation_torch.parallel import build_sharded_banded_plan
from mesh_navigation_torch.utils import oracle

import torch_parallel_ranks as ranks

torch.set_num_threads(2)

# the meshes, costs, cost limits and seeds of tests/test_sharded_banded.py
CASES = {
    "terrain24": dict(seed_costs=4, limit=1.0, seeds=[3, 101, 399]),
    "irregular20": dict(seed_costs=6, limit=2.0, seeds=[7, 120, 311]),
}
PLANE_KEYS = ("down", "up", "a_fwd", "a_bwd", "xdown", "xup")
TABLE_KEYS = ("res_src", "res_dst", "res_w", "far_src", "far_own", "far_idx", "far_dst", "far_w")
META_KEYS = ("n_residual", "n_far", "ghost", "n_shards", "rows_per_shard", "n_scan", "n_rows",
             "n_cols", "n_cols_pad", "num_vertices")


@functools.lru_cache(maxsize=None)
def _case(kind):
    """(jm, tm, costs, ew, W, jplan, tplan): both meshes, seeded costs, the
    reference's edge and slot weights and both banded plans."""
    if kind == "terrain24":
        v, f = synthetic.terrain_mesh(24, 24, spacing=0.5, hills=1.5, roughness=0.03, seed=5)
        jm, tm = reference_build_mesh(v, f), build_mesh(v, f, device="cpu")
    else:
        v, f = synthetic.irregular_terrain_mesh(20, 20, spacing=0.5, jitter=0.45, hills=1.0,
                                                roughness=0.01, seed=3)
        jm = reference_build_mesh(v, f, reorder=True)
        tm = treorder.build_reordered_mesh(v, f, device="cpu")
    c = CASES[kind]
    costs = np.random.default_rng(c["seed_costs"]).uniform(0.0, 0.5, tm.num_vertices)
    costs = costs.astype(np.float32)
    ew = np.asarray(jsweeps.compute_edge_weights(jm, costs, 1.0))
    W = np.asarray(jsweeps.slot_weights(jm, ew, costs, c["limit"]))
    return (jm, tm, costs, ew, W, jpb.build_banded_kernel_plan(jm, W),
            tbg.build_banded_kernel_plan(tm, W))


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("kind", list(CASES))
def test_sharded_plan_matches_reference(kind, n):
    """Every table the port keeps equals the reference's: planes on the
    owned and ghost rows (the reference's shards run on to a multiple of
    its row block), the near residual lists and the far-source table."""
    *_, jplan, tplan = _case(kind)
    js = jsb.build_sharded_banded_plan(jplan, n, interpret=True)
    ts = build_sharded_banded_plan(tplan, n)
    for k in META_KEYS:
        assert getattr(ts, k) == getattr(js, k), k
    assert ts.xlanes_down == tuple(js.xlanes_down) and ts.xlanes_up == tuple(js.xlanes_up)
    RpL = ts.rp_local
    assert RpL == ts.rows_per_shard + 2 * ts.ghost <= js.rp_local
    for k in PLANE_KEYS:
        want = np.asarray(getattr(js, k))
        np.testing.assert_array_equal(getattr(ts, k).numpy(), want[:, :RpL], k)
    for k in TABLE_KEYS:
        np.testing.assert_array_equal(getattr(ts, k).numpy(), np.asarray(getattr(js, k)), k)
    if kind == "irregular20":
        # near entries a shard, a ghost width of the residual cap, and far
        # entries at every shard count
        assert tplan.n_residual > 0 and ts.ghost == 4 and ts.n_far > 0
        assert ts.n_residual == (96 if n == 2 else 56)
    else:
        assert tplan.n_residual == 0 and ts.ghost == 1 and ts.n_far == 0


def test_sharded_plan_drops_the_two_level_tables():
    """A departure: the port's shards keep no l2_fwd / l2_bwd / wback (the
    TPU kernel's two-level scan tables, which the port's pass never reads)
    and no row-block padding, where the reference's keep both."""
    *_, jplan, tplan = _case("terrain24")
    js = jsb.build_sharded_banded_plan(jplan, 4, interpret=True)
    ts = build_sharded_banded_plan(tplan, 4)
    assert {"l2_fwd", "l2_bwd", "wback", "rb", "bb"} <= set(js._fields)
    assert not {"l2_fwd", "l2_bwd", "wback", "rb", "bb"} & set(ts._fields)
    assert js.rp_local % js.rb == 0 and ts.rp_local == 6 + 2 * 1


@functools.lru_cache(maxsize=None)
def _sharded(kind, n):
    *_, tplan = _case(kind)
    return ranks.run("banded_solve", n, {"splan": build_sharded_banded_plan(tplan, n),
                                         "seeds": np.asarray(CASES[kind]["seeds"])})


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("kind", list(CASES))
def test_sharded_solve_matches_single_and_oracle(kind, n):
    """n gloo ranks on the plain pass: converged, the single-device solve's
    reachability and fields (rtol 1e-6), and lane 1 against the heap oracle
    (rtol 1e-5). The rounds are not held: block-Jacobi across the cuts adds
    a round for each cut a wavefront crosses."""
    jm, tm, costs, ew, W, _, tplan = _case(kind)
    seeds = CASES[kind]["seeds"]
    d_sh, rounds, converged, launches = _sharded(kind, n)
    assert converged and launches == [0] * n     # the plain pass: no kernel on the CPU
    single = tbg.banded_solve_padded(tplan, torch.tensor(seeds), atol=0.0, rtol=0.0)
    R, C, V = tplan.n_rows, tplan.n_cols, tplan.num_vertices
    d_si = single.d_pad[:R, :C, :len(seeds)].reshape(-1, len(seeds))[:V].numpy()
    d_sh = d_sh.numpy()
    fin = np.isfinite(d_si)
    assert np.array_equal(np.isfinite(d_sh), fin)
    np.testing.assert_allclose(d_sh[fin], d_si[fin], rtol=1e-6, atol=1e-6)
    od, _ = oracle.dijkstra_oracle(V, oracle.mesh_adjacency(tm), ew, costs, seeds[1],
                                   CASES[kind]["limit"])
    ofin = np.isfinite(od)
    np.testing.assert_allclose(d_sh[:, 1][ofin], od[ofin], rtol=1e-5, atol=1e-5)
