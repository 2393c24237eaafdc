"""The port's gather tiers on torch.distributed (mesh_navigation_torch/parallel:
distributed, sharded, partition, dryrun) against the reference's.

The host tables (shard_weights, build_partition) are held bit for bit
against the reference's on the conftest fixtures' meshes, carried across
whole (convert.mesh_from_numpy). The solves run in gloo ranks on the CPU,
spawned from tests/torch_parallel_ranks.py, against the reference's
sharded_field_solve and partitioned_field_solve on its 8-virtual-device
mesh: both take the same min over the same float sums, so they agree to
rtol 1e-6, reachability equal.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mesh_navigation_tpu.mesh import build_mesh as jbuild_mesh
from mesh_navigation_tpu.mesh import synthetic
from mesh_navigation_tpu.ops import sweeps as jsweeps
from mesh_navigation_tpu.parallel import make_device_mesh as jmake_device_mesh
from mesh_navigation_tpu.parallel import partition as jpartition
from mesh_navigation_tpu.parallel import shard_weights as jshard_weights
from mesh_navigation_tpu.parallel import sharded_field_solve as jsharded_field_solve

from mesh_navigation_torch.convert import mesh_from_numpy
from mesh_navigation_torch.mesh.arrays import FIELDS
from mesh_navigation_torch.parallel import build_partition, distributed, shard_weights

import torch_parallel_ranks as ranks

torch.set_num_threads(2)

SEEDS = {"grid8": [0, 7, 56, 63], "terrain32": [3, 500, 900, 77], "folded8": [0, 9, 60, 35]}
PART_KEYS = ("adj", "weights", "export_idx", "exp_right", "exp_left", "perm", "inv_perm")


def _folded_grid8():
    """The 8 x 8 grid with its last four columns mirrored in x: the column
    x = 3 meets x = 4, which now sorts last, so a cut into four x-blocks is
    not neighbour-only (the all_gather route)."""
    v, f = synthetic.grid_mesh(8, 8)
    x = v[:, 0]
    v = v.copy()
    v[:, 0] = np.where(x >= 4, 11 - x, x)
    return jbuild_mesh(v, f)


@pytest.fixture(scope="module")
def meshes(grid_mesh_small, terrain_mesh_medium):
    return {"grid8": grid_mesh_small, "terrain32": terrain_mesh_medium,
            "folded8": _folded_grid8()}


_CACHE: dict = {}


def _problem(kind, jm):
    """(port mesh, slot weights W): the reference's mesh carried across and
    its slot weights of seeded costs (edge cost factor 1, cost limit 1)."""
    if kind not in _CACHE:
        tm = mesh_from_numpy({k: np.asarray(getattr(jm, k)) for k in FIELDS}, device="cpu")
        rng = np.random.default_rng(5)
        costs = jnp.asarray(rng.uniform(0, 0.6, jm.num_vertices).astype(np.float32))
        ew = jsweeps.compute_edge_weights(jm, costs, 1.0)
        _CACHE[kind] = tm, np.asarray(jsweeps.slot_weights(jm, ew, costs, 1.0))
    return _CACHE[kind]


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("kind", ["grid8", "terrain32", "folded8"])
def test_host_tables_match_reference(meshes, kind, n):
    """shard_weights and build_partition: every table bit for bit the
    reference's, neighbor_only included (the folded grid's four-way cut is
    the one that is not neighbour-only)."""
    jm = meshes[kind]
    tm, W = _problem(kind, jm)
    js, ts = jshard_weights(jm, jnp.asarray(W), n), shard_weights(tm, W, n)
    np.testing.assert_array_equal(ts.adj_vertex.numpy(), np.asarray(js.adj_vertex))
    np.testing.assert_array_equal(ts.weights.numpy(), np.asarray(js.weights))
    assert ts.num_vertices == js.num_vertices
    jp, tp = jpartition.build_partition(jm, jnp.asarray(W), n), build_partition(tm, W, n)
    for k in PART_KEYS:
        np.testing.assert_array_equal(getattr(tp, k).numpy(), np.asarray(getattr(jp, k)), k)
    assert (tp.num_vertices, tp.block, tp.neighbor_only) == (jp.num_vertices, jp.block,
                                                             jp.neighbor_only)
    assert tp.neighbor_only == (kind != "folded8" or n == 2)


def _solves(shape, meshes):
    """The port's gather solves in n_mesh x n_batch gloo ranks, one spawn a
    grid: sharded_field_solve on the 32 x 32 terrain, partitioned_field_solve
    on the 8 x 8 grid, or on the folded grid for the (4, 1) all_gather
    route (keyed "folded")."""
    key = shape
    if key not in _CACHE:
        n_mesh = shape[0] if shape != "folded" else 4
        grid = (n_mesh, 1) if shape == "folded" else shape
        part_kind = "folded8" if shape == "folded" else "grid8"
        tm, W = _problem(part_kind, meshes[part_kind])
        payload = {"shape": grid, "max_sweeps": 1024, "part": build_partition(tm, W, n_mesh),
                   "part_seeds": np.asarray(SEEDS[part_kind])}
        if shape != "folded":
            tm, W = _problem("terrain32", meshes["terrain32"])
            payload.update(sharded=shard_weights(tm, W, n_mesh),
                           sharded_seeds=np.asarray(SEEDS["terrain32"]))
        _CACHE[key] = ranks.run("gather_solves", grid[0] * grid[1], payload)
    return _CACHE[key]


@pytest.mark.parametrize("shape", [(2, 2), (4, 1)])
def test_sharded_field_solve_matches_reference(meshes, shape):
    jm = meshes["terrain32"]
    _, W = _problem("terrain32", jm)
    seeds = jnp.asarray(SEEDS["terrain32"], jnp.int32)
    want = np.asarray(jsharded_field_solve(jshard_weights(jm, jnp.asarray(W), shape[0]), seeds,
                                           jmake_device_mesh(*shape), max_sweeps=1024))
    got = _solves(shape, meshes)["sharded"].numpy()
    assert got.shape == want.shape
    assert np.array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6)


@pytest.mark.parametrize("shape", [(2, 2), (4, 1), "folded"])
def test_partitioned_field_solve_matches_reference(meshes, shape):
    """The ring route (the 8 x 8 grid) and the all_gather route (the folded
    grid on four shards)."""
    kind = "folded8" if shape == "folded" else "grid8"
    grid = (4, 1) if shape == "folded" else shape
    jm = meshes[kind]
    _, W = _problem(kind, jm)
    part = jpartition.build_partition(jm, jnp.asarray(W), grid[0])
    assert part.neighbor_only == (kind == "grid8")
    want = np.asarray(jpartition.partitioned_field_solve(
        part, jnp.asarray(SEEDS[kind], jnp.int32), jmake_device_mesh(*grid), max_sweeps=1024))
    got = _solves(shape, meshes)["partitioned"].numpy()
    assert got.shape == want.shape == (4, jm.num_vertices)
    assert np.array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    assert fin.mean() > 0.5
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6)


def test_pod_mesh_lays_out_shards_on_consecutive_ranks(meshes):
    """A (2, 2) grid: rank = batch * n_mesh + mesh, so consecutive ranks
    hold consecutive shards (the reference's device order is mesh-major;
    a departure that moves no result)."""
    coords = _solves((2, 2), meshes)["coords"]
    assert [c[:5] for c in coords] == [
        (0, 0, 0, (0, 1), (0, 2)), (1, 1, 0, (0, 1), (1, 3)),
        (2, 0, 1, (2, 3), (0, 2)), (3, 1, 1, (2, 3), (1, 3)),
    ]
    assert all(c[5] == {"mesh": 2, "batch": 2} for c in coords)


def test_initialize_is_a_no_op_with_one_process(monkeypatch):
    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.initialize() is False
    assert not torch.distributed.is_initialized()
    assert distributed.is_primary()
    grid = distributed.pod_mesh()
    assert grid.shape == {"mesh": 1, "batch": 1}
    assert (grid.rank, grid.mesh_index, grid.batch_index) == (0, 0, 0)
    with pytest.raises(ValueError, match="not divisible"):
        distributed.pod_mesh(2)


def test_nccl_with_more_ranks_than_cards_raises(tmp_path, monkeypatch):
    """NCCL never falls back to gloo: more ranks on a host than cards is an
    error before any rendezvous."""
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="a card for each rank"):
        distributed.initialize("nccl", init_method=f"file://{tmp_path}/store", world_size=2,
                               rank=0)
    assert not torch.distributed.is_initialized()


def test_dryrun_multichip_on_cpu():
    """The multi-device dry run on four gloo ranks at mesh_n = 24: every
    solve within 1e-3 of the native heap Dijkstra."""
    out = ranks.run("dryrun", 4, {"mesh_n": 24})
    assert out["grid"] == [2, 2] and out["lanes"] == 4 and out["halo"] == "ring"
    assert max(out["partition_err"], out["banded_err"], out["irregular_err"]) < 1e-3
    assert out["irregular_residual"] > 0 and out["irregular_n_far"] > 0
    assert out["irregular_ghost"] == 4


def test_ranks_helper_imports_no_jax():
    """The spawned ranks' module imports torch and the port only."""
    src = open(os.path.join(os.path.dirname(__file__), "torch_parallel_ranks.py")).read()
    assert "jax" not in src and "mesh_navigation_tpu" not in src
