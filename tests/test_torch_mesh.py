"""Port vs reference: mesh tables, slot weights, band width, snap and the
banded plan structure (mesh_navigation_torch against mesh_navigation_tpu on
the same numpy inputs). Integer tables must match exactly; float tables
within rtol 1e-6 (both sides compute them in float32 numpy or float32
tensors from identical inputs, so any difference is summation order)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mesh_navigation_tpu.mesh import build_mesh as jax_build_mesh
from mesh_navigation_tpu.mesh import query as jquery
from mesh_navigation_tpu.mesh import synthetic
from mesh_navigation_tpu.ops import banded as jbanded
from mesh_navigation_tpu.ops import pallas_banded as jpb
from mesh_navigation_tpu.ops import sweeps as jsweeps

from mesh_navigation_torch.mesh import query as tquery
from mesh_navigation_torch.mesh.arrays import FIELDS, build_mesh
from mesh_navigation_torch.ops import banded as tbanded
from mesh_navigation_torch.ops import banded_gpu as tbg
from mesh_navigation_torch.ops import sweeps as tsweeps
from mesh_navigation_torch import convert

torch.set_num_threads(2)

FLOAT_FIELDS = {"vertices", "edge_dist", "face_normals", "vertex_normals"}


def _meshes(kind):
    if kind == "terrain16":
        v, f = synthetic.terrain_mesh(16, 16, spacing=0.5, hills=1.5, roughness=0.02, seed=3)
    elif kind == "wide64":
        v, f = synthetic.terrain_mesh(6, 64, spacing=0.5, hills=1.0, roughness=0.01, seed=1)
    else:   # irregular Delaunay terrain: residual edges and extended lanes
        v, f = synthetic.irregular_terrain_mesh(32, 32, spacing=0.5, hills=1.0, seed=4)
    return jax_build_mesh(v, f), build_mesh(v, f, device="cpu")


@pytest.mark.parametrize("kind", ["terrain16", "irregular32"])
def test_build_mesh_tables_match(kind):
    jm, tm = _meshes(kind)
    for name in FIELDS:
        a = np.asarray(getattr(jm, name))
        b = getattr(tm, name).numpy()
        assert a.shape == b.shape, name
        if name in FLOAT_FIELDS:
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=0, err_msg=name)
        else:
            np.testing.assert_array_equal(b, a, err_msg=name)


@pytest.mark.parametrize("kind", ["terrain16", "irregular32"])
def test_slot_weights_and_band_width_match(kind):
    jm, tm = _meshes(kind)
    rng = np.random.default_rng(2)
    costs = rng.uniform(0.0, 1.2, jm.num_vertices).astype(np.float32)
    costs[5:9] = np.inf
    wj = jsweeps.slot_weights_np(jm, costs, cost_limit=1.0, edge_cost_factor=1.0)
    wt = tsweeps.slot_weights_np(tm, costs, cost_limit=1.0, edge_cost_factor=1.0)
    np.testing.assert_array_equal(wt, wj)
    assert tbanded.infer_band_width(tm) == jbanded.infer_band_width(jm)
    ej = np.asarray(jsweeps.compute_edge_weights(jm, jnp.asarray(costs), 1.0))
    et = tsweeps.compute_edge_weights(tm, torch.from_numpy(costs), 1.0).numpy()
    np.testing.assert_allclose(et, ej, rtol=1e-6, atol=0)


@pytest.mark.parametrize("dense", [True, False])
def test_nearest_vertex_batch_ids_match(dense):
    jm, tm = _meshes("terrain16")
    gj = jquery.build_grid(jm)
    gt = tquery.build_grid(tm)
    assert gt.max_per_cell == gj.max_per_cell and gt.flat_z == gj.flat_z
    if not dense:
        gj = dataclasses.replace(gj, cell_pos=None, cell_vid=None)
        gt = dataclasses.replace(gt, cell_pos=None, cell_vid=None)
    rng = np.random.default_rng(5)
    pts = rng.uniform(-0.5, 8.0, (64, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(-1.0, 2.0, 64)
    vj, dj = jquery.nearest_vertex_batch(jm, gj, jnp.asarray(pts))
    vt, dt = tquery.nearest_vertex_batch(tm, gt, torch.from_numpy(pts))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-6)


def _plan_numpy(plan):
    arrays = {k: (None if getattr(plan, k) is None else np.asarray(getattr(plan, k)))
              for k in tbg.PLAN_ARRAYS}
    meta = {k: getattr(plan, k) for k in tbg.PLAN_META}
    return arrays, meta


@pytest.mark.parametrize("kind,n_cols", [("terrain16", 0), ("wide64", 0), ("irregular32", 32)])
def test_banded_plan_matches(kind, n_cols):
    jm, tm = _meshes(kind)
    rng = np.random.default_rng(3)
    costs = rng.uniform(0.0, 0.9, jm.num_vertices).astype(np.float32)
    W = jsweeps.slot_weights_np(jm, costs, cost_limit=1.0, edge_cost_factor=1.0)
    pj = jpb.build_banded_kernel_plan(jm, W, n_cols=n_cols)
    pt = tbg.build_banded_kernel_plan(tm, W, n_cols=n_cols)
    arrays, meta = _plan_numpy(pj)
    for k in tbg.PLAN_META:
        assert getattr(pt, k) == (tuple(meta[k]) if k.startswith("xlanes") else meta[k]), k
    if kind == "wide64":
        assert pt.n_scan2 > 0           # two-level tables exist
    if kind == "irregular32":
        assert pt.n_residual > 0 and pt.xlanes_down
    for k in tbg.PLAN_ARRAYS:
        a, b = arrays[k], getattr(pt, k)
        if a is None:
            assert b is None, k
            continue
        b = b.numpy()
        assert a.shape == b.shape, k
        if np.issubdtype(a.dtype, np.floating):
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(b, a, err_msg=k)
    # the carried plan is the same plan
    pc = convert.plan_from_numpy(arrays, meta, device="cpu")
    for k in ("slot_map", "a_fwd", "down", "res_jump"):
        np.testing.assert_array_equal(getattr(pc, k).numpy(), arrays[k])
    mc = convert.mesh_from_numpy({k: np.asarray(getattr(jm, k)) for k in FIELDS}, device="cpu")
    np.testing.assert_array_equal(mc.adj_vertex.numpy(), np.asarray(jm.adj_vertex))
