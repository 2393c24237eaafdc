"""Port vs reference: the cost layers of the live-replan cascade.

Both sides get the same numpy mesh and inputs, made from a seed. Integer and
boolean tables must be identical: the face-grid bins, the obstacle layer's
lethal mask, the layer order. Float layers (steepness, max and average
combination, the combined costs of a stack) agree within 1e-6: both compute
them in float32 from identical inputs. The banded Sethian inflation wave is
held at 1e-4 in the full-plane solve and in each branch of the windowed one
(a window that fits, one whose border certificate fails, one that does not
fit)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mesh_navigation_tpu.config import LayerConfig as JLayerConfig
from mesh_navigation_tpu.layers import LayerStack as JLayerStack
from mesh_navigation_tpu.layers import obstacle as jobstacle
from mesh_navigation_tpu.layers.base import LAYER_REGISTRY as J_REGISTRY
from test_torch_reference import reference_build_mesh as jax_build_mesh
from mesh_navigation_tpu.mesh import synthetic
from mesh_navigation_tpu.ops import banded_sethian as jbs
from mesh_navigation_tpu.ops import raycast as jraycast

from mesh_navigation_torch.config import LayerConfig
from mesh_navigation_torch.layers import LAYER_REGISTRY, LayerStack
from mesh_navigation_torch.layers import inflation as tinflation
from mesh_navigation_torch.layers import obstacle as tobstacle
from mesh_navigation_torch.mesh.arrays import build_mesh
from mesh_navigation_torch.ops import banded_sethian as tbs
from mesh_navigation_torch.ops import raycast as traycast

torch.set_num_threads(2)

N = 32


def _meshes(kind="terrain32"):
    if kind == "terrain32":
        v, f = synthetic.terrain_mesh(N, N, spacing=0.5, hills=1.5, roughness=0.02, seed=5)
    else:
        v, f = synthetic.irregular_terrain_mesh(16, 16, spacing=0.5, hills=1.0, seed=4)
    return v, f, jax_build_mesh(v, f), build_mesh(v, f, device="cpu")


def _clouds(v, n_pts, seed):
    """Points hovering over random vertices, jittered off the vertex so no
    ray grazes an edge; a few rows NaN."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, len(v), n_pts)
    pts = v[ids] + np.stack([rng.uniform(-0.2, 0.2, n_pts), rng.uniform(-0.2, 0.2, n_pts),
                             rng.uniform(0.05, 1.6, n_pts)], axis=1)
    pts[rng.integers(0, n_pts, 3)] = np.nan
    return pts.astype(np.float32)


def _layers(LC):
    return (
        LC(name="steep", kind="steepness", params=(("threshold", 0.4),)),
        LC(name="obst", kind="obstacle"),
        LC(name="infl", kind="inflation", inputs=("obst",),
           params=(("repulsive_field", 0.0), ("inflation_radius", 0.9))),
        LC(name="combine", kind="max_combination", inputs=("steep", "obst", "infl")),
        LC(name="avg", kind="avg_combination", inputs=("steep", "infl"), factor=0.5),
    )


@pytest.mark.parametrize("kind,cell_size", [("terrain32", None), ("terrain32", 0.37),
                                            ("irregular", None)])
def test_face_grid_tables_identical(kind, cell_size):
    _, _, jm, tm = _meshes(kind)
    jg = jraycast.build_face_grid(jm, cell_size)
    tg = traycast.build_face_grid(tm, cell_size)
    np.testing.assert_array_equal(tg.dims.numpy(), np.asarray(jg.dims))
    assert tg.cell_faces.shape == jg.cell_faces.shape            # the same K
    np.testing.assert_array_equal(tg.cell_faces.numpy(), np.asarray(jg.cell_faces))
    np.testing.assert_array_equal(tg.cell_mask.numpy(), np.asarray(jg.cell_mask))
    np.testing.assert_array_equal(tg.origin.numpy(), np.asarray(jg.origin))
    assert float(tg.cell_size) == float(jg.cell_size)


@pytest.mark.parametrize("seed,ranged", [(0, False), (1, True), (2, False)])
def test_process_point_cloud_lethal_identical(seed, ranged):
    v, _, jm, tm = _meshes()
    pts = _clouds(v, 256, seed)
    params = jobstacle.ObstacleParams(robot_height=1.0, min_range=1.0, max_range=6.0)
    origin = np.asarray([8.0, 8.0, 1.0], np.float32) if ranged else None
    jl = jobstacle.process_point_cloud(
        jm, jnp.asarray(pts), params, face_grid=jraycast.build_face_grid(jm),
        sensor_origin=None if origin is None else jnp.asarray(origin))
    tl = tobstacle.process_point_cloud(
        tm, torch.from_numpy(pts), tobstacle.ObstacleParams(*params),
        face_grid=traycast.build_face_grid(tm),
        sensor_origin=None if origin is None else torch.from_numpy(origin))
    assert 0 < int(tl.sum()) < len(v)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tobstacle.lethal_diff(tl, ~tl).numpy(), np.ones(len(v), bool))
    # without a face grid the cast is the brute force, with the same hits
    brute = tobstacle.process_point_cloud(
        tm, torch.from_numpy(pts), tobstacle.ObstacleParams(*params),
        sensor_origin=None if origin is None else torch.from_numpy(origin))
    np.testing.assert_array_equal(brute.numpy(), np.asarray(jl))


def _stacks(points=None, window=None):
    _, _, jm, tm = _meshes()
    js = JLayerStack.from_configs(_layers(JLayerConfig), "combine")
    ts = LayerStack.from_configs(_layers(LayerConfig), "combine")
    jst, tst = js.prepare(jm), ts.prepare(tm)
    if points is not None:
        jst["obstacle:obst:points"] = jnp.asarray(points)
        tst["obstacle:obst:points"] = torch.from_numpy(points)
    if window is not None:
        jst["__inflation_window__"] = window
        tst["__inflation_window__"] = window
    return js, ts, js.compute(jm, jst), ts.compute(tm, tst)


@pytest.mark.parametrize("with_points", [False, True])
def test_layer_stack_matches_reference(with_points):
    v = _meshes()[0]
    pts = _clouds(v, 64, 7) if with_points else None
    js, ts, (jout, jcomb), (tout, tcomb) = _stacks(pts)
    assert ts.order == js.order and ts.default_layer == js.default_layer
    assert set(J_REGISTRY) >= set(LAYER_REGISTRY)
    for name in js.order:
        np.testing.assert_array_equal(tout[name].lethal.numpy(), np.asarray(jout[name].lethal), name)
        ref = np.asarray(jout[name].costs)
        got = tout[name].costs.numpy()
        np.testing.assert_array_equal(np.isinf(got), np.isinf(ref), name)
        fin = np.isfinite(ref)
        np.testing.assert_allclose(got[fin], ref[fin], rtol=0, atol=1e-6, err_msg=name)
        assert not np.isnan(got).any()
    np.testing.assert_allclose(np.nan_to_num(tcomb.numpy(), posinf=9.0),
                               np.nan_to_num(np.asarray(jcomb), posinf=9.0), rtol=0, atol=1e-6)
    if with_points:
        assert np.isinf(tcomb.numpy()).any()
        infl = tout["infl"].costs.numpy()
        assert ((infl > 0) & (infl < 1.0)).any()          # the fading band


def test_layer_stack_refuses_bad_graphs():
    with pytest.raises(ValueError, match="cycle"):
        LayerStack.from_configs((LayerConfig("a", "max_combination", ("b",)),
                                 LayerConfig("b", "max_combination", ("a",))))
    with pytest.raises(ValueError, match="unknown layer kind"):
        LayerStack.from_configs((LayerConfig("a", "slope_magic"),))
    with pytest.raises(ValueError, match="unknown layer"):
        LayerStack.from_configs((LayerConfig("a", "max_combination", ("zz",)),))
    # every kind of the reference is registered, and an inflation layer with
    # its defaults (the repulsive field on) builds
    assert set(LAYER_REGISTRY) == set(J_REGISTRY)
    assert LayerStack.from_configs((LayerConfig("i", "inflation"),)).order == ("i",)


def _seed_dist(V, kind):
    seed = np.full(V, np.inf, np.float32)
    if kind == "two_patches":
        rows = [3, 4, 27, 28]
    else:
        rows = [15, 16, 17]
    for r in rows:
        seed[r * N + np.arange(14, 18)] = 0.0
    return seed


@pytest.mark.parametrize("case,window,cap", [
    ("full", None, 0.9),
    ("fits", (24, 32), 0.9),            # accepted: the wave stays inside
    ("border_fails", (24, 32), np.inf),  # the wave reaches the border: full solve
    ("no_fit", (24, 32), 0.9),          # the seeds' box is wider than the window
])
def test_sethian_banded_matches_reference(case, window, cap):
    _, _, jm, tm = _meshes()
    jplan, tplan = jbs.build_sethian_plan(jm), tbs.build_sethian_plan(tm)
    assert tplan.patterns == jplan.patterns and tplan.n_residual == jplan.n_residual
    for name in ("pat_a", "pat_b", "pat_c", "res_a", "invalid_plane"):
        np.testing.assert_array_equal(getattr(tplan, name).numpy(), np.asarray(getattr(jplan, name)))
    seed = _seed_dist(jm.num_vertices, "two_patches" if case == "no_fit" else "patch")
    ref = np.asarray(jbs.sethian_distances_banded(jplan, jnp.asarray(seed), source_cap=cap,
                                                  window=window))
    got = tbs.sethian_distances_banded(tplan, torch.from_numpy(seed), source_cap=cap,
                                       window=window).numpy()
    full = tbs.sethian_distances_banded(tplan, torch.from_numpy(seed), source_cap=cap).numpy()
    for a in (got, full):
        assert not np.isnan(a).any()
        np.testing.assert_array_equal(np.isfinite(a), np.isfinite(ref))
        fin = np.isfinite(ref)
        np.testing.assert_allclose(a[fin], ref[fin], rtol=0, atol=1e-4)
    fin_rc = np.isfinite(got).reshape(N, N)
    rows, cols = np.nonzero(fin_rc)
    if case == "fits":
        assert rows.max() - rows.min() + 1 <= window[0] and cols.max() - cols.min() + 1 <= window[1]
        assert np.isfinite(got).sum() > (seed == 0).sum()
    elif case == "border_fails":
        assert fin_rc.all()          # finite beyond the window: the fallback ran
    elif case == "no_fit":
        assert rows.max() - rows.min() + 1 > window[0]


def test_inflation_fading_matches_reference():
    from mesh_navigation_tpu.layers import inflation as jinflation

    d = np.asarray([0.0, 1e-3, 0.1, 0.25, 0.2500001, 0.3, 0.39, 0.4, 0.41, 5.0, np.inf],
                   np.float32)
    p = jinflation.InflationParams(repulsive_field=False)
    np.testing.assert_allclose(
        tinflation.fading(torch.from_numpy(d), tinflation.InflationParams(*p)).numpy(),
        np.asarray(jinflation.fading(jnp.asarray(d), p)), rtol=0, atol=1e-7)
