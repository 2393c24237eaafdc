"""Port vs reference: the layered costmap's parts (the five local layers,
the radius neighbourhoods, the general raycasts and the 3-D face grid, the
obstacle layer's other casts, the inflation layer's gather route, also in
a stack, and the repulsive field). tests/test_torch_costmap_server.py
holds the README's example stack and chip_smoke.py's full stack, the
server on them and the replan step.

Both sides get the same numpy meshes (a 32 x 32 terrain and the 16 x 16
irregular mesh of tests/test_torch_layers.py, reference meshes from
reference_build_mesh) and inputs made from a seed. Tolerances:
- integer and boolean tables identical: the radius neighbourhoods, the 3-D
  grid's CSR tables, every lethal mask, ray hits and face ids;
- layer costs within 1e-6, 1e-5 where arccos enters (roughness): both
  sides evaluate the same float32 expressions and differ only where XLA
  reorders or contracts them;
- ray distances t within 1e-5;
- repulsive vectors within 1e-5 with an identical non-zero support, on the
  same distance field (the winning face is the first incident slot of the
  lowest score on both sides).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mesh_navigation_tpu import config as jconfig
from mesh_navigation_tpu.layers import LayerStack as JLayerStack
from mesh_navigation_tpu.layers import inflation as jinflation
from mesh_navigation_tpu.layers import local as jlocal
from mesh_navigation_tpu.layers import obstacle as jobstacle
from mesh_navigation_tpu.layers.base import LAYER_REGISTRY as J_REGISTRY
from mesh_navigation_tpu.mesh import synthetic
from mesh_navigation_tpu.ops import banded_sethian as jbs
from mesh_navigation_tpu.ops import raycast as jraycast

from mesh_navigation_torch import config as tconfig
from mesh_navigation_torch.layers import LAYER_REGISTRY, LayerStack
from mesh_navigation_torch.layers import inflation as tinflation
from mesh_navigation_torch.layers import local as tlocal
from mesh_navigation_torch.layers import obstacle as tobstacle
from mesh_navigation_torch.mesh.arrays import build_mesh
from mesh_navigation_torch.ops import banded_sethian as tbs
from mesh_navigation_torch.ops import raycast as traycast

from test_torch_reference import reference_build_mesh

torch.set_num_threads(2)

N = 32
MESHES = ["terrain32", "irregular16"]
N_SERVER = 20        # the field tests', stacks' and servers' map: one set of shapes
_CACHE: dict = {}


def _server_mesh():
    return synthetic.terrain_mesh(N_SERVER, N_SERVER, spacing=0.5, hills=1.5, roughness=0.02,
                                  seed=4)


def _meshes(kind):
    if kind not in _CACHE:
        if kind == "terrain32":
            v, f = synthetic.terrain_mesh(N, N, spacing=0.5, hills=1.5, roughness=0.02, seed=5)
        elif kind == "irregular16":
            v, f = synthetic.irregular_terrain_mesh(16, 16, spacing=0.5, hills=1.0, seed=4)
        elif kind == "server":
            v, f = _server_mesh()
        elif kind == "flat":
            v, f = synthetic.terrain_mesh(N_SERVER, N_SERVER, spacing=0.5, hills=0.0,
                                          roughness=0.0, seed=5)
        else:   # rays: the terrain of tests/test_raycast_grid.py
            v, f = synthetic.terrain_mesh(18, 18, spacing=0.5, hills=2.0, roughness=0.05, seed=5)
        _CACHE[kind] = (v, f, reference_build_mesh(v, f), build_mesh(v, f, device="cpu"))
    return _CACHE[kind]


def _assert_costs(got, ref, atol, name=""):
    got, ref = np.asarray(got), np.asarray(ref)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(ref), name)
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=0, atol=atol, err_msg=name)
    assert not np.isnan(got).any(), name


def _run_layer(kind, params, jm, tm):
    jfn = J_REGISTRY[kind](jconfig.LayerConfig(name="x", kind=kind, params=params))
    tfn = LAYER_REGISTRY[kind](tconfig.LayerConfig(name="x", kind=kind, params=params))
    jst = jfn.prepare(jm) if hasattr(jfn, "prepare") else {}
    tst = tfn.prepare(tm) if hasattr(tfn, "prepare") else {}
    return jfn(jm, {}, jst), tfn(tm, {}, tst), tst


def test_registry_holds_the_reference_kinds():
    assert set(LAYER_REGISTRY) == set(J_REGISTRY)
    assert len(LAYER_REGISTRY) == 10


@pytest.mark.parametrize("kind", MESHES)
@pytest.mark.parametrize("radius", [0.3, 0.75, 1.5])
def test_radius_neighborhood_identical(kind, radius):
    _, _, jm, tm = _meshes(kind)
    jn, jmask = jlocal.radius_neighborhood(jm, radius)
    tn, tmask = tlocal.radius_neighborhood(tm, radius)
    assert tn.shape == jn.shape and tn.dtype == np.int32 and tmask.dtype == bool
    np.testing.assert_array_equal(tn, jn)
    np.testing.assert_array_equal(tmask, jmask)
    if radius == 0.3 and kind == "terrain32":
        assert tn.shape[1] == 1 and not tmask.any()      # no neighbour on a 0.5 m grid


LOCAL_CASES = [
    ("height_diff", (("radius", 1.0),), 1e-6),
    ("height_diff", (("radius", 1.5), ("threshold", 0.5)), 1e-6),
    ("roughness", (("radius", 1.0), ("threshold", 0.05)), 1e-5),
    ("ridge", (("radius", 1.0), ("threshold", 0.6)), 1e-6),
    ("ridge", (), 1e-6),                        # the default radius: no-neighbour rows
    ("border", (), 1e-6),
    ("clearance", (), 1e-6),
]


@pytest.mark.parametrize("kind", MESHES)
@pytest.mark.parametrize("layer,params,atol", LOCAL_CASES)
def test_local_layer_matches_reference(kind, layer, params, atol):
    _, _, jm, tm = _meshes(kind)
    jo, to, tst = _run_layer(layer, params, jm, tm)
    np.testing.assert_array_equal(to.lethal.numpy(), np.asarray(jo.lethal))
    _assert_costs(to.costs.numpy(), jo.costs, atol, layer)
    assert to.costs.dtype == torch.float32 and not to.vectors.any()
    if layer in ("height_diff", "roughness", "ridge"):
        radius = dict(params).get("radius", 0.3)
        assert f"neigh:{radius}" in tst
    if layer == "ridge" and not params and kind == "terrain32":
        assert to.lethal.all()                      # threshold + 0.1 everywhere
    if layer == "clearance":
        assert isinstance(tst["clearance:grid3d"], traycast.FaceGrid3D)


def _two_planes():
    """tests/test_layers.py:101-120: a plane under a ceiling 0.6 above it,
    the ceiling's faces flipped so its normal points down."""
    v1, f1 = synthetic.grid_mesh(6, 6)
    v2 = v1 + np.asarray([0, 0, 0.6], np.float32)
    f2 = f1[:, ::-1] + len(v1)
    return np.concatenate([v1, v2]), np.concatenate([f1, f2]), len(v1)


@pytest.mark.parametrize("route", ["grid", "bruteforce"])
def test_clearance_under_a_ceiling(route):
    v, f, nlow = _two_planes()
    jm, tm = reference_build_mesh(v, f), build_mesh(v, f, device="cpu")
    params = (("robot_height", 0.5), ("height_inflation", 0.3))
    jfn = J_REGISTRY["clearance"](jconfig.LayerConfig(name="cl", kind="clearance", params=params))
    tfn = LAYER_REGISTRY["clearance"](tconfig.LayerConfig(name="cl", kind="clearance",
                                                          params=params))
    jst, tst = (jfn.prepare(jm), tfn.prepare(tm)) if route == "grid" else ({}, {})
    jo, to = jfn(jm, {}, jst), tfn(tm, {}, tst)
    np.testing.assert_array_equal(to.lethal.numpy(), np.asarray(jo.lethal))
    _assert_costs(to.costs.numpy(), jo.costs, 1e-6)
    lower = to.costs.numpy()[:nlow].reshape(6, 6)[1:-1, 1:-1]
    assert ((lower > 0.05) & (lower < 1.0)).all()       # the 0.6 gap fades
    # both routes give the same clearance
    g = traycast.build_face_grid3d(tm)
    torch.testing.assert_close(traycast.vertex_clearance_grid(tm, g, 0.9),
                               traycast.vertex_clearance(tm, 0.9, face_chunk=64),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("kind,cell_size", [("terrain32", None), ("terrain32", 0.37),
                                            ("irregular16", None), ("irregular16", 0.61)])
def test_face_grid3d_tables_identical(kind, cell_size):
    _, _, jm, tm = _meshes(kind)
    jg, tg = jraycast.build_face_grid3d(jm, cell_size), traycast.build_face_grid3d(tm, cell_size)
    for name in ("origin", "dims", "cell_start", "bucket_faces"):
        np.testing.assert_array_equal(getattr(tg, name).numpy(), np.asarray(getattr(jg, name)),
                                      name)
    assert float(tg.cell_size) == float(jg.cell_size)
    assert tg.max_per_cell == jg.max_per_cell and tg.cell_size_static == jg.cell_size_static


def _rays(n=128, seed=0):
    """tests/test_raycast_grid.py's rays: from above the terrain, in seeded
    directions with a downward component, unit length."""
    rng = np.random.default_rng(seed)
    o = np.stack([rng.uniform(1, 8, n), rng.uniform(1, 8, n), rng.uniform(3.0, 6.0, n)],
                 axis=1).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2]) - 0.3
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


@pytest.mark.parametrize("route", ["grid", "bruteforce"])
def test_raycasts_match_reference(route):
    _, _, jm, tm = _meshes("rays")
    o, d = _rays()
    if route == "grid":
        ref = jraycast.raycast_grid(jm, jraycast.build_face_grid3d(jm), jnp.asarray(o),
                                    jnp.asarray(d), n_steps=48)
        got = traycast.raycast_grid(tm, traycast.build_face_grid3d(tm), torch.from_numpy(o),
                                    torch.from_numpy(d), n_steps=48)
    else:
        ref = jraycast.raycast_bruteforce(jm, jnp.asarray(o), jnp.asarray(d), face_chunk=256)
        got = traycast.raycast_bruteforce(tm, torch.from_numpy(o), torch.from_numpy(d),
                                          face_chunk=256)
    hit = np.asarray(ref[2])
    assert 0 < hit.sum() < len(o)
    np.testing.assert_array_equal(got[2].numpy(), hit)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_allclose(got[0].numpy()[hit], np.asarray(ref[0])[hit], rtol=0, atol=1e-5)
    assert np.isinf(got[0].numpy()[~hit]).all()


def test_vertex_clearance_routes_agree_on_vertex_subsets():
    _, _, jm, tm = _meshes("rays")
    g = traycast.build_face_grid3d(tm)
    ids = torch.from_numpy(np.random.default_rng(3).choice(tm.num_vertices, 40, replace=False))
    full = traycast.vertex_clearance_grid(tm, g, 0.9, chunk=100)
    ref = np.asarray(jraycast.vertex_clearance_grid(jm, jraycast.build_face_grid3d(jm), 0.9))
    np.testing.assert_allclose(full.numpy(), ref, rtol=0, atol=1e-6)
    torch.testing.assert_close(traycast.vertex_clearance_grid(tm, g, 0.9, vertex_ids=ids),
                               full[ids], rtol=0, atol=0)
    torch.testing.assert_close(traycast.vertex_clearance(tm, 0.9, vertex_ids=ids), full[ids],
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("branch", ["grid3d", "bruteforce"])
@pytest.mark.parametrize("axis", [(0.3, 0.2, -1.0), (-0.5, 0.1, -1.0)])
def test_process_point_cloud_tilted_axis(branch, axis):
    v, _, jm, tm = _meshes("rays")
    rng = np.random.default_rng(11)
    pts = (v[rng.integers(0, len(v), 128)] + np.asarray([0.3, -0.2, 0.5])).astype(np.float32)
    pts[rng.integers(0, 128, 3)] = np.nan
    params = jobstacle.ObstacleParams(robot_height=1.0, down_axis=axis)
    jg = jraycast.build_face_grid3d(jm) if branch == "grid3d" else None
    tg = traycast.build_face_grid3d(tm) if branch == "grid3d" else None
    ref = jobstacle.process_point_cloud(jm, jnp.asarray(pts), params, face_grid3d=jg,
                                        face_grid=jraycast.build_face_grid(jm))
    got = tobstacle.process_point_cloud(tm, torch.from_numpy(pts),
                                        tobstacle.ObstacleParams(*params), face_grid3d=tg,
                                        face_grid=traycast.build_face_grid(tm))
    assert 0 < int(got.sum()) < len(v)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _wall_lethal(kind, V):
    lethal = np.zeros(V, bool)
    if kind == "irregular16":
        v = _meshes(kind)[0]
        lethal[np.argsort(np.abs(v[:, 0] - 4.0) + 0.01 * v[:, 1])[:8]] = True
    else:
        lethal[10 * N_SERVER + np.arange(3, 17)] = True   # one straight row: tied scores
    return lethal


@pytest.mark.parametrize("kind,route", [("flat", "banded"), ("server", "banded"),
                                        ("irregular16", "gather")])
def test_repulsive_field_matches_reference(kind, route):
    _, _, jm, tm = _meshes(kind)
    lethal = _wall_lethal(kind, jm.num_vertices)
    p = jinflation.InflationParams(inflation_radius=1.5, inscribed_radius=0.3)
    tp = tinflation.InflationParams(*p)
    jplan = jbs.build_sethian_plan(jm) if route == "banded" else None
    tplan = tbs.build_sethian_plan(tm) if route == "banded" else None
    jd = np.asarray(jinflation.inflation_distances(jm, jnp.asarray(lethal), p,
                                                   sethian_plan=jplan).dist)
    td = tinflation.inflation_distances(tm, torch.from_numpy(lethal), tp, sethian_plan=tplan)
    np.testing.assert_array_equal(np.isfinite(td.numpy()), np.isfinite(jd))
    _assert_costs(td.numpy(), jd, 1e-4 if route == "banded" else 1e-5)
    # the field from the same distances on both sides
    ref = np.asarray(jinflation.repulsive_field(jm, jnp.asarray(jd)))
    got = tinflation.repulsive_field(tm, torch.from_numpy(jd))
    support = np.any(ref != 0, axis=-1)
    np.testing.assert_array_equal(np.any(got.vectors.numpy() != 0, axis=-1), support)
    np.testing.assert_allclose(got.vectors.numpy(), ref, rtol=0, atol=1e-5)
    assert support.sum() > lethal.sum() and 1 < got.sweeps <= 65
    np.testing.assert_allclose(np.linalg.norm(got.vectors.numpy()[support], axis=1), 1.0,
                               atol=1e-5)


def test_repulsive_field_ties_take_the_first_slot():
    """On a flat grid a straight wall ties the winning-face score at many
    vertices; the field is the same when the incident faces are listed in
    reverse, with the tie rule applied to the reversed slots."""
    _, _, jm, tm = _meshes("flat")
    lethal = _wall_lethal("flat", tm.num_vertices)
    d = tinflation.inflation_distances(tm, torch.from_numpy(lethal),
                                       tinflation.InflationParams(inflation_radius=1.5),
                                       sethian_plan=tbs.build_sethian_plan(tm))
    v1t, v2t, _, _, _, _ = tinflation.eikonal._face_corner_tables(tm)
    u1, u2 = d[v1t], d[v2t]
    score = torch.where(torch.isfinite(u1 + u2), u1 + u2, torch.inf)
    sv = torch.where(tm.vertex_faces_mask, score[tm.vertex_faces.long(),
                                                 tm.vertex_face_corner.long()], torch.inf)
    low = sv.amin(dim=1, keepdim=True)
    assert ((sv == low) & torch.isfinite(low)).sum(dim=1).gt(1).any()     # ties exist
    got = tinflation.repulsive_field(tm, d).vectors
    ref = np.asarray(jinflation.repulsive_field(jm, jnp.asarray(d.numpy())))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


def test_repulsive_vector_at_matches_reference():
    _, _, jm, tm = _meshes("server")
    lethal = _wall_lethal("server", tm.num_vertices)
    p = jinflation.InflationParams(inflation_radius=1.5, inscribed_radius=0.3)
    d = np.asarray(jinflation.inflation_distances(jm, jnp.asarray(lethal), p,
                                                  sethian_plan=jbs.build_sethian_plan(jm)).dist)
    vec = np.asarray(jinflation.repulsive_field(jm, jnp.asarray(d)))
    rng = np.random.default_rng(2)
    faces = np.asarray(jm.faces)[rng.integers(0, jm.num_faces, 200)]
    bary = rng.dirichlet(np.ones(3), 200).astype(np.float32)
    for rep in (True, False):
        pr = p._replace(repulsive_field=rep)
        ref = np.asarray(jinflation.repulsive_vector_at(jnp.asarray(d), jnp.asarray(vec),
                                                        jnp.asarray(faces), jnp.asarray(bary), pr))
        got = tinflation.repulsive_vector_at(torch.from_numpy(d), torch.from_numpy(vec),
                                             torch.from_numpy(faces), torch.from_numpy(bary),
                                             tinflation.InflationParams(*pr)).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
        assert (np.abs(got).sum() > 0) == rep


def test_inflation_gather_route_in_a_stack():
    """Without a banded Sethian plan in the state the inflation layer takes
    the gather eikonal route, on both sides."""
    v, _, jm, tm = _meshes("irregular16")
    cfg = lambda LC: (LC(name="border", kind="border"),
                      LC(name="infl", kind="inflation", inputs=("border",),
                         params=(("inflation_radius", 1.0),)))
    js = JLayerStack.from_configs(cfg(jconfig.LayerConfig))
    ts = LayerStack.from_configs(cfg(tconfig.LayerConfig))
    jst, tst = js.prepare(jm), ts.prepare(tm)
    jst.pop("__sethian_plan__", None)
    tst.pop("__sethian_plan__", None)
    (jout, _), (tout, _) = js.compute(jm, jst), ts.compute(tm, tst)
    _assert_costs(tout["infl"].costs.numpy(), jout["infl"].costs, 1e-5)
    np.testing.assert_allclose(tout["infl"].vectors.numpy(), np.asarray(jout["infl"].vectors),
                               rtol=0, atol=1e-5)
    assert (tout["infl"].costs > 0).sum() > tout["border"].lethal.sum()
