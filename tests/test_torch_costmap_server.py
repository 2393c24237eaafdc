"""Port vs reference: the layered costmap as a whole. The README's example
stack and the full layer stack of chip_smoke.py through LayerStack, the
CVP server on both (the single GetPath with the layers' repulsive field
blended in; the batch GetPath before and after a sensor update), and the
replan step of a Dijkstra server on the full stack, which computes no
repulsive field. tests/test_torch_costmap.py holds the layers alone.

The maps: tests/test_torch_costmap.py's 20 x 20 server terrain (one set of
compiled shapes for the reference), the full stack's inflation radii
halved for it. Tolerances:
- the stacks: lethal masks identical, costs within 1e-5 (arccos in
  roughness and steepness), combined vectors within 1e-5 with an identical
  support;
- server GetPath: tests/test_torch_gather.py's _assert_plans_close (path
  positions within 1e-4, potentials within rtol 1e-5, predecessors equal)
  but for the CVP vector map, held within 1e-3 everywhere: the two sides'
  layer costs differ in the last bits (arccos), and θ's arccos amplifies
  that past 1e-5 on more than the 5% of entries that helper allows;
- batch fields within rtol 2e-3 / atol 1e-3 of the reference's gather
  plan_batch: the banded sweeps stop at atol 1e-4 + rtol 1e-3·|d| per
  label, and around the obstacle of the update below the reference's own
  banded path sits 1.15e-3 (relative) from its gather field, the port's
  1.34e-3 (tests/test_torch_cvp.py holds obstacle-free fields at 1e-3);
- replan steps: costs within 1e-5; warm fields within twice the replan
  tolerance atol + rtol·|d| of an exact solve and of the reference's (each
  warm field is certified only edge by edge: on the full stack's jump the
  reference's sits 1.09 tolerances from the exact field, the port's 0.16);
  where the reference's warm cut leaves labels stale (ROADMAP queue C: the
  drift below) the port is held to the exact field alone.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mesh_navigation_tpu import config as jconfig
from mesh_navigation_tpu.api.server import MeshNavServer as JMeshNavServer
from mesh_navigation_tpu.layers import LayerStack as JLayerStack
from mesh_navigation_tpu.ops import pallas_banded as jpb

from mesh_navigation_torch import config as tconfig
from mesh_navigation_torch.api.outcomes import Outcome
from mesh_navigation_torch.api.server import MeshNavServer
from mesh_navigation_torch.layers import LayerStack
from mesh_navigation_torch.layers import inflation as tinflation
from mesh_navigation_torch.mesh import query as tquery
from mesh_navigation_torch.mesh.arrays import build_mesh
from mesh_navigation_torch.ops import banded_gpu as tbg
from mesh_navigation_torch.planners.dijkstra import potential_lanes

from test_torch_costmap import N_SERVER, _assert_costs, _meshes, _server_mesh
from test_torch_gather import _assert_dist, _assert_plans_close
from test_torch_reference import reference_build_mesh
from test_torch_replan import ATOL, RTOL, _within

torch.set_num_threads(2)


def readme_layers(LC):
    """README.md's library example: steepness, roughness, obstacles,
    inflation with its default parameters, and their max."""
    return (
        LC(name="steepness", kind="steepness"),
        LC(name="roughness", kind="roughness"),
        LC(name="obstacles", kind="obstacle"),
        LC(name="inflation", kind="inflation", inputs=("obstacles",)),
        LC(name="combined", kind="max_combination",
           inputs=("steepness", "roughness", "inflation")),
    )


def full_stack_layers(LC, inflation_scale=1.0):
    """chip_smoke.py's full_stack configuration; the inflation radii scale
    with the map (1.0 at 1M vertices)."""
    return (
        LC(name="height_diff", kind="height_diff", params=(("radius", 1.0), ("threshold", 0.185))),
        LC(name="roughness", kind="roughness", params=(("radius", 1.0), ("threshold", 0.3))),
        LC(name="ridge", kind="ridge", params=(("radius", 1.0), ("threshold", 0.3))),
        LC(name="steepness", kind="steepness", params=(("threshold", 0.3),)),
        LC(name="border", kind="border"),
        LC(name="clearance", kind="clearance"),
        LC(name="obst", kind="obstacle"),
        LC(name="infl", kind="inflation", inputs=("obst", "border", "clearance"),
           params=(("inflation_radius", 2.0 * inflation_scale),
                   ("inscribed_radius", 0.5 * inflation_scale))),
        LC(name="combined", kind="max_combination",
           inputs=("height_diff", "roughness", "ridge", "steepness", "border", "clearance",
                   "obst", "infl")),
    )


def _cloud(v, n_side, center, n=48, seed=5, z_off=0.3):
    rng = np.random.default_rng(seed)
    ids = np.clip(center + rng.integers(-2, 3, n) * n_side + rng.integers(-2, 3, n), 0, len(v) - 1)
    jit = np.concatenate([rng.uniform(-0.1, 0.1, (n, 2)), np.full((n, 1), z_off)], axis=1)
    return (v[ids] + jit).astype(np.float32)


@pytest.mark.parametrize("stack", ["readme", "full_stack"])
def test_layer_stack_matches_reference(stack):
    v, _, jm, tm = _meshes("server")
    make = readme_layers if stack == "readme" else (lambda LC: full_stack_layers(LC, 0.5))
    default = "combined"
    js = JLayerStack.from_configs(make(jconfig.LayerConfig), default)
    ts = LayerStack.from_configs(make(tconfig.LayerConfig), default)
    assert ts.order == js.order
    jst, tst = js.prepare(jm), ts.prepare(tm)
    pts = _cloud(v, N_SERVER, 8 * N_SERVER + 12)
    jst["obstacle:obst:points" if stack == "full_stack" else "obstacle:obstacles:points"] = \
        jnp.asarray(pts)
    tst["obstacle:obst:points" if stack == "full_stack" else "obstacle:obstacles:points"] = \
        torch.from_numpy(pts)
    (jout, jcomb), (tout, tcomb) = js.compute(jm, jst), ts.compute(tm, tst)
    for name in js.order:
        np.testing.assert_array_equal(tout[name].lethal.numpy(), np.asarray(jout[name].lethal),
                                      name)
        _assert_costs(tout[name].costs.numpy(), jout[name].costs, 1e-5, name)
    _assert_costs(tcomb.numpy(), jcomb, 1e-5)
    jvec = np.asarray(js.combined_vectors(jm, jout))
    tvec = ts.combined_vectors(tm, tout).numpy()
    np.testing.assert_array_equal(np.any(tvec != 0, axis=-1), np.any(jvec != 0, axis=-1))
    np.testing.assert_allclose(tvec, jvec, rtol=0, atol=1e-5)
    obst, infl = ("obstacles", "inflation") if stack == "readme" else ("obst", "infl")
    assert tout[obst].lethal.any() and np.any(tvec != 0)
    assert tst[f"inflation:{infl}"][1] is tout[infl].vectors


def _full_config(c, scale=0.5, kind_default="combined"):
    return c.NavConfig(mesh_map=c.MeshMapConfig(default_layer=kind_default, edge_cost_factor=1.0),
                       planner=c.PlannerConfig(cost_limit=2.0),
                       layers=full_stack_layers(c.LayerConfig, scale))


def _readme_config(c):
    return c.NavConfig(mesh_map=c.MeshMapConfig(edge_cost_factor=1.0, default_layer="combined"),
                       planner=c.PlannerConfig(cost_limit=1.0),
                       layers=readme_layers(c.LayerConfig))


def _cvp_servers(make):
    v, f = _server_mesh()
    js = JMeshNavServer(reference_build_mesh(v, f), make(jconfig), planner_kind="cvp",
                        max_path_len=96)
    ts = MeshNavServer(build_mesh(v, f, device="cpu"), make(tconfig), max_path_len=96,
                       device="cpu")
    _assert_costs(ts.vertex_costs.numpy(), js.vertex_costs, 1e-5)
    np.testing.assert_allclose(ts.layer_vectors.numpy(), np.asarray(js.layer_vectors),
                               rtol=0, atol=1e-5)
    return v, js, ts


def _assert_get_path(v, js, ts, n_pairs=2):
    """The single CVP GetPath with the layers' field blended in."""
    rng = np.random.default_rng(1)
    for s_id, g_id in rng.integers(0, len(v), (n_pairs, 2)):
        s, g = (v[s_id] + [0, 0, 0.05]).astype(np.float32), (v[g_id] + [0, 0, 0.05]).astype(np.float32)
        got = ts.get_path(torch.from_numpy(s), torch.from_numpy(g))
        ref = js.get_path(jnp.asarray(s), jnp.asarray(g))
        _assert_plans_close(got, ref, potential=False)
        _assert_dist(got.potential, ref.potential, 1e-5)
        np.testing.assert_array_equal(got.pred.numpy(), np.asarray(ref.pred))
        np.testing.assert_allclose(got.vector_map.numpy(), np.asarray(ref.vector_map),
                                   rtol=0, atol=1e-3)
        assert int(got.outcome) == 0


def test_cvp_server_on_the_readme_configuration():
    """README.md's library example builds on the port, and its GetPath
    agrees with the reference's."""
    _assert_get_path(*_cvp_servers(_readme_config), n_pairs=1)


def test_cvp_server_on_the_full_stack():
    """get_path_batch through the port's banded CVP path against the
    reference's gather plan_batch on the server's own weights and costs,
    before and after a sensor update. A goal whose face has a corner at or
    over the cost limit (here one lane after the update) gets no path from
    the banded path, whose seeds skip such vertices, where the gather path
    seeds every corner: the reference's own banded path gives the same
    outcome on these inputs (ROADMAP queue C); the port's gather plan_batch
    is held to the reference's there. First the single GetPath with the
    layers' repulsive field blended into the back-tracking."""
    n = N_SERVER
    v, js, ts = _cvp_servers(_full_config)
    assert ts.layer_vectors.any()
    _assert_get_path(v, js, ts)
    rng = np.random.default_rng(3)
    ids = rng.choice(len(v), 8, replace=False)
    starts, goals = v[ids[:4]].astype(np.float32), v[ids[4:]].astype(np.float32)
    for update in (False, True):
        if update:
            cloud = _cloud(v, n, 10 * n + 9)
            js.update_point_cloud("obst", jnp.asarray(cloud))
            ts.update_point_cloud("obst", torch.from_numpy(cloud))
            _assert_costs(ts.vertex_costs.numpy(), js.vertex_costs, 1e-5)
            assert ts.eikonal_stale and np.isinf(ts.vertex_costs.numpy()).any()
        res = ts.get_path_batch(torch.from_numpy(starts), torch.from_numpy(goals))
        assert res.converged
        pot = potential_lanes(ts.eikonal_plan, res.d_pad, res.lane_map, list(range(4)))
        jres = js.planner.plan_batch(js.edge_weights, js.vertex_costs, jnp.asarray(starts),
                                     jnp.asarray(goals))
        jpot = np.asarray(jres.potential)
        g_face = tquery.containing_face_batch(ts.mesh, ts.grid, torch.from_numpy(goals))[0]
        corners = ts.mesh.faces[g_face].long()
        blocked = (ts.vertex_costs[corners] >= 2.0).any(dim=1).numpy()
        assert blocked.sum() == (1 if update else 0)
        keep = ~blocked
        np.testing.assert_array_equal(np.isfinite(pot[keep]), np.isfinite(jpot[keep]))
        ok = np.isfinite(jpot) & keep[:, None]
        np.testing.assert_allclose(pot[ok], jpot[ok], rtol=2e-3, atol=1e-3)
        np.testing.assert_array_equal(res.outcome.numpy()[keep], np.asarray(jres.outcome)[keep])
        assert (res.outcome.numpy()[blocked] == int(Outcome.NO_PATH_FOUND)).all()
        gather = ts.planner.plan_batch(ts.edge_weights, ts.vertex_costs,
                                       torch.from_numpy(starts), torch.from_numpy(goals))
        if blocked.any():
            _assert_dist(gather.potential[blocked], jpot[blocked], 1e-5)
        np.testing.assert_array_equal(gather.outcome.numpy(), np.asarray(jres.outcome))


N_REPLAN = N_SERVER


def _replan_servers(with_reference=True):
    v, f = _server_mesh()
    js = (JMeshNavServer(reference_build_mesh(v, f), _full_config(jconfig), planner_kind="dijkstra",
                         max_path_len=64) if with_reference else None)
    ts = MeshNavServer(build_mesh(v, f, device="cpu"), _full_config(tconfig),
                       planner_kind="dijkstra", device="cpu")
    return v, js, ts


def _replan_clouds(v):
    rng = np.random.default_rng(2)
    c0 = 9 * N_REPLAN + 10
    return (("jump", _cloud(v, N_REPLAN, c0, seed=int(rng.integers(99)))),
            ("drift", _cloud(v, N_REPLAN, c0 + 3 * N_REPLAN + 3, seed=int(rng.integers(99)))),
            ("clear", _cloud(v, N_REPLAN, c0, seed=int(rng.integers(99)), z_off=1e4)))


def test_replan_step_on_the_full_stack_matches_reference():
    v, js, ts = _replan_servers()
    assert ts.banded_plan is not None
    window = (24, 32)
    jstep = js.make_replan_step("obst", inflation_window=window)
    tstep = ts.make_replan_step("obst", inflation_window=window)
    seeds = np.sort(np.random.default_rng(1).integers(0, len(v), 9)).astype(np.int32)
    jd = jpb.banded_solve_padded(js.banded_plan, jnp.asarray(seeds), atol=ATOL, rtol=RTOL).d_pad
    td = tbg.banded_solve_padded(ts.banded_plan, torch.from_numpy(seeds).long(), atol=ATOL,
                                 rtol=RTOL).d_pad
    jc, tc = js.vertex_costs, ts.vertex_costs
    for name, pts in _replan_clouds(v):
        jc, jd, _ = jstep(jnp.asarray(pts), jc, jd, jnp.asarray(seeds))
        tc, td, _ = tstep(torch.from_numpy(pts), tc, td, torch.from_numpy(seeds).long())
        _assert_costs(tc.numpy(), jc, 1e-5, name)
        assert tstep.last["converged"], name
        exact = tbg.banded_solve_padded(tstep.last["plan"], torch.from_numpy(seeds).long(),
                                        atol=1e-7, rtol=1e-8, max_rounds=500).d_pad.numpy()
        _within(td.numpy(), exact, k=2.0)
        ref = np.asarray(jd)
        if name == "drift":
            # the reference's warm cut misses every label when the raised
            # set reaches the plan's padding (ROADMAP queue C): it keeps
            # finite labels at vertices the drift made lethal, and stale
            # low ones behind them; the port cuts them
            stale = np.isfinite(ref) & ~np.isfinite(exact)
            assert stale.any() and not np.isfinite(td.numpy())[stale].any()
        else:
            _within(ref, exact, k=2.0)
            _within(td.numpy(), ref, k=2.0)
        assert np.isinf(tc.numpy()).any() == (name != "clear"), name


def test_replan_step_computes_no_repulsive_field(monkeypatch):
    """The step reads only costs: its layers run without the repulsive
    field, and the costs are those of a stack computed with it."""
    v, _, ts = _replan_servers(with_reference=False)
    full_costs = {}
    for name, pts in _replan_clouds(v):
        st = dict(ts.layer_state)
        st["obstacle:obst:points"] = torch.from_numpy(pts)
        full_costs[name] = ts.stack.compute(ts.mesh, st)[1]

    def refuse(*a, **k):
        raise AssertionError("the replan step computed a repulsive field")

    monkeypatch.setattr(tinflation, "repulsive_field", refuse)
    step = ts.make_replan_step("obst", inflation_window=(24, 32))
    seeds = torch.from_numpy(np.sort(np.random.default_rng(1).integers(0, len(v), 9))).long()
    d = tbg.banded_solve_padded(ts.banded_plan, seeds, atol=ATOL, rtol=RTOL).d_pad
    costs = ts.vertex_costs
    for name, pts in _replan_clouds(v):
        costs, d, _ = step(torch.from_numpy(pts), costs, d, seeds)
        assert torch.equal(costs, full_costs[name]), name
    # outside the step the layer still computes it
    with pytest.raises(AssertionError, match="repulsive field"):
        ts.stack.compute(ts.mesh, dict(ts.layer_state))
