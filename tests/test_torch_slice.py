"""The port's main path against the reference's, end to end on a small
terrain: plan_batch_banded (light) + compute_velocity_banded with 8 lanes and
non-trivial goal grouping, at the main path's tolerances (atol 1e-4,
rtol 2e-3). Both solve with 8-lane blocks in the same row order with the
same chain-weight scans, so fields, class tables and paths coincide;
outcomes must be equal, costs within rtol 1e-5 (summation order of the
segment lengths), linear and angular velocities within 1e-5.

Also: import hygiene of the port, and no silent CPU fallback."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mesh_navigation_tpu.config import ControllerConfig as JControllerConfig
from mesh_navigation_tpu.config import PlannerConfig as JPlannerConfig
from mesh_navigation_tpu.control import MeshController as JMeshController
from mesh_navigation_tpu.control.controller import initial_state as j_initial_state
from test_torch_reference import reference_build_mesh as jax_build_mesh
from mesh_navigation_tpu.mesh import synthetic
from mesh_navigation_tpu.ops import sweeps as jsweeps
from mesh_navigation_tpu.planners import DijkstraPlanner as JDijkstraPlanner

from mesh_navigation_torch.config import ControllerConfig, PlannerConfig
from mesh_navigation_torch.control.controller import MeshController, initial_state
from mesh_navigation_torch.mesh.arrays import build_mesh
from mesh_navigation_torch.ops import sweeps
from mesh_navigation_torch.planners.dijkstra import DijkstraPlanner, potential_lanes

torch.set_num_threads(2)

ATOL, RTOL, TOL = 1e-4, 2e-3, 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_slice_matches_reference():
    v, f = synthetic.terrain_mesh(16, 16, spacing=0.5, hills=0.2, roughness=0.01, seed=6)
    jm = jax_build_mesh(v, f)
    tm = build_mesh(v, f, device="cpu")
    nz = np.clip(np.asarray(jm.vertex_normals)[:, 2], -1.0, 1.0)
    costs = np.arccos(nz).astype(np.float32)
    W = jsweeps.slot_weights_np(jm, costs, cost_limit=2.0, edge_cost_factor=1.0)
    rng = np.random.default_rng(11)
    B = 8
    s = rng.uniform(0.3, 7.2, (B, 3)).astype(np.float32)
    g = rng.uniform(0.3, 7.2, (B, 3)).astype(np.float32)
    s[:, 2] = 0.0
    g[:, 2] = 0.0

    jp = JDijkstraPlanner(jm, JPlannerConfig(method="batched", ordered_rounds=0, cost_limit=2.0),
                          max_path_len=128)
    jk = jp.prepare_banded_plan(W)
    jres = jp.plan_batch_banded(jnp.asarray(W), jk, jnp.asarray(s), jnp.asarray(g),
                                light=True, atol=ATOL, rtol=RTOL)
    # each robot faces 10 degrees off its path's first step: the heading
    # errors sit inside max_angle (so linear is not clipped to 0) and away
    # from acos's singular point at 0, where one ulp of cos(phi) moves linear
    # by more than 1e-5
    step = np.asarray(jres.path_positions)[:, 1] - np.asarray(jres.path_positions)[:, 0]
    yaw = np.arctan2(step[:, 1], step[:, 0]) + np.deg2rad(10.0)
    q = np.stack([0 * yaw, 0 * yaw, np.sin(yaw / 2), np.cos(yaw / 2)], 1).astype(np.float32)
    jc = JMeshController(jm, JControllerConfig(), grid=jp.grid)
    jst = jax.vmap(lambda x: j_initial_state(x, jnp.asarray([1.0, 0.0, 0.0])))(jnp.asarray(g))
    jcmd, jst2 = jc.compute_velocity_banded(
        jk, jres.d_pad.reshape(-1, jres.d_pad.shape[-1]), jnp.asarray(costs),
        jnp.asarray(s), jnp.asarray(q), jst, tol=TOL, lane_minor=True,
        lane_map=jres.lane_map, padded_flat=True,
    )

    tp = DijkstraPlanner(tm, PlannerConfig(cost_limit=2.0), max_path_len=128, device="cpu")
    tk = tp.prepare_banded_plan(sweeps.slot_weights_np(tm, costs, cost_limit=2.0, edge_cost_factor=1.0))
    tres = tp.plan_batch_banded(tk, torch.from_numpy(s), torch.from_numpy(g), atol=ATOL, rtol=RTOL)
    tc = MeshController(tm, ControllerConfig(), grid=tp.grid, device="cpu")
    tst = initial_state(torch.from_numpy(g), torch.tensor([1.0, 0.0, 0.0]))
    tcmd, tst2 = tc.compute_velocity_banded(
        tk, tres.d_pad.reshape(-1, tres.d_pad.shape[-1]), torch.from_numpy(costs),
        torch.from_numpy(s), torch.from_numpy(q), tst, tol=TOL, lane_map=tres.lane_map,
    )

    lane_map = tres.lane_map.numpy()
    assert not np.array_equal(lane_map, np.arange(B))          # grouping permutes
    np.testing.assert_array_equal(lane_map, np.asarray(jres.lane_map))
    np.testing.assert_array_equal(tres.outcome.numpy(), np.asarray(jres.outcome))
    np.testing.assert_allclose(tres.cost.numpy(), np.asarray(jres.cost), rtol=1e-5)
    np.testing.assert_array_equal(tres.path_valid.numpy(), np.asarray(jres.path_valid))
    np.testing.assert_allclose(tres.path_positions.numpy(), np.asarray(jres.path_positions),
                               atol=1e-6)
    # a quaternion component near 0 is sqrt(max(x, 1e-12)) / 2 of a sum that
    # cancels to a few ulp, so it carries sqrt(ulp(1)) / 2 ~ 2e-4 of noise
    np.testing.assert_allclose(tres.path_quats.numpy(), np.asarray(jres.path_quats), atol=5e-4)
    np.testing.assert_array_equal(tcmd.outcome.numpy(), np.asarray(jcmd.outcome))
    assert (tcmd.outcome.numpy() == 0).sum() >= B // 2        # most lanes steer
    assert (tcmd.linear.numpy() > 0).sum() >= B // 2          # and drive
    np.testing.assert_allclose(tcmd.linear.numpy(), np.asarray(jcmd.linear), atol=1e-5)
    np.testing.assert_allclose(tcmd.angular.numpy(), np.asarray(jcmd.angular), atol=1e-5)
    np.testing.assert_allclose(tcmd.cost.numpy(), np.asarray(jcmd.cost), atol=1e-5)
    np.testing.assert_array_equal(tst2.current_face.numpy(), np.asarray(jst2.current_face))
    # the potential is produced only for the lanes asked for
    pot = potential_lanes(tk, tres.d_pad, tres.lane_map, [0, 3])
    jpot = np.asarray(jres.potential)[[0, 3]]
    np.testing.assert_allclose(pot, jpot, rtol=RTOL, atol=ATOL)


def test_port_imports_neither_jax_nor_reference():
    code = (
        "import pkgutil, sys, importlib, mesh_navigation_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, 'mesh_navigation_torch.')]\n"
        "[importlib.import_module(m) for m in mods]\n"
        "assert len(mods) >= 15, mods\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('mesh_navigation_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok', len(mods))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    v, f = synthetic.terrain_mesh(4, 4)
    mesh = build_mesh(v, f, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DijkstraPlanner(mesh)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MeshController(mesh)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_mesh(v, f)
