"""The windowed warm resolve against an exact solve along a replan chain.

A warm resolve's first round rescans every row it may touch, so its field
sits at the exact one within rounding; a round gated on supra-tolerance
gains drops the smaller ones, and along the long re-solved chains of wide
rows they add up to about one tolerance (atol + rtol*|d|). The slab of the
windowed resolve is forced in its first round as the full path is. On the
chain below (384 x 192 vertices, four seeds in the top rows, obstacles
near the bottom, a 256-row window that fits and certifies every update)
the windowed and the windowless fields sit within 6e-4 tolerances of a
heap Dijkstra on the reference's slot weights; with the slab's first
round left gated, the clear's windowed field sat 0.99 tolerances above.
Here both are held within a tenth of the tolerance."""

import numpy as np
import torch
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import dijkstra

from mesh_navigation_tpu.mesh import synthetic
from mesh_navigation_tpu.mesh.arrays import host_array as jhost_array
from mesh_navigation_tpu.ops import sweeps as jsweeps

from mesh_navigation_torch.api.server import MeshNavServer
from mesh_navigation_torch.mesh.arrays import build_mesh
from mesh_navigation_torch.ops import banded_gpu as bg

from test_torch_reference import reference_build_mesh
from test_torch_window import _cloud, _replan_config

torch.set_num_threads(2)

ATOL, RTOL = 1e-4, 2e-3
ROWS, COLS, WINDOW = 384, 192, 256


def _exact(jm, costs, seeds):
    """[B, V] heap Dijkstra (scipy) over the reference's slot weights,
    in-edge adj[v, j] -> v of weight W[v, j]."""
    W = jsweeps.slot_weights_np(jm, costs, cost_limit=2.0, edge_cost_factor=1.0)
    adj = jhost_array(jm, "adj_vertex")
    V = W.shape[0]
    dst, slot = np.nonzero(np.isfinite(W))
    g = coo_matrix((W[dst, slot].astype(np.float64), (adj[dst, slot], dst)),
                   shape=(V, V)).tocsr()
    return dijkstra(g, indices=seeds)


def test_windowed_chain_stays_near_an_exact_solve():
    v, f = synthetic.terrain_mesh(ROWS, COLS, spacing=0.5, hills=1.0, roughness=0.02, seed=4)
    jm = reference_build_mesh(v, f)
    srv = MeshNavServer(build_mesh(v, f, device="cpu"), _replan_config(),
                        planner_kind="dijkstra", device="cpu")
    steps = {"on": srv.make_replan_step("obst", inflation_window=(24, 32), warm_window=WINDOW),
             "off": srv.make_replan_step("obst", inflation_window=(24, 32))}
    seeds = np.sort(np.random.default_rng(1).integers(0, 12 * COLS, 4))
    ts = torch.from_numpy(seeds).long()
    d0 = bg.banded_solve_padded(srv.banded_plan, ts, atol=ATOL, rtol=RTOL).d_pad
    state = {k: (srv.vertex_costs, d0) for k in steps}
    rng = np.random.default_rng(7)
    centre = int(rng.integers((ROWS - 200) * COLS, (ROWS - 150) * COLS))
    clouds = (_cloud(v, COLS, rng, centre), _cloud(v, COLS, rng, centre + 3 * COLS + 3),
              _cloud(v, COLS, rng, centre, z_off=1e4))
    for i, pts in enumerate(clouds):
        for mode, step in steps.items():
            costs, d = state[mode]
            costs, d, _ = step(torch.from_numpy(pts), costs, d, ts)
            state[mode] = (costs, d)
            assert step.last["converged"], (i, mode)
        w = steps["on"].last["window"]
        assert w.fit and w.done, (i, w)
        exact = _exact(jm, state["on"][0].numpy(), seeds)
        fin = np.isfinite(exact)
        tol = ATOL + RTOL * np.abs(exact[fin])
        for mode in steps:
            got = state[mode][1][:ROWS, :COLS, :len(seeds)].reshape(-1, len(seeds))[:len(v)]
            got = got.numpy().T
            np.testing.assert_array_equal(np.isfinite(got), fin, f"{i} {mode}")
            ratio = float((np.abs(got[fin] - exact[fin]) / tol).max())
            assert ratio <= 0.1, (i, mode, ratio)
