"""Warm-window cases shared by tests/test_torch_window.py (CPU, against the
JAX package) and tests/test_torch_gpu.py (the card against the CPU). No
JAX here: the card's tests import this module.

maze: a serpentine maze whose refill after the update needs several slab
rounds with the seam intact. wall_clear: a cleared wall whose drop crosses
the slab's seam (tests/test_pallas_banded.py:632)."""

import numpy as np
import torch

from mesh_navigation_torch.mesh import synthetic
from mesh_navigation_torch.mesh.arrays import build_mesh
from mesh_navigation_torch.ops import banded_gpu as bg
from mesh_navigation_torch.ops import sweeps

ATOL, RTOL = 1e-5, 1e-5
TOL = dict(atol=ATOL, rtol=RTOL)
MAZE_ROWS, MAZE_COLS, MAZE_TOP, MAZE_BOT = 144, 16, 60, 90
MAZE_SEEDS = [5 * MAZE_COLS + 2, 10 * MAZE_COLS + 8, 20 * MAZE_COLS + 14]


def flat_terrain(nx, ny):
    return synthetic.terrain_mesh(nx, ny, spacing=0.5, hills=0.0, roughness=0.0, seed=2)


def maze_costs():
    """A serpentine maze between two walls across the mesh (rows 60 and 90;
    below row 90 nothing is reachable): vertical walls at columns 3, 6, 9
    and 12 leave gaps at alternate ends, so a label that enters at column
    1 runs down, up, down, up and down. Before the update every corridor
    also has its own entrance in the top wall; the update closes all but
    the first, so the cut labels refill down the serpentine: one pass a
    corridor, more than one round. Returns (costs before, after)."""
    vid = np.arange(MAZE_ROWS * MAZE_COLS)
    row, col = vid // MAZE_COLS, vid % MAZE_COLS
    wall = (row == MAZE_BOT) | ((row == MAZE_TOP) & ~np.isin(col, [1, 4, 7, 10, 13]))
    for k, c in enumerate([3, 6, 9, 12]):
        gap = MAZE_BOT - 1 if k % 2 == 0 else MAZE_TOP + 1
        wall |= (col == c) & (row > MAZE_TOP) & (row < MAZE_BOT) & (row != gap)
    before = np.where(wall, np.inf, 0.1).astype(np.float32)
    after = before.copy()
    after[(row == MAZE_TOP) & np.isin(col, [4, 7, 10, 13])] = np.inf
    return before, after


def wall_costs():
    """A 160 x 16 flat map at cost 0.1 and the same map with a wall across
    rows 79-80 but column 0. Returns (walled, cleared)."""
    vid = np.arange(160 * 16)
    row, col = vid // 16, vid % 16
    costs = np.full(len(vid), 0.1, np.float32)
    walled = np.where(((row == 79) | (row == 80)) & (col > 0), np.inf, costs).astype(np.float32)
    return walled, costs


def plans(mesh, *costs, cost_limit=2.0):
    return [bg.build_banded_kernel_plan(mesh, sweeps.slot_weights_np(
        mesh, c, cost_limit=cost_limit, edge_cost_factor=1.0)) for c in costs]


def warm(plan0, plan1, seeds, old, new, d_prev, **kw):
    """The warm resolve of the update old -> new costs from d_prev."""
    dev = plan0.device
    o, n = torch.from_numpy(old).to(dev), torch.from_numpy(new).to(dev)
    return bg.banded_solve_padded(
        plan1, seeds, **TOL, converge="check", warm_d=d_prev,
        warm_changed=bg.changed_plane_from_costs(plan0, o, n),
        warm_raised=bg.raised_plane_from_costs(plan0, o, n), **kw)


def case(name, device):
    """(plan before, plan after, seeds, costs before, after, the previous
    field) of a named case on `device`."""
    if name == "maze":
        v, f = flat_terrain(MAZE_ROWS, MAZE_COLS)
        old, new = maze_costs()
        seeds, limit = MAZE_SEEDS, 2.0
    else:
        v, f = flat_terrain(160, 16)
        old, new = wall_costs()
        seeds, limit = [159 * 16 + 8], 200.0
    p0, p1 = plans(build_mesh(v, f, device=device), old, new, cost_limit=limit)
    seeds = torch.tensor(seeds, device=device)
    d_prev = bg.banded_solve_padded(p0, seeds, **TOL).d_pad
    return p0, p1, seeds, old, new, d_prev
