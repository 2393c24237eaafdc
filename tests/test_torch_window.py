"""The windowed warm resolve (`warm_window`) of the port, on the CPU.

The window runs a warm resolve's rounds on a row slab of a multiple of 128
rows, so these meshes are taller than the port's other test meshes: 144,
160 and 256 rows of 16 or 8 columns (2,048-2,560 vertices). Every windowed
field is held against a cold solve on the same planes within twice the
stopping tolerance atol + rtol*|d|, with the same finite set: a warm field
is certified edge by edge (tests/test_torch_replan.py).

The reference's windowed path certifies a slab that is not converged (its
loop stores the negation of the violation flag) and drops the seeds
outside the slab. The maze below needs several slab rounds: the port's
window runs them, and the reference's, run in interpret mode as its own
tests run it, returns converged with labels left at +inf."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mesh_navigation_tpu.mesh import synthetic
from mesh_navigation_tpu.ops import pallas_banded as jpb
from mesh_navigation_tpu.ops import sweeps as jsweeps

from mesh_navigation_torch.api.server import MeshNavServer
from mesh_navigation_torch.config import LayerConfig, MeshMapConfig, NavConfig, PlannerConfig
from mesh_navigation_torch.mesh.arrays import build_mesh
from mesh_navigation_torch.ops import banded_gpu as bg

import window_cases as wc
from test_torch_reference import reference_build_mesh

torch.set_num_threads(2)

ATOL, RTOL, TOL = wc.ATOL, wc.RTOL, wc.TOL
_plans, _warm = wc.plans, wc.warm


def _within(got, ref, k=2.0, atol=ATOL, rtol=RTOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert not np.isnan(got).any()
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    err = np.abs(got[fin] - ref[fin])
    assert np.all(err <= k * (atol + rtol * np.abs(ref[fin]))), float(err.max())


def test_window_refills_a_maze_over_several_slab_rounds():
    p0, p1, seeds, before, after, d_prev = wc.case("maze", "cpu")
    kept = d_prev.clone()
    cold = bg.banded_solve_padded(p1, seeds, **TOL)
    assert cold.converged
    reached = torch.isfinite(cold.d_pad[wc.MAZE_TOP:wc.MAZE_BOT])
    assert int(reached.sum()) > 500
    res = _warm(p0, p1, seeds, before, after, d_prev, warm_window=128)
    w = res.window
    assert w.fit and w.done and not w.seam_abort
    assert w.slab_rounds >= 2 and res.rounds == w.slab_rounds and res.converged
    _within(res.d_pad, cold.d_pad)
    assert torch.equal(d_prev, kept)
    # without the window the full loop reaches the same field
    off = _warm(p0, p1, seeds, before, after, d_prev)
    assert off.converged and off.window is None
    _within(res.d_pad, off.d_pad)
    # one slab round leaves the slab violating: it is not certified, and
    # the round budget leaves no full round
    one = _warm(p0, p1, seeds, before, after, d_prev, warm_window=128, max_rounds=1)
    assert one.window.fit and not one.window.done and one.window.slab_rounds == 1
    assert not one.converged


def test_reference_window_certifies_a_maze_slab_it_has_not_solved():
    """Reference fault: on the maze the JAX package's windowed resolve
    returns converged after one slab round with labels left at +inf that
    the cold solve reaches."""
    v, f = wc.flat_terrain(wc.MAZE_ROWS, wc.MAZE_COLS)
    jm = reference_build_mesh(v, f)
    before, after = wc.maze_costs()
    p0, p1 = (jpb.build_banded_kernel_plan(jm, jsweeps.slot_weights_np(
        jm, c, cost_limit=2.0, edge_cost_factor=1.0)) for c in (before, after))
    seeds = jnp.asarray(wc.MAZE_SEEDS, jnp.int32)
    d_prev = jpb.banded_solve_padded(p0, seeds, **TOL).d_pad
    win = jpb.banded_solve_padded(
        p1, seeds, **TOL, converge="check", warm_d=d_prev, warm_window=128,
        warm_changed=jpb.changed_plane_from_costs(p0, jnp.asarray(before), jnp.asarray(after)),
        warm_raised=jpb.raised_plane_from_costs(p0, jnp.asarray(before), jnp.asarray(after)))
    cold = np.asarray(jpb.banded_solve_padded(p1, seeds, **TOL).d_pad)
    got = np.asarray(win.d_pad)
    assert bool(win.converged) and int(win.rounds) == 1
    assert int((np.isinf(got) & np.isfinite(cold)).sum()) > 100


def test_window_seam_crossing_wall_clear_falls_back():
    """The wall clear of tests/test_pallas_banded.py:632: the changed rows
    fit the window, but the labels on the far side of the wall drop all the
    way to the field's end, across the slab's seam. The seam aborts the
    slab and the full loop finishes from the slab-written field. The seed
    sits at the field's last row, not its first as in the reference's
    test: the slab is clamped to the last 128 rows, and a seam on the
    field's edge is not compared, so there the slab alone is right."""
    pw, p0, seeds, walled, costs, d_w = wc.case("wall_clear", "cpu")
    res = _warm(pw, p0, seeds, walled, costs, d_w, warm_window=128)
    assert res.window.fit and res.window.seam_abort and not res.window.done
    assert res.converged and res.rounds > res.window.slab_rounds
    _within(res.d_pad, bg.banded_solve_padded(p0, seeds, **TOL).d_pad)


def test_window_raise_then_clear_matches_cold():
    """The pair of tests/test_pallas_banded.py:577: a lethal disc raised
    and resolved in a 128-row window (with the shadow bound), then cleared
    again: each field matches the cold solve on its planes."""
    v, f = synthetic.terrain_mesh(160, 16, spacing=0.5, hills=1.0, roughness=0.01, seed=2)
    mesh = build_mesh(v, f, device="cpu")
    costs = np.random.default_rng(5).uniform(0.0, 0.4, mesh.num_vertices).astype(np.float32)
    d2 = np.sum((v[:, :2] - v[1290, :2]) ** 2, axis=1)
    disc = np.where(d2 < 1.0, np.inf, costs).astype(np.float32)
    p0, p2 = _plans(mesh, costs, disc)
    pos = bg.position_planes(p0, mesh)
    seeds = torch.tensor([3, 700, 2100])
    base = bg.banded_solve_padded(p0, seeds, **TOL).d_pad
    up = _warm(p0, p2, seeds, costs, disc, base, warm_window=128, warm_pos=pos)
    assert up.converged and up.window is not None
    _within(up.d_pad, bg.banded_solve_padded(p2, seeds, **TOL).d_pad)
    back = _warm(p2, p0, seeds, disc, costs, up.d_pad, warm_window=128, warm_pos=pos)
    assert back.converged
    _within(back.d_pad, base)


def test_window_reinserts_a_new_seed_outside_the_slab():
    """Warm resolve with a seed the previous solve did not have: lane 0's
    goal moves 180 rows from the changed region. Its row counts as affected
    (its label in warm_d is not 0), the span no longer fits the window, and
    the full path re-inserts it. With the old seeds the same update fits.
    The old seed's labels stay where the cut leaves them (valid upper
    bounds), so the lane holds the field of both seeds: the pointwise
    minimum of the two cold fields."""
    v, f = synthetic.terrain_mesh(256, 8, spacing=0.5, hills=1.0, roughness=0.01, seed=3)
    mesh = build_mesh(v, f, device="cpu")
    costs = np.zeros(mesh.num_vertices, np.float32)   # weights = lengths: a tight shadow bound
    new = costs.copy()
    new[(np.arange(mesh.num_vertices) // 8 == 210) & (np.arange(mesh.num_vertices) % 8 > 1)] = np.inf
    p0, p1 = _plans(mesh, costs, new)
    pos = bg.position_planes(p0, mesh)
    old_seeds = torch.tensor([200 * 8 + 3, 120 * 8 + 5])
    d_prev = bg.banded_solve_padded(p0, old_seeds, **TOL).d_pad
    same = _warm(p0, p1, old_seeds, costs, new, d_prev, warm_window=128, warm_pos=pos)
    assert same.window.fit and same.converged
    _within(same.d_pad, bg.banded_solve_padded(p1, old_seeds, **TOL).d_pad)
    seeds = torch.tensor([30 * 8 + 3, 120 * 8 + 5])
    assert float(d_prev[30, 3, 0]) > 0
    res = _warm(p0, p1, seeds, costs, new, d_prev, warm_window=128, warm_pos=pos)
    assert not res.window.fit and res.window.slab_rounds == 0 and res.converged
    assert float(res.d_pad[30, 3, 0]) == 0.0
    both = torch.minimum(bg.banded_solve_padded(p1, seeds, **TOL).d_pad,
                         bg.banded_solve_padded(p1, old_seeds, **TOL).d_pad)
    _within(res.d_pad, both)


def test_window_argument_is_a_positive_multiple_of_128():
    p0, p1, seeds, before, after, d_prev = wc.case("maze", "cpu")
    for bad in (0, 64, 200):
        with pytest.raises(ValueError):
            _warm(p0, p1, seeds, before, after, d_prev, warm_window=bad)
    # a window as tall as the field is not used
    res = _warm(p0, p1, seeds, before, after, d_prev, warm_window=256)
    assert res.window is None and res.converged


def _replan_config():
    return NavConfig(
        mesh_map=MeshMapConfig(default_layer="combine", edge_cost_factor=1.0),
        planner=PlannerConfig(cost_limit=2.0),
        layers=(
            LayerConfig(name="steep", kind="steepness", params=(("threshold", 2.0),)),
            LayerConfig(name="obst", kind="obstacle"),
            LayerConfig(name="infl", kind="inflation", inputs=("obst",),
                        params=(("repulsive_field", 0.0),)),
            LayerConfig(name="combine", kind="max_combination", inputs=("steep", "obst", "infl")),
        ),
    )


def _cloud(v, n_cols, rng, center, z_off=0.3, n=96):
    """bench.py's replan clouds: points over a +-2-row/col patch."""
    ids = np.clip(center + rng.integers(-2, 3, n) * n_cols + rng.integers(-2, 3, n),
                  0, len(v) - 1)
    jit = np.concatenate([rng.uniform(-0.1, 0.1, (n, 2)), np.zeros((n, 1))], axis=1)
    return (v[ids] + jit + np.asarray([0, 0, z_off])).astype(np.float32)


@pytest.mark.parametrize("rows,cols", [(24, 24), (160, 16)])
def test_replan_step_window_matches_the_step_without_it(rows, cols):
    """make_replan_step(warm_window=128) against the same step without it,
    over a jump / drift / clear chain: on the 24 x 24 replan mesh the
    window is as tall as the field and is not used (fields bit for bit);
    on a 160 x 16 terrain it runs, and each field agrees with the
    windowless step's and the cold solve's within two tolerances."""
    v, f = synthetic.terrain_mesh(rows, cols, spacing=0.5, hills=1.0, roughness=0.02, seed=4)
    srv = MeshNavServer(build_mesh(v, f, device="cpu"), _replan_config(),
                        planner_kind="dijkstra", device="cpu")
    on = srv.make_replan_step("obst", inflation_window=(24, 32), warm_window=128)
    off = srv.make_replan_step("obst", inflation_window=(24, 32))
    seeds = torch.from_numpy(np.sort(np.random.default_rng(1).integers(0, len(v), 9))).long()
    atol, rtol = 1e-4, 2e-3
    d0 = bg.banded_solve_padded(srv.banded_plan, seeds, atol=atol, rtol=rtol).d_pad
    state = {on: (srv.vertex_costs, d0), off: (srv.vertex_costs, d0)}
    rng = np.random.default_rng(7)
    centre = (rows // 2) * cols + cols // 2
    fits = []
    for i in range(6):
        if i % 3 == 0:
            centre = int(rng.integers(3 * cols, len(v) - 3 * cols))
            pts = _cloud(v, cols, rng, centre)
        elif i % 3 == 1:
            pts = _cloud(v, cols, rng, min(centre + 3 * cols + 3, len(v) - 1))
        else:
            pts = _cloud(v, cols, rng, centre, z_off=1e4)
        for step in (on, off):
            costs, d = state[step]
            costs, d, _ = step(torch.from_numpy(pts), costs, d, seeds)
            state[step] = (costs, d)
            assert step.last["converged"], i
        assert off.last["window"] is None
        d_on, d_off = state[on][1], state[off][1]
        assert torch.equal(state[on][0], state[off][0])
        if rows < 128:
            assert on.last["window"] is None and torch.equal(d_on, d_off)
        else:
            fits.append(on.last["window"].fit)
            _within(d_on.numpy(), d_off.numpy(), atol=atol, rtol=rtol)
            cold = bg.banded_solve_padded(on.last["plan"], seeds, atol=atol, rtol=rtol).d_pad
            _within(d_on.numpy(), cold.numpy(), atol=atol, rtol=rtol)
    if rows >= 128:
        assert any(fits)
