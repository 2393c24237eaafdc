"""The port's tracing: the counters of the solve and the walk in
ops/kernels.LAUNCHES, and the residual scatter-min's span inside the solve
stage.

On the CPU the solve runs the plain passes, whose `rows_walked` counts the
(8-lane block, row) pairs a kernel's blocks walk, so the counters read here
what the card's kernel counts there. Without a timer the solve makes no
counter and the walk counts only its steps. Meshes are 32 x 32 (gridded:
main-mode passes; jittered Delaunay, band-reordered: dirty extended-lane
passes and the residual scatter-min)."""

import functools

import numpy as np
import pytest
import torch

from mesh_navigation_torch.config import PlannerConfig
from mesh_navigation_torch.mesh import synthetic
from mesh_navigation_torch.mesh.arrays import build_mesh, host_array
from mesh_navigation_torch.mesh.reorder import build_reordered_mesh
from mesh_navigation_torch.ops import banded_gpu as bg
from mesh_navigation_torch.ops import kernels, sweeps
from mesh_navigation_torch.planners import DijkstraPlanner
from mesh_navigation_torch.utils.timing import StageTimer, span, stage

from navbench import devtrace

torch.set_num_threads(2)

N, LANES = 32, 16
ATOL, RTOL = 1e-5, 1e-5


@functools.lru_cache(maxsize=None)
def _case(kind: str):
    """(mesh, plan, seeds [LANES]) on the CPU."""
    if kind == "grid":
        v, f = synthetic.terrain_mesh(N, N, spacing=0.5, hills=2.0, roughness=0.01, seed=0)
        mesh = build_mesh(v, f, device="cpu")
    else:
        v, f = synthetic.irregular_terrain_mesh(N, N, spacing=0.5, hills=1.0, seed=4)
        mesh = build_reordered_mesh(v, f, device="cpu")
    costs = np.random.default_rng(3).uniform(0.0, 0.6, mesh.num_vertices).astype(np.float32)
    W = sweeps.slot_weights_np(mesh, costs, cost_limit=2.0, edge_cost_factor=1.0)
    plan = bg.build_banded_kernel_plan(mesh, W)
    assert bool(plan.n_residual) == (kind == "irregular")
    seeds = torch.from_numpy(np.random.default_rng(7).integers(0, mesh.num_vertices, LANES))
    return mesh, plan, seeds


def _counted(monkeypatch):
    """Wrap directional_pass (on the CPU it runs the plain pass and counts
    no launch): a list that gets, for each pass, whether it was dirty-driven
    and the rows it added to the counter it was given (None where it was
    given none)."""
    calls, orig = [], bg.directional_pass

    def pass_(*a, rows_walked=None, **kw):
        before = None if rows_walked is None else int(rows_walked)
        out = orig(*a, rows_walked=rows_walked, **kw)
        calls.append((kw.get("dirty") is not None,
                      None if rows_walked is None else int(rows_walked) - before))
        return out

    monkeypatch.setattr(bg, "directional_pass", pass_)
    return calls


@pytest.mark.parametrize("timed", [True, False], ids=["timer", "no_timer"])
@pytest.mark.parametrize("kind", ["grid", "irregular"])
def test_pass_rows_count_what_the_plain_passes_walk(monkeypatch, kind, timed):
    """A timed solve adds to banded_pass_rows exactly the rows its passes
    walked: every row of every block in main mode, some of them in the
    dirty mode of an irregular plan. Without a timer no pass gets a counter
    and the count does not move."""
    _, plan, seeds = _case(kind)
    calls = _counted(monkeypatch)
    before = dict(kernels.LAUNCHES)
    res = bg.banded_solve_padded(plan, seeds, atol=ATOL, rtol=RTOL,
                                 converge="round" if plan.n_residual else "pred",
                                 timer=StageTimer("cpu") if timed else None)
    rows = kernels.LAUNCHES["banded_pass_rows"] - before["banded_pass_rows"]
    launches = len(calls)
    assert res.converged and launches == 2 * res.rounds
    dirty = [d for d, _ in calls]
    assert dirty == [kind == "irregular"] * launches
    walked = [n for _, n in calls]
    Rp, _, Bp = res.d_pad.shape
    full = launches * (Bp // bg.PASS_LANES) * Rp
    if not timed:
        assert rows == 0 and walked == [None] * launches
    elif kind == "grid":
        assert rows == sum(walked) == full
    else:
        assert rows == sum(walked) and 0 < rows < full


@pytest.mark.parametrize("timed", [True, False], ids=["timer", "no_timer"])
def test_walk_counts_its_steps_and_live_lane_steps(timed):
    """walk_steps gains the chunks the walk ran times the chunk, with or
    without a timer; walk_lane_steps gains the steps a lane still walked
    (valid's sum) only with one."""
    mesh, plan, seeds = _case("grid")
    res = bg.banded_solve_padded(plan, seeds, atol=ATOL, rtol=RTOL, converge="pred")
    starts = torch.from_numpy(np.random.default_rng(9).integers(0, mesh.num_vertices, LANES))
    chunk, max_len = 16, 4 * N
    before = dict(kernels.LAUNCHES)
    path, valid = bg.extract_paths_cls(res.cls, starts, seeds, max_len, plan.n_cols, chunk=chunk,
                                       timer=StageTimer("cpu") if timed else None)
    chunks_run = int(valid[:, ::chunk].any(dim=0).sum())
    assert 1 < chunks_run < max_len // chunk        # lanes end at different chunks
    assert kernels.LAUNCHES["walk_steps"] - before["walk_steps"] == chunks_run * chunk
    lane_steps = kernels.LAUNCHES["walk_lane_steps"] - before["walk_lane_steps"]
    assert lane_steps == (int(valid.sum()) if timed else 0)


@pytest.mark.parametrize("kind", ["grid", "irregular"])
def test_walk_on_the_cpu_is_the_plain_loop_and_launches_nothing(kind):
    """On CPU tensors extract_paths_cls runs its plain loop: paths and
    valid equal extract_paths_cls_plain's bit for bit (the irregular plan
    decodes class 9 through the residual tables), the walk's steps are
    counted, and the card's walk kernel is not counted."""
    mesh, plan, seeds = _case(kind)
    res = bg.banded_solve_padded(plan, seeds, atol=ATOL, rtol=RTOL, converge="round")
    if kind == "grid":
        cls, decode = bg.predecessors_banded_classes(plan, res.d_pad, tol=3 * RTOL), {}
    else:
        cls, choice = bg.predecessors_banded_classes_residual(plan, res.d_pad, tol=3 * RTOL)
        assert int((cls == 9).sum()) > 0
        decode = dict(res_row_map=plan.res_row_map, res_jump=plan.res_jump, res_choice=choice)
    starts = torch.from_numpy(np.random.default_rng(5).integers(0, mesh.num_vertices, LANES))
    before = dict(kernels.LAUNCHES)
    got = bg.extract_paths_cls(cls, starts, seeds, 3 * N, plan.n_cols, chunk=16, **decode)
    assert kernels.LAUNCHES["walk"] == before["walk"]
    assert kernels.LAUNCHES["walk_steps"] > before["walk_steps"]
    want = bg.extract_paths_cls_plain(cls, starts, seeds, 3 * N, plan.n_cols, chunk=16,
                                      **decode)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[0].shape == (LANES, 3 * N) and bool(got[1][:, 0].all())


def test_residual_span_is_a_part_of_the_solve_stage():
    """The residual scatter-min's span shows in totals() under its compound
    name, within the solve stage that holds it; with no timer a span is a
    no-op."""
    _, plan, seeds = _case("irregular")
    timer = StageTimer("cpu")
    bg.banded_solve_padded(plan, seeds, atol=ATOL, rtol=RTOL, converge="round", timer=timer)
    tot = timer.totals()
    assert 0.0 < tot["solve/residual"] <= tot["solve"]
    with span(None, "solve/residual"), stage(None, "solve"):
        pass


def test_traced_spans_do_not_overlap_in_an_irregular_plan():
    """navbench's Spans, given to the planner on an irregular plan, keep the
    host interval of every stage and no span: the intervals do not
    overlap, and the counters of the solve and the walk all move."""
    mesh, plan, seeds = _case("irregular")
    v = host_array(mesh, "vertices")
    rng = np.random.default_rng(11)
    starts, goals = (torch.from_numpy(v[rng.integers(0, len(v), LANES)].astype(np.float32))
                     for _ in range(2))
    planner = DijkstraPlanner(mesh, PlannerConfig(cost_limit=2.0), max_path_len=4 * N,
                              device="cpu")
    spans = devtrace.make_spans("cpu")
    before = dict(kernels.LAUNCHES)
    res = planner.plan_batch_banded(plan, starts, goals, timer=spans)
    assert res.converged
    names = {name for _, _, name in spans.host}
    assert {"snap", "solve", "pred", "extract", "pose"} <= names
    assert "solve/residual" in spans.totals() and "solve/residual" not in names
    intervals = sorted((a, b) for a, b, _ in spans.host)
    assert all(b0 <= a1 for (_, b0), (a1, _) in zip(intervals, intervals[1:]))
    for key in ("walk_steps", "walk_lane_steps", "banded_pass_rows"):
        assert kernels.LAUNCHES[key] > before[key], key
