"""A run whose timed path is broken underneath comes out not correct: the
harness drives the rest of a run on the CPU (it skips the look for a card)
with one fault planted in the program, once for each fault the cells can
have, and a solve that misses its tolerance. (The cells run on one
card, so no exchange between cards can fail.)"""

import dataclasses
import time

import pytest
import torch

from conftest import small
from navbench import harness

SEED = 2**31 + 99


def run(cell_name, cache_root):
    s = small(cell_name, n=40)
    return harness.run_cell(cell=s["cell"], config=s["config"], mix=s["mix"],
                            limits=s["limits"], seed=SEED, seconds=1.5, trace=False,
                            device=torch.device("cpu"), t_start=time.perf_counter(),
                            bench=s["bench"], root=cache_root)


@pytest.fixture
def server_cls():
    from mesh_navigation_torch.api import server

    return server.MeshNavServer


def test_fleet_step_that_returns_its_last_answer(cache_root, server_cls, monkeypatch):
    orig, last = server_cls.get_path_batch, {}

    def stale(self, starts, goals, **kw):
        if "res" not in last:
            last["res"] = orig(self, starts, goals, **kw)
        return last["res"]

    monkeypatch.setattr(server_cls, "get_path_batch", stale)
    assert not run("grid1m.fleet4096", cache_root)["correct"]


def test_fleet_step_that_leaves_out_half_of_the_batch(cache_root, server_cls, monkeypatch):
    orig = server_cls.get_path_batch

    def half(self, starts, goals, **kw):
        B = starts.shape[0]
        res = orig(self, starts[: B // 2], goals[: B // 2], **kw)
        twice = lambda t: torch.cat([t, t])  # noqa: E731
        return dataclasses.replace(res, outcome=twice(res.outcome), path_positions=twice(res.path_positions),
                            path_quats=twice(res.path_quats), path_valid=twice(res.path_valid),
                            cost=twice(res.cost), lane_map=twice(res.lane_map))

    monkeypatch.setattr(server_cls, "get_path_batch", half)
    assert not run("grid1m.fleet4096", cache_root)["correct"]


def test_fleet_answer_altered_where_it_is_produced(cache_root, monkeypatch):
    from mesh_navigation_torch.ops import banded_gpu

    orig = banded_gpu.extract_paths_cls

    def nudged(*a, **kw):
        path, valid = orig(*a, **kw)
        return torch.where(valid & (torch.arange(path.shape[1]) == 1), path + 1, path), valid

    monkeypatch.setattr(banded_gpu, "extract_paths_cls", nudged)
    res = run("grid1m.fleet4096", cache_root)
    assert not res["correct"] and res["checks"]["walk_excess"]["value"] > 0


def test_fleet_field_not_written_back(cache_root, monkeypatch):
    from mesh_navigation_torch.ops import banded_gpu

    orig = banded_gpu.banded_solve_padded

    def unwritten(*a, **kw):
        res = orig(*a, **kw)
        res.d_pad.fill_(float("inf"))
        return res

    monkeypatch.setattr(banded_gpu, "banded_solve_padded", unwritten)
    res = run("grid1m.fleet4096", cache_root)
    assert not res["correct"] and res["checks"]["reach_errors"]["value"] > 0


def test_fleet_solve_that_misses_its_tolerance(cache_root, monkeypatch):
    """The solve runs out of rounds before a quiet round and says so."""
    from mesh_navigation_torch.ops import banded_gpu

    orig = banded_gpu.banded_solve_padded
    monkeypatch.setattr(banded_gpu, "banded_solve_padded",
                        lambda *a, **kw: dataclasses.replace(orig(*a, **kw), converged=False))
    res = run("grid1m.fleet4096", cache_root)
    assert not res["correct"] and res["checks"]["unconverged_steps"]["value"] > 0
