"""run.py's boundaries: no card, no result; rates over all the window's
work; the control at the cell's own size on the card."""

import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from conftest import ROOT, small
from navbench import drivers, harness, spec

CELLS = [w["name"] for w in spec.benchmark(ROOT)["workloads"]]


def test_without_a_card_it_exits_nonzero_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "navbench/run.py", "--workload", "grid1m.fleet4096",
                          "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_the_reservoir_keeps_a_uniform_sample():
    rng = np.random.default_rng(1)
    hits = np.zeros(50)
    for _ in range(2000):
        keep = drivers.Reservoir(5, rng)
        for i in range(50):
            j = keep.slot()
            if j is not None:
                keep.items[j] = i
        hits[keep.items] += 1
    assert len(keep.items) == 5
    assert np.abs(hits / 2000 - 0.1).max() < 0.03


@pytest.mark.parametrize("cell_name", CELLS)
def test_rates_cover_every_step_of_the_window(cell_name, cache_root):
    s = small(cell_name)
    setup = harness.Setup(s["config"], s["mix"], torch.device("cpu"), cache_root)
    drv = setup.driver(2**31 + 7)
    t = time.perf_counter()
    out = drv.window(0.5)
    wall = time.perf_counter() - t
    assert 0.5 <= out["window_s"] <= wall
    assert out["attempted"] == out["steps"] * s["mix"]["lanes"]
    assert out["e2e"]["solves_per_s"] == pytest.approx(out["attempted"] / out["window_s"])
    assert len(out["rounds"]) == out["steps"]


@pytest.mark.gpu
@pytest.mark.parametrize("cell_name", CELLS)
def test_the_control_fails_at_the_cells_own_size(cell_name, card):
    """The program's bfloat16 fields, at the cell's size, on three seeds."""
    from navbench import compare

    bench = spec.benchmark(ROOT)
    cell = spec.cell(bench, cell_name)
    config, mix = spec.config(bench, cell["config"], ROOT), spec.traffic(cell["traffic"])
    limits = spec.limits(cell_name)
    setup = harness.Setup(config, mix, card, ROOT)
    ref = compare.Reference(setup.path, config)
    for seed in (2**31 + 11, 2**31 + 12, 2**31 + 13):
        drv = setup.driver(seed, control="bf16")
        drv.warm(1)
        answers = setup.answers(drv.window(5.0))
        correct, checks = harness.judge(harness.numbers(setup, answers, ref), limits)
        assert not correct, checks
