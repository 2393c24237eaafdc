"""Fixtures of the benchmark's tests: small copies of the cells' configurations
and mixes for the CPU, and the card where there is one."""

import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def small(cell_name: str, n: int = 32, lanes: int = 16) -> dict:
    """A cell's configuration on an n x n map and its mix at `lanes` lanes,
    its limits as committed."""
    from navbench import spec

    bench = spec.benchmark(ROOT)
    cell = spec.cell(bench, cell_name)
    config = copy.deepcopy(spec.config(bench, cell["config"], ROOT))
    config["name"] = f"{config['name']}_test{n}"
    config["map"]["params"].update(nx=n, ny=n)
    config["max_path_len"] = 4 * n
    mix = copy.deepcopy(spec.traffic(cell["traffic"]))
    mix["lanes"] = lanes
    mix["sample"] = 12
    return {"bench": bench, "cell": cell, "config": config, "mix": mix,
            "limits": spec.limits(cell_name)}


@pytest.fixture
def cache_root(tmp_path, monkeypatch):
    """A checkout root whose map cache is a temporary directory."""
    from navbench import maps

    monkeypatch.setattr(maps, "CACHE_DIR", str(tmp_path / "cache"))
    return ROOT


@pytest.fixture
def card():
    """The CUDA card; the test skips where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
