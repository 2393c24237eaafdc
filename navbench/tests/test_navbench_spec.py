"""Configurations, mixes, kinds, map generators, loaders, reference layers,
limits and metrics are found by name, and a new one is picked up without
an edit to a file that is there."""

import json
import os
import shutil
import time

import numpy as np
import pytest
import torch

from conftest import ROOT
from navbench import compare, harness, maps, spec


def test_every_cell_finds_its_parts():
    bench = spec.benchmark(ROOT)
    for w in bench["workloads"]:
        cfg = spec.config(bench, w["config"], ROOT)
        assert cfg["name"] == w["config"]
        kind = spec.kind(spec.traffic(w["traffic"]))
        assert all(hasattr(kind, a) for a in ("Traffic", "Driver", "numbers"))
        assert callable(spec.part("mapgen", cfg["map"]["generator"]).make)
        assert callable(spec.part("loaders", cfg["map"]["load"]).load)
        for layer in cfg["layers"]:
            assert callable(spec.part("reference/costlayers", layer["kind"]).compute)
        assert spec.limits(w["name"])
        for m in spec.metrics_of(bench, w["name"], "per_layer"):
            assert callable(spec.reader(m["name"]))
    names = {m["name"] for m in bench["per_layer"]}
    assert names <= {f[:-3] for f in os.listdir(os.path.join(spec.HERE, "metrics"))
                     if f.endswith(".py")}


def test_each_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    bench = spec.benchmark(ROOT)
    for w in bench["workloads"]:
        e2e = {m["name"] for m in spec.metrics_of(bench, w["name"], "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = spec.metrics_of(bench, w["name"], "per_layer")
        assert layer and all(m["moves"] in e2e for m in layer)


def checkout_copy(tmp_path):
    """A checkout's root with the benchmark's files as they are."""
    root = tmp_path / "checkout"
    shutil.copytree(spec.HERE, root / spec.PACKAGE,
                    ignore=shutil.ignore_patterns("tests", "__pycache__", ".navbench_cache"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root / "BENCHMARK.json")
    return root


KIND = '''"""A kind for the test: each step plans `lanes` robots between random
vertices with get_path_batch."""
import time
import numpy as np
from navbench import compare


class Traffic:
    def __init__(self, mix, vertices, faces, seed):
        self.v, self.n = vertices, mix["lanes"]
        self.rng = np.random.default_rng([seed, 5])

    def draw(self):
        return self.v[self.rng.integers(0, len(self.v), (2, self.n))]


class Driver:
    def __init__(self, server, traffic, mix, device, seed, control=None):
        self.srv, self.gen, self.device = server, traffic, device

    def step(self):
        import torch
        s, g = (torch.from_numpy(x).to(self.device) for x in self.gen.draw())
        return self.srv.get_path_batch(s, g)

    def warm(self, n):
        for _ in range(n):
            self.step()

    def window(self, seconds, timer=None):
        t0, steps, rounds, reached = time.perf_counter(), 0, [], 0
        while True:
            res = self.step()
            rounds.append(int(res.rounds))
            reached += int((res.outcome == 0).sum())
            steps += 1
            if time.perf_counter() - t0 >= seconds:
                break
        w = time.perf_counter() - t0
        n = steps * self.gen.n
        return {"steps": steps, "window_s": w, "attempted": n, "failed": n - reached,
                "rounds": rounds, "records": [], "e2e": {"plans_per_s": n / w}}


def numbers(ref, answers, mix, config):
    perm = compare.program_order(ref.mesh, answers["vertices"])
    prog = np.empty(ref.mesh.V, np.float32)
    prog[perm] = answers["costs"]
    return {"cost_gap": compare.cost_gap(prog, ref.stack())}
'''

MAPGEN = '''"""A tilted grid for the test."""


def make(*, nx, ny, tilt):
    from mesh_navigation_torch.mesh import synthetic
    v, f = synthetic.terrain_mesh(nx, ny, spacing=0.5, hills=0.0, roughness=0.0, seed=0)
    v = v.copy()
    v[:, 2] += tilt * v[:, 0]
    return v, f
'''

LOADER = '''"""The map file read without read_map's extras, for the test."""


def load(path, device):
    from mesh_navigation_torch.mesh import arrays, io
    v, f = io.import_mesh_file(path)
    return arrays.build_mesh(v, f, device=device)
'''


def test_a_new_kind_map_loader_mix_metric_and_cell_are_picked_up(tmp_path, monkeypatch):
    root = checkout_copy(tmp_path)
    here = root / spec.PACKAGE
    before = {p: p.read_bytes() for p in here.rglob("*") if p.is_file()}
    (here / "kinds" / "tally.py").write_text(KIND)
    (here / "mapgen" / "tilted.py").write_text(MAPGEN)
    (here / "loaders" / "plain.py").write_text(LOADER)
    (here / "metrics" / "steps.tally.py").write_text(
        "def read(trace):\n    return float(trace['steps'])\n")
    (here / "traffic" / "tally8.json").write_text(json.dumps(
        {"kind": "tally", "lanes": 8, "warmup": 1}))
    (here / "limits" / "tilted.tally8.json").write_text(json.dumps({"cost_gap": 1e-5}))
    cfg = dict(spec.config(spec.benchmark(ROOT), "grid1m", ROOT), name="tilted",
               map={"generator": "tilted", "params": {"nx": 24, "ny": 24, "tilt": 0.2},
                    "load": "plain"}, max_path_len=96)
    (here / "configs" / "tilted.json").write_text(json.dumps(cfg))
    bench = spec.benchmark(str(root))
    bench["configs"].append({"name": "tilted", "source": "test", "reduced": [],
                             "file": f"{spec.PACKAGE}/configs/tilted.json", "why": "test"})
    bench["workloads"].append({"name": "tilted.tally8", "config": "tilted",
                               "traffic": "tally8", "chips": 1, "why": "test"})
    bench["end_to_end"].append({"name": "plans_per_s", "unit": "plans/s", "better": "higher",
                                "bound": 0.1, "source": "host_clock",
                                "workloads": ["tilted.tally8"]})
    bench["per_layer"].append({"name": "steps.tally", "unit": "steps", "better": "higher",
                               "source": "program_counter", "layer": "harness",
                               "moves": "plans_per_s", "workloads": ["tilted.tally8"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(maps, "CACHE_DIR", str(tmp_path / "cache"))

    r = str(root)
    bench = spec.benchmark(r)
    cell = spec.cell(bench, "tilted.tally8")
    res = harness.run_cell(cell=cell, config=spec.config(bench, "tilted", r),
                           mix=spec.traffic("tally8", r), limits=spec.limits(cell["name"], r),
                           seed=2**31 + 17, seconds=0.3, trace=False,
                           device=torch.device("cpu"), t_start=time.perf_counter(),
                           bench=bench, root=r)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"setup_s", "plans_per_s"}
    assert res["attempted"] > 0 and res["failed"] == 0
    assert [m["name"] for m in spec.metrics_of(bench, cell["name"], "per_layer")] == \
        ["steps.tally"]
    assert spec.reader("steps.tally", r)({"steps": 3}) == 3.0
    assert all(p.read_bytes() == b for p, b in before.items())   # no file edited


def test_a_new_reference_layer_kind_is_picked_up(tmp_path, monkeypatch):
    root = checkout_copy(tmp_path)
    (root / spec.PACKAGE / "reference" / "costlayers" / "halved.py").write_text(
        "def compute(ref, layer, done, ctx):\n"
        "    return done[layer['inputs'][0]] * 0.5\n")
    monkeypatch.setattr(maps, "CACHE_DIR", str(tmp_path / "cache"))
    cfg = dict(spec.config(spec.benchmark(ROOT), "grid1m", ROOT), name="half")
    cfg["map"] = dict(cfg["map"], params=dict(cfg["map"]["params"], nx=16, ny=16))
    cfg["layers"] = [cfg["layers"][0], {"name": "half", "kind": "halved",
                                        "inputs": [cfg["layers"][0]["name"]]}]
    cfg["default_layer"] = "half"
    path = maps.ensure_map(str(root), cfg)
    ref = compare.Reference(path, cfg, str(root))
    steep = spec.part("reference/costlayers", "steepness").compute(ref, {}, {}, {})
    np.testing.assert_array_equal(ref.stack(), steep * 0.5)


def test_unknown_parts_raise():
    with pytest.raises(KeyError):
        spec.cell(spec.benchmark(ROOT), "nope")
    with pytest.raises(KeyError):
        spec.part("kinds", "nope")
    with pytest.raises(ValueError):
        spec.part("kinds", "../harness")
