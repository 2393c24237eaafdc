"""Finding the parts of a cell by name.

A cell of BENCHMARK.json names a configuration (configs/<config>.json, or
the `file` its configs entry gives) and a traffic mix
(traffic/<traffic>.json); its limits for `correct` are limits/<cell>.json.
Code is found by the names those files give, each in a file of its own:

- kinds/<kind>.py: a mix's `kind`, its traffic generator, its driver and
  the numbers its comparison reads;
- mapgen/<generator>.py and loaders/<load>.py: a configuration's map
  generator and the way the program loads the map file;
- reference/costlayers/<kind>.py: the reference of a layer kind of the
  configuration's stack;
- metrics/<metric>.py: a per-layer metric's `read(trace)`, which returns
  the number or None.

Every lookup is under the checkout's root, so a new configuration, mix,
kind, layer, cell or metric is new files and entries: nothing here or in
another file that is there changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
PACKAGE = os.path.basename(HERE)
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")
_loaded: dict[str, object] = {}


def load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def path_of(folder: str, name: str, suffix: str, root: str = ROOT) -> str:
    """navbench/<folder>/<name><suffix> under root; the name may hold no
    slash or space."""
    if not NAME.match(name):
        raise ValueError(f"{name!r} is not a name")
    return os.path.join(root, PACKAGE, folder, name + suffix)


def part(folder: str, name: str, root: str = ROOT):
    """The module navbench/<folder>/<name>.py under root, loaded once."""
    path = path_of(folder, name, ".py", root)
    if path not in _loaded:
        if not os.path.exists(path):
            raise KeyError(f"no {folder} part named {name!r} ({path})")
        key = re.sub(r"\W", "_", f"navbench_part_{folder}_{name}_{len(_loaded)}")
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _loaded[path] = mod
    return _loaded[path]


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                   f"(have {[w['name'] for w in bench['workloads']]})")


def config(bench: dict, name: str, root: str = ROOT) -> dict:
    entry = next((c for c in bench["configs"] if c["name"] == name), None)
    if entry is not None:
        return load_json(os.path.join(root, entry["file"]))
    return load_json(path_of("configs", name, ".json", root))


def traffic(name: str, root: str = ROOT) -> dict:
    return load_json(path_of("traffic", name, ".json", root))


def limits(cell_name: str, root: str = ROOT) -> dict:
    return load_json(path_of("limits", cell_name, ".json", root))


def kind(mix: dict, root: str = ROOT):
    """The module of a traffic mix's kind."""
    return part("kinds", mix["kind"], root)


def metrics_of(bench: dict, cell_name: str, group: str) -> list[dict]:
    """The cell's metrics of `group` ("end_to_end" or "per_layer"): those
    that list it, or list no cells and move an end-to-end metric it
    reports."""
    e2e = {m["name"] for m in bench["end_to_end"]
           if "workloads" not in m or cell_name in m["workloads"]}
    out = []
    for m in bench[group]:
        if "workloads" in m:
            if cell_name in m["workloads"]:
                out.append(m)
        elif group == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


def reader(metric: str, root: str = ROOT):
    """The `read(trace)` of metrics/<metric>.py."""
    return part("metrics", metric, root).read
