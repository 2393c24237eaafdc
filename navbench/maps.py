"""The configurations' maps: made once by the generator the configuration
names (mapgen/<generator>.py), written as a binary PLY file to the
benchmark's cache inside the checkout, then loaded by every run the way
the configuration names (loaders/<load>.py), as a robot's map server reads
a map file.

The file's name holds the configuration's name and a hash of its
generator and parameters, so a changed configuration makes a new file.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np

from . import spec

CACHE_DIR = ".navbench_cache"   # under the checkout's root; gitignored


def map_path(root: str, config: dict) -> str:
    key = hashlib.sha1(json.dumps(config["map"], sort_keys=True).encode()).hexdigest()[:12]
    return os.path.join(root, CACHE_DIR, "maps", f"{config['name']}-{key}.ply")


def write_ply(path: str, v: np.ndarray, f: np.ndarray) -> None:
    """A binary little-endian PLY of f32 vertices and uchar-counted int32
    triangles, written to a temporary name and renamed into place."""
    rec = np.dtype([("n", "u1"), ("i", "<i4", (3,))])
    faces = np.empty(len(f), rec)
    faces["n"], faces["i"] = 3, f
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as fh:
        fh.write((f"ply\nformat binary_little_endian 1.0\nelement vertex {len(v)}\n"
                  "property float x\nproperty float y\nproperty float z\n"
                  f"element face {len(f)}\nproperty list uchar int vertex_indices\n"
                  "end_header\n").encode())
        fh.write(np.ascontiguousarray(v, "<f4").tobytes())
        fh.write(faces.tobytes())
    os.replace(tmp, path)


def ensure_map(root: str, config: dict) -> str:
    """The configuration's map file, made first where it is missing by
    mapgen/<generator>.py's `make(**params) -> (vertices, faces)`."""
    path = map_path(root, config)
    if not os.path.exists(path):
        m = config["map"]
        v, f = spec.part("mapgen", m["generator"], root).make(**m["params"])
        write_ply(path, v, f)
    return path


def load_mesh(root: str, path: str, config: dict, device):
    """The map as the program loads it: loaders/<load>.py's
    `load(path, device)`."""
    return spec.part("loaders", config["map"]["load"], root).load(path, device)


def build_server(mesh, config: dict, device):
    """The navigation server of the configuration: its layer stack, planner
    kind, cost limit, edge cost factor, path length and any further
    planner parameters (`planner_params`)."""
    from mesh_navigation_torch.api.server import MeshNavServer
    from mesh_navigation_torch.config import (
        ControllerConfig, LayerConfig, MeshMapConfig, NavConfig, PlannerConfig,
    )

    layers = tuple(
        LayerConfig(name=l["name"], kind=l["kind"], inputs=tuple(l.get("inputs", ())),
                    params=tuple((k, float(v)) for k, v in l.get("params", {}).items()))
        for l in config["layers"])
    nav = NavConfig(
        mesh_map=MeshMapConfig(default_layer=config["default_layer"],
                               edge_cost_factor=config["edge_cost_factor"]),
        planner=PlannerConfig(cost_limit=config["cost_limit"],
                              **config.get("planner_params", {})),
        controller=ControllerConfig(**config["controller"]),
        layers=layers,
    )
    return MeshNavServer(mesh, nav, planner_kind=config["planner"],
                         max_path_len=config["max_path_len"], device=device)
