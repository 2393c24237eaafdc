"""What every comparison that decides `correct` shares: the plain
reference of the map and its layer stack, worked out again from the map
file, and the widest gaps between the program's answers and it.

Every number a kind's comparison (kinds/<kind>.py `numbers`) reads is a
widest gap over what was compared; `correct` holds where each number lies
within its limit (limits/<cell>.json). Among them:

- cost_gap: the largest |program - reference| of a vertex's combined cost
  (the layer stack on the map), over the vertices neither side marks
  lethal; inf where they differ on which are lethal.
- field_gap: the largest |program - reference| of a compared lane's field
  over the map, in units of the solve's stated tolerance
  (atol + rtol * |reference|).
- reach_errors: vertices reached on one side only, summed over the lanes.
- walk_excess: of the walked path from the start's vertex, its cost under
  the reference's edge weights over the reference's distance, less 1; inf
  where it is no chain of edges from the start's nearest vertex to the
  goal's.
"""

from __future__ import annotations

import math

import numpy as np

from . import spec
from .reference.field import Graph
from .reference.mesh import RefMesh, read_ply


class Reference:
    """The map and its layer stack as the reference works them out. Each
    layer's kind is reference/costlayers/<kind>.py's `compute(ref, layer,
    done, ctx)`, given the layers computed before it (`done`)."""

    def __init__(self, map_file: str, config: dict, root: str = spec.ROOT):
        self.mesh = RefMesh(*read_ply(map_file))
        self.config, self.root = config, root
        self._cache: dict = {}

    def cached(self, key: str, make):
        if key not in self._cache:
            self._cache[key] = make()
        return self._cache[key]

    def stack(self, **ctx) -> np.ndarray:
        """The configuration's combined costs. `ctx` is what the traffic
        adds to the map (such as an obstacle layer's lethal set), and
        `bf16=True` asks for the comparison's control."""
        done: dict[str, np.ndarray] = {}
        for layer in self.config["layers"]:
            kind = spec.part("reference/costlayers", layer["kind"], self.root)
            done[layer["name"]] = kind.compute(self, layer, done, ctx)
        return done[self.config["default_layer"]]

    def graph(self, costs: np.ndarray) -> Graph:
        return Graph(self.mesh, costs, self.config["edge_cost_factor"],
                     self.config["cost_limit"])


def program_order(ref: RefMesh, prog_vertices: np.ndarray) -> np.ndarray:
    """perm[v]: the reference's id of the program's vertex v (the program
    may reorder the map's vertices at load)."""
    perm = ref.vertex_at(prog_vertices)
    if (perm < 0).any() or len(np.unique(perm)) != ref.V:
        raise AssertionError("the program's vertices are not the map file's")
    return perm


def unpad(col: np.ndarray, perm: np.ndarray, n_cols: int, n_cols_pad: int) -> np.ndarray:
    """A lane's padded field column [Rp * Cp] as [V] in the reference's order."""
    v = np.arange(len(perm))
    out = np.empty(len(perm), np.float64)
    out[perm] = col[(v // n_cols) * n_cols_pad + v % n_cols]
    return out


def cost_gap(got: np.ndarray, want: np.ndarray) -> float:
    both = np.isfinite(got) & np.isfinite(want)
    if not np.array_equal(np.isfinite(got), np.isfinite(want)):
        return math.inf
    return float(np.abs(got[both].astype(np.float64) - want[both]).max()) if both.any() else 0.0


def field_gap(got: np.ndarray, want: np.ndarray, atol: float, rtol: float) -> tuple[float, int]:
    """(largest gap in tolerance units over vertices both reach, vertices
    reached on one side only)."""
    fg, fw = np.isfinite(got), np.isfinite(want)
    both = fg & fw
    gap = np.abs(got[both] - want[both]) / (atol + rtol * np.abs(want[both]))
    return (float(gap.max()) if both.any() else 0.0), int((fg != fw).sum())


def walk_excess(ref: RefMesh, graph: Graph, dist: np.ndarray, rec: dict, start_v: int,
                goal_v: int) -> float:
    """The walked path's cost under the reference's weights over the
    reference's distance of its start, less 1."""
    pts = rec["path"][rec["valid"]]
    if not np.isfinite(dist[start_v]):
        return 0.0 if len(pts) == 0 else math.inf
    ids = ref.vertex_at(pts)
    if len(ids) == 0 or (ids < 0).any() or ids[0] != start_v or ids[-1] != goal_v:
        return math.inf
    if len(ids) == 1:
        return 0.0 if dist[start_v] == 0.0 else math.inf
    e = ref.edge_index(ids[:-1], ids[1:])
    if (e < 0).any():
        return math.inf
    cost = float(graph.w[e].astype(np.float64).sum())
    return cost / max(float(dist[start_v]), 1e-12) - 1.0
