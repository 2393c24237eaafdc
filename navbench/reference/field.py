"""Edge weights from vertex costs and the goal-seeded geodesic fields over
them (MeshMap::computeEdgeWeights, mesh_map.cpp:517-561; the Dijkstra mesh
planner's relaxation, dijkstra_mesh_planner.cpp:217-398)."""

from __future__ import annotations

import numpy as np
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import dijkstra

from .mesh import RefMesh


def edge_weights(mesh: RefMesh, costs: np.ndarray, factor: float) -> np.ndarray:
    """w = len + factor * len * (c1 + c2) / 2 of each edge, f32; inf where
    either end's cost is."""
    c1, c2 = costs[mesh.e_lo], costs[mesh.e_hi]
    ln = mesh.edge_len
    with np.errstate(invalid="ignore"):
        w = ln + np.float32(factor) * ln * (c1 + c2) * np.float32(0.5)
    return np.where(np.isinf(c1) | np.isinf(c2), np.float32(np.inf), w).astype(np.float32)


class Graph:
    """The arcs a label can cross: src -> dst along an edge of finite weight
    whose source costs at most `cost_limit` (dijkstra_mesh_planner.cpp:
    302-303)."""

    def __init__(self, mesh: RefMesh, costs: np.ndarray, factor: float, cost_limit: float):
        self.mesh = mesh
        self.w = edge_weights(mesh, costs, factor)
        wa = self.w[mesh.arc_edge]
        ok = np.isfinite(wa) & ~(costs[mesh.arc_src] > cost_limit)
        self.usable = ok
        self.arc_w = np.where(ok, wa, np.inf)
        self.csr = csr_matrix((wa[ok].astype(np.float64), (mesh.arc_src[ok], mesh.arc_dst[ok])),
                              shape=(mesh.V, mesh.V))

    def fields(self, goals) -> np.ndarray:
        """[len(goals), V] f64 distances of each vertex from its lane's goal
        (inf where unreached)."""
        return np.atleast_2d(dijkstra(self.csr, directed=True, indices=np.asarray(goals)))

    def in_arcs(self, v: int):
        """(sources, weights) of the usable arcs into vertex v."""
        a, b = self.mesh.in_start[v], self.mesh.in_start[v + 1]
        return self.mesh.arc_src[a:b], self.arc_w[a:b]
