"""Edge weights (port of mesh_navigation_tpu/ops/sweeps.py:32-100)."""

from __future__ import annotations

import numpy as np
import torch

from mesh_navigation_torch.mesh.arrays import MeshArrays, host_array


def compute_edge_weights(
    mesh: MeshArrays,
    vertex_costs: torch.Tensor,
    edge_cost_factor: float = 0.0,
) -> torch.Tensor:
    """Per-edge weights `w = dist + factor · dist · (c1 + c2) / 2`, +inf if
    either endpoint cost is infinite (MeshMap::computeEdgeWeights,
    mesh_map.cpp:517-561)."""
    edges = mesh.edges.long()
    c1 = vertex_costs[edges[:, 0]]
    c2 = vertex_costs[edges[:, 1]]
    dist = mesh.edge_dist
    w = dist + edge_cost_factor * dist * (c1 + c2) * 0.5
    return torch.where(torch.isinf(c1) | torch.isinf(c2), torch.inf, w)


def slot_weights_np(
    mesh: MeshArrays,
    vertex_costs: np.ndarray,
    cost_limit: float = 1.0,
    edge_cost_factor: float = 0.0,
) -> np.ndarray:
    """Host-side [V, D] pull-relaxation weight table: the edge weight of each
    adjacency slot, +inf for padded slots, for sources whose cost exceeds
    `cost_limit` (dijkstra_mesh_planner.cpp:302-303) and for invalid
    endpoints (:305-319)."""
    costs = np.asarray(vertex_costs, np.float32)
    edges = host_array(mesh, "edges")
    dist = host_array(mesh, "edge_dist")
    c1 = costs[edges[:, 0]]
    c2 = costs[edges[:, 1]]
    ew = dist + edge_cost_factor * dist * (c1 + c2) * 0.5
    ew = np.where(np.isinf(c1) | np.isinf(c2), np.inf, ew).astype(np.float32)

    adj_v = host_array(mesh, "adj_vertex")
    adj_e = host_array(mesh, "adj_edge")
    adj_m = host_array(mesh, "adj_mask")
    invalid = host_array(mesh, "invalid")
    w = ew[adj_e]
    blocked_src = (costs[adj_v] > cost_limit) | invalid[adj_v]
    usable = adj_m & ~blocked_src & ~invalid[:, None]
    return np.where(usable, w, np.inf).astype(np.float32)
