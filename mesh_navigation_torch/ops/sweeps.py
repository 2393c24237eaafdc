"""Edge weights, the Jacobi shortest-path field and its products (port of
mesh_navigation_tpu/ops/sweeps.py): the slot-weight table, the goal-seeded
field of pull-relaxation sweeps (the fixed point of the reference's heap
Dijkstra, dijkstra_mesh_planner.cpp:287-348), the per-vertex direction
field of a predecessor map, the predecessor walk and its cost."""

from __future__ import annotations

from typing import NamedTuple

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


def slot_weights(
    mesh: MeshArrays,
    edge_weights: torch.Tensor,
    vertex_costs: torch.Tensor,
    cost_limit: float = 1.0,
) -> torch.Tensor:
    """[V, D] pull-relaxation weight table on the device (sweeps.py:49-68):
    the edge weight of each adjacency slot, +inf for padded slots, for
    sources whose cost exceeds `cost_limit` and for invalid endpoints."""
    w = edge_weights[mesh.adj_edge.long()]
    src = mesh.adj_vertex.long()
    blocked_src = (vertex_costs[src] > cost_limit) | mesh.invalid[src]
    usable = mesh.adj_mask & ~blocked_src & ~mesh.invalid[:, None]
    return torch.where(usable, w, torch.inf)


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


class FieldResult(NamedTuple):
    """Potential field + predecessor map of a seeded sweep solve."""
    dist: torch.Tensor   # [V] f32 geodesic potential (inf = unreached)
    pred: torch.Tensor   # [V] i32 predecessor vertex (self = none)
    sweeps: int          # relaxation sweeps run
    converged: bool


def shortest_path_field(
    mesh: MeshArrays,
    weights_vd: torch.Tensor,
    seed_vertex,
    *,
    max_sweeps: int = 0,
    block_sweeps: int = 8,
) -> FieldResult:
    """Single-source shortest paths by Jacobi sweeps (sweeps.py:111-162):
    every vertex takes min(dist[v], min_u dist[u] + w(u, v)) over its [V, D]
    slot table at once, with the predecessor of the lowest winning slot.
    `weights_vd` is slot_weights' table; `seed_vertex` the goal vertex (the
    reference seeds at the goal, dijkstra_mesh_planner.cpp:80-81). Sweeps
    run in blocks of `block_sweeps`, one host read of the change flag a
    block, until a block changes nothing or `max_sweeps` (0: 4 V)."""
    V = weights_vd.shape[0]
    dev = weights_vd.device
    if max_sweeps <= 0:
        max_sweeps = 4 * V
    cap = -(-max_sweeps // block_sweeps) * block_sweeps
    vidx = torch.arange(V, device=dev)
    adj = mesh.adj_vertex.long()
    w = weights_vd.to(torch.float32)
    dist = torch.where(vidx == torch.as_tensor(seed_vertex, device=dev), 0.0, torch.inf)
    pred = vidx
    sweeps, changed = 0, True
    while changed and sweeps < cap:
        before = dist
        for _ in range(block_sweeps):
            best, arg = torch.min(dist[adj] + w, dim=1)
            improved = best < dist
            dist = torch.where(improved, best, dist)
            pred = torch.where(improved, adj[vidx, arg], pred)
        sweeps += block_sweeps
        changed = bool((dist < before).any())
    return FieldResult(dist=dist, pred=pred.to(torch.int32), sweeps=sweeps,
                       converged=not changed)


def _unit_toward(vertices: torch.Tensor, p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """normalize(pos[p] - pos[v]), zero where p == v."""
    d = vertices[p] - vertices[v]
    n = torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    unit = d / torch.clamp(n, min=1e-12)
    return torch.where((p != v)[..., None], unit, 0.0)


def vector_map_from_predecessors(mesh: MeshArrays, pred: torch.Tensor) -> torch.Tensor:
    """Per-vertex unit direction toward the predecessor, [..., V, 3] for a
    pred map [..., V] (DijkstraMeshPlanner::computeVectorMap,
    dijkstra_mesh_planner.cpp:189-209): zero where pred[v] == v."""
    vidx = torch.arange(mesh.num_vertices, device=pred.device)
    return _unit_toward(mesh.vertices, pred.long(), vidx)


def vector_rows_from_predecessors(
    mesh: MeshArrays, pred: torch.Tensor, vids: torch.Tensor
) -> torch.Tensor:
    """vector_map_from_predecessors at `vids` only: pred [B, V], vids [B, K]
    -> [B, K, 3]; the [B, V, 3] field is never built."""
    vids = vids.long()
    p = pred.gather(1, vids).long()
    return _unit_toward(mesh.vertices, p, vids)


def extract_path(
    pred: torch.Tensor,        # [B, V] predecessor ids
    start_v: torch.Tensor,     # [B]
    goal_v: torch.Tensor,      # [B]
    max_len: int,
    *,
    chunk: int = 256,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Follow each lane's predecessor chain from its start (sweeps.py:195-219):
    the walk stops after v == goal or pred[v] == v. Returns (path [B, max_len]
    i64, valid [B, max_len] bool); dead steps repeat the terminal vertex with
    valid False. Chunks of `chunk` steps, with one host check of any(alive)
    before each chunk."""
    dev = start_v.device
    B = start_v.shape[0]
    lane = torch.arange(B, device=dev)
    n_chunks = -(-max_len // chunk)
    L1 = n_chunks * chunk
    v = start_v.long().clone()
    goal = goal_v.long()
    alive = torch.ones(B, dtype=torch.bool, device=dev)
    path = v[None, :].repeat(L1, 1)
    valid = torch.zeros((L1, B), dtype=torch.bool, device=dev)
    for j in range(n_chunks):
        if not bool(alive.any()):
            break
        for i in range(j * chunk, (j + 1) * chunk):
            path[i] = v
            valid[i] = alive
            nxt = pred[lane, v].long()
            alive = alive & (v != goal) & (nxt != v)
            v = torch.where(alive, nxt, v)
    fill = torch.where(valid, path, v[None, :])
    return fill[:max_len].T, valid[:max_len].T


def path_cost(vertices: torch.Tensor, path: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Sum of the Euclidean segment lengths along padded paths [..., L]
    (sweeps.py:222-231)."""
    pts = vertices[path.long()]
    seg = torch.linalg.vector_norm(pts[..., 1:, :] - pts[..., :-1, :], dim=-1)
    return torch.sum(torch.where(valid[..., 1:] & valid[..., :-1], seg, 0.0), dim=-1)
