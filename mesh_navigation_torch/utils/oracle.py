"""Sequential CPU oracles (port of mesh_navigation_tpu/utils/oracle.py): the
reference planners' priority-queue wavefronts, re-implemented independently
in numpy and heapq as the correctness and path-cost baseline.

dijkstra_oracle (dijkstra_mesh_planner.cpp:217-398), cvp_oracle
(cvp_mesh_planner.cpp:651-970) and inflation_oracle
(inflation_layer.cpp:341-491) validate the port's solves vertex by vertex on
the same meshes (BASELINE.md: "within 1% path cost"); mesh_adjacency and
mesh_vertex_faces read their lists off a MeshArrays bundle on any device.
"""

from __future__ import annotations

import heapq
import math

import numpy as np

from mesh_navigation_torch.mesh.arrays import host_array


def dijkstra_oracle(
    num_vertices: int,
    adj: list[list[tuple[int, int]]],  # adj[v] = [(neighbor, edge_id), ...]
    edge_weights: np.ndarray,
    vertex_costs: np.ndarray,
    seed: int,
    cost_limit: float = 1.0,
) -> tuple[np.ndarray, np.ndarray]:
    """Heap Dijkstra with the reference's popped-vertex cost skip
    (dijkstra_mesh_planner.cpp:287-348). Returns (dist, pred)."""
    dist = np.full(num_vertices, np.inf, dtype=np.float64)
    pred = np.arange(num_vertices)
    fixed = np.zeros(num_vertices, dtype=bool)
    dist[seed] = 0.0
    pq: list[tuple[float, int]] = [(0.0, seed)]
    while pq:
        d, v = heapq.heappop(pq)
        if fixed[v]:
            continue
        fixed[v] = True
        if vertex_costs[v] > cost_limit:
            continue
        for u, e in adj[v]:
            if fixed[u]:
                continue
            nd = dist[v] + edge_weights[e]
            if nd < dist[u]:
                dist[u] = nd
                pred[u] = v
                heapq.heappush(pq, (nd, u))
    return dist, pred


def _unfolding_update(u1, u2, a, b, c):
    """Scalar CVP triangle update (cvp_mesh_planner.cpp:369-556 semantics).

    Returns (candidate, pred_is_v1, theta) or None when no update applies.
    """
    sx = (c * c + u1 * u1 - u2 * u2) / (2 * c)
    sy = -math.sqrt(max(u1 * u1 - sx * sx, 0.0))
    p = (b * b + c * c - a * a) / (2 * c)
    hc = math.sqrt(max(b * b - p * p, 0.0))
    dx, dy = p - sx, hc - sy
    u3_sq = dx * dx + dy * dy
    u3 = math.sqrt(u3_sq)
    t0a = (a * a + b * b - c * c) / (2 * a * b)
    t1a = (u3_sq + b * b - u1 * u1) / (2 * u3 * b) if u3 > 0 else 2.0
    t2a = (a * a + u3_sq - u2 * u2) / (2 * a * u3) if u3 > 0 else 2.0
    if abs(t1a) > 1:
        return u1 + b, True, 0.0
    if abs(t2a) > 1:
        return u2 + a, False, 0.0
    th0 = math.acos(max(-1.0, min(1.0, t0a)))
    th1 = math.acos(max(-1.0, min(1.0, t1a)))
    th2 = math.acos(max(-1.0, min(1.0, t2a)))
    if th1 < th0 and th2 < th0:
        if th1 < th2:
            return u3, True, th1
        return u3, False, -th2
    if th1 < th2:
        return u1 + b, True, 0.0
    return u2 + a, False, 0.0


def cvp_oracle(
    faces: np.ndarray,
    face_edges: np.ndarray,
    vertex_faces: list[list[int]],
    edge_weights: np.ndarray,
    vertex_costs: np.ndarray,
    seed_vertices: list[int],
    seed_dists: list[float],
    cost_limit: float = 1.0,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Heap-ordered fast marching with the CVP unfolding update.

    Mirrors waveFrontPropagation (cvp_mesh_planner.cpp:747-886): pop-min,
    fix, per incident face with exactly one free vertex run the update.
    Returns (dist, pred, theta, cutting_face).
    """
    V = len(vertex_faces)
    dist = np.full(V, np.inf)
    pred = np.arange(V)
    theta = np.zeros(V)
    cutting = np.full(V, -1, dtype=np.int64)
    fixed = np.zeros(V, dtype=bool)
    pq: list[tuple[float, int]] = []
    for v, d in zip(seed_vertices, seed_dists):
        dist[v] = d
        fixed[v] = True
        heapq.heappush(pq, (d, v))

    def side(f: int, corner: int) -> float:
        return edge_weights[face_edges[f, corner]]

    while pq:
        d, v = heapq.heappop(pq)
        fixed[v] = True
        if vertex_costs[v] >= cost_limit:
            continue
        for f in vertex_faces[v]:
            corners = faces[f]
            fx = fixed[corners]
            if fx.sum() != 2:
                continue
            k = int(np.argmin(fx))  # the free corner
            v3 = int(corners[k])
            if vertex_costs[v3] >= cost_limit:
                continue
            v1 = int(corners[(k + 1) % 3])
            v2 = int(corners[(k + 2) % 3])
            c = side(f, k)
            b = side(f, (k + 2) % 3)
            a = side(f, (k + 1) % 3)
            res = _unfolding_update(dist[v1], dist[v2], a, b, c)
            if res is None:
                continue
            cand, pred_is_v1, th = res
            if cand < dist[v3]:
                dist[v3] = cand
                pred[v3] = v1 if pred_is_v1 else v2
                theta[v3] = th
                cutting[v3] = f
                heapq.heappush(pq, (cand, v3))
    return dist, pred, theta, cutting


def _sethian_update(d1, d2, a, b, dot, F=1.0, eps=1e-7):
    """Scalar Sethian update (inflation_layer.cpp:181-234 semantics)."""
    t = math.inf
    r_cos = dot
    r_sin = math.sqrt(max(1 - dot * dot, 0.0))
    u = d2 - d1
    f2 = a * a + b * b - 2 * a * b * r_cos
    f1 = b * u * (a * r_cos - b)
    f0 = b * b * (u * u - F * F * a * a * r_sin * r_sin)
    delta = f1 * f1 - f0 * f2
    if delta >= 0:
        if abs(f2) > eps:
            t = (-f1 - math.sqrt(delta)) / f2
            if t < u or (t != 0 and b * (t - u) / t < a * r_cos) or (
                r_cos != 0 and a / r_cos < b * (t - u) / 2
            ):
                t = (-f1 + math.sqrt(delta)) / f2
            else:
                t = -f0 / f1 if f1 != 0 else -math.inf
    else:
        t = -math.inf
    if (
        u < t
        and t != 0
        and a * r_cos < b * (t - u) / t
        and r_cos != 0
        and b * (t - u) / t < a / r_cos
    ):
        return t + d1
    return min(b * F + d1, a * F + d2)


def inflation_oracle(
    faces: np.ndarray,
    face_edges: np.ndarray,
    vertex_faces: list[list[int]],
    edge_dist: np.ndarray,
    lethal: np.ndarray,
    max_distance: float,
) -> np.ndarray:
    """Heap-ordered geodesic distance from lethal seeds via Sethian updates —
    mirrors waveCostInflation (inflation_layer.cpp:341-491). Returns dist."""
    V = len(vertex_faces)
    dist = np.full(V, np.inf)
    fixed = np.zeros(V, dtype=bool)
    pq: list[tuple[float, int]] = []
    for v in np.flatnonzero(lethal):
        dist[v] = 0.0
        heapq.heappush(pq, (0.0, int(v)))

    def side(f, corner):
        return edge_dist[face_edges[f, corner]]

    while pq:
        d, v = heapq.heappop(pq)
        fixed[v] = True
        for f in vertex_faces[v]:
            corners = faces[f]
            fx = fixed[corners]
            if fx.sum() != 2:
                continue
            k = int(np.argmin(fx))
            v3 = int(corners[k])
            if dist[v3] == 0:
                continue
            v1 = int(corners[(k + 1) % 3])
            v2 = int(corners[(k + 2) % 3])
            c = side(f, k)
            b = side(f, (k + 2) % 3)
            a = side(f, (k + 1) % 3)
            dot = (a * a + b * b - c * c) / (2 * a * b)
            cand = _sethian_update(dist[v1], dist[v2], a, b, dot)
            if not math.isfinite(cand):
                continue
            if cand < dist[v3]:
                dist[v3] = cand
                if dist[v1] <= max_distance and dist[v2] <= max_distance:
                    heapq.heappush(pq, (cand, v3))
    return dist


def mesh_adjacency(mesh) -> list[list[tuple[int, int]]]:
    """Build the oracle adjacency list from a MeshArrays bundle."""
    adj_v = host_array(mesh, "adj_vertex")
    adj_e = host_array(mesh, "adj_edge")
    mask = host_array(mesh, "adj_mask")
    return [
        [(int(adj_v[v, j]), int(adj_e[v, j])) for j in range(adj_v.shape[1]) if mask[v, j]]
        for v in range(adj_v.shape[0])
    ]


def mesh_vertex_faces(mesh) -> list[list[int]]:
    vf = host_array(mesh, "vertex_faces")
    m = host_array(mesh, "vertex_faces_mask")
    return [
        [int(vf[v, j]) for j in range(vf.shape[1]) if m[v, j]]
        for v in range(vf.shape[0])
    ]
