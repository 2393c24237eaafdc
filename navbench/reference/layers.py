"""What the reference's cost layers (costlayers/<kind>.py) share:
steepness, geodesic inflation and its fading, bfloat16 rounding
(naturerobots/mesh_navigation's mesh_layers: steepness_layer.cpp,
inflation_layer.cpp)."""

from __future__ import annotations

import numpy as np

from .mesh import RefMesh

INF = np.float32(np.inf)


def to_bf16(x: np.ndarray) -> np.ndarray:
    """f32 values rounded to the nearest bfloat16 (ties to even), as f32."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32)
    b = (b + np.uint32(0x7FFF) + ((b >> np.uint32(16)) & np.uint32(1))) & np.uint32(0xFFFF0000)
    return b.view(np.float32)


def steepness(mesh: RefMesh) -> np.ndarray:
    """acos(normal.z) of each vertex, f32 (steepness_layer.cpp:157-166)."""
    nz = np.clip(mesh.vertex_normals()[:, 2], np.float32(-1.0), np.float32(1.0))
    return np.arccos(nz).astype(np.float32)


def sethian(u1, u2, a, b, c):
    """The Sethian triangle update at the free vertex, f32, with the branch
    structure of InflationLayer::computeUpdateSethianMethod
    (inflation_layer.cpp:181-234): the root of f2 t^2 + 2 f1 t + f0 = 0 in
    the monotonicity window, else the edge relaxation min(b + u1, a + u2);
    inf unless both supports are finite."""
    f32 = np.float32
    eps, tiny = f32(1e-7), f32(1e-12)
    with np.errstate(all="ignore"):
        fin = np.isfinite(u1) & np.isfinite(u2)
        u1s = np.where(fin, u1, f32(0)).astype(f32)
        u2s = np.where(fin, u2, f32(0)).astype(f32)
        dot = (a * a + b * b - c * c) / np.maximum(f32(2) * a * b, tiny)
        r_cos = np.clip(dot, f32(-1), f32(1))
        r_sin = np.sqrt(np.maximum(f32(1) - r_cos * r_cos, f32(0)))
        u = u2s - u1s
        f2 = a * a + b * b - f32(2) * a * b * r_cos
        f1 = b * u * (a * r_cos - b)
        f0 = b * b * (u * u - a * a * r_sin * r_sin)
        delta = f1 * f1 - f0 * f2
        sq = np.sqrt(np.maximum(delta, f32(0)))
        f2s = np.where(np.abs(f2) > eps, f2, f32(1))
        t_minus = (-f1 - sq) / f2s
        t_plus = (-f1 + sq) / f2s
        big = np.abs(f1) > tiny
        t_ratio = np.where(big, -f0 / np.where(big, f1, f32(1)), f32(-np.inf))
        cos_s = np.where(np.abs(r_cos) > tiny, r_cos, tiny)
        t = t_minus
        t_div = np.maximum(np.abs(t), tiny) * np.sign(np.where(t == 0, f32(1), t))
        retry = (t < u) | (b * (t - u) / t_div < a * r_cos) | (a / cos_s < b * (t - u) / f32(2))
        t = np.where(retry, t_plus, t_ratio)
        t = np.where(np.abs(f2) > eps, t, f32(np.inf))
        t = np.where(delta >= 0, t, f32(-np.inf))
        t_div = np.where(np.abs(t) > tiny, t, tiny)
        window = (u < t) & (a * r_cos < b * (t - u) / t_div) & (b * (t - u) / t_div < a / cos_s)
        interior = t + u1s
        edge = np.minimum(b + u1s, a + u2s)
        value = np.where(window & np.isfinite(interior), interior, edge)
        return np.where(fin & np.isfinite(value), value, f32(np.inf)).astype(f32)


def inflation_distance(mesh: RefMesh, lethal: np.ndarray, radius: float,
                       rings: int = 3) -> np.ndarray:
    """Geodesic distance from the lethal set by the Sethian update over the
    raw edge lengths, proposals only from supports within `radius`
    (inflation_layer.cpp:341-491), to its fixed point; computed on the faces
    within `rings` edge rings of the set (a label within the radius lies
    one ring out, and its proposals one more), inf elsewhere."""
    d = np.full(mesh.V, INF, np.float32)
    d[lethal] = 0.0
    if not lethal.any():
        return d
    near = lethal.copy()
    for _ in range(rings):
        grow = np.zeros(mesh.V, bool)
        idx = np.nonzero(near)[0]
        for v in idx:
            grow[mesh.arc_src[mesh.in_start[v]:mesh.in_start[v + 1]]] = True
        near |= grow
    f = mesh.f[near[mesh.f].any(axis=1)]
    corner = []
    for k in range(3):
        v3, v1, v2 = f[:, k], f[:, (k + 1) % 3], f[:, (k + 2) % 3]
        a = mesh.edge_len[mesh.edge_index(v2, v3)]
        b = mesh.edge_len[mesh.edge_index(v1, v3)]
        c = mesh.edge_len[mesh.edge_index(v1, v2)]
        corner.append((v1, v2, v3, a, b, c))
    cap = np.float32(radius)
    for _ in range(1000):
        best = d.copy()
        for v1, v2, v3, a, b, c in corner:
            u1, u2 = d[v1], d[v2]
            cand = sethian(u1, u2, a, b, c)
            cand = np.where((u1 <= cap) & (u2 <= cap), cand, INF)
            np.minimum.at(best, v3, cand)
        best[lethal] = 0.0
        if np.array_equal(best, d):
            break
        d = best
    return d


def fading(dist: np.ndarray, inscribed_radius: float, inflation_radius: float,
           lethal_value: float, inscribed_value: float, cost_scaling: float) -> np.ndarray:
    """Distance to cost (InflationLayer::fading, inflation_layer.cpp:315-339);
    an unreached vertex costs 0."""
    with np.errstate(invalid="ignore", over="ignore"):
        decay = np.float32(inscribed_value) * np.exp(
            np.float32(-cost_scaling) * (dist - np.float32(inscribed_radius)))
        out = np.where(dist > inflation_radius, 0.0,
                       np.where(dist > inscribed_radius, decay,
                                np.where(dist > 0.0, inscribed_value, lethal_value)))
    return np.where(np.isfinite(dist), out, 0.0).astype(np.float32)
