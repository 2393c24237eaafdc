"""Triangle updates (port of mesh_navigation_tpu/ops/eikonal.py:33-186).

A wavefront over triangle interiors updates a free vertex from its face's
two supporting vertices: the CVP geometric unfolding update
(unfolding_candidates, cvp_mesh_planner.cpp:369-556) and the inflation
layer's Sethian update (sethian_candidates, inflation_layer.cpp:181-234).
The gather solvers (eikonal_field, batched_eikonal_field, cvp_vector_map)
and the fmm / with_s variants are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

INF = float("inf")
_EPS = 1e-12


def _face_corner_tables(mesh):
    """Per-(face, corner k) views: free vertex v3 = faces[:, k], supporting
    vertices v1 = faces[:, k+1], v2 = faces[:, k+2] (the C++ argument order,
    cvp_mesh_planner.cpp:814-876), and the side-length edge ids: c = |v1 v2|
    (edge opposite k), b = |v1 v3|, a = |v2 v3|. Returns
    (v1, v2, v3, ea, eb, ec), each [F, 3] i64."""
    f = mesh.faces.long()
    e = mesh.face_edges.long()
    v1 = torch.roll(f, -1, dims=1)
    v2 = torch.roll(f, -2, dims=1)
    return v1, v2, f, torch.roll(e, -1, dims=1), torch.roll(e, -2, dims=1), e


class TriangleCandidates(NamedTuple):
    """Per-(face, corner) update proposal for the corner's free vertex."""
    value: torch.Tensor       # f32 candidate distance (inf = no update)
    pred_is_v1: torch.Tensor  # bool: which supporting vertex is predecessor
    theta: torch.Tensor       # f32 rotation angle of the optimal direction


def unfolding_candidates(
    u1: torch.Tensor, u2: torch.Tensor,
    a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
) -> TriangleCandidates:
    """CVP geometric-unfolding triangle update (CVPMeshPlanner::
    waveFrontUpdate, cvp_mesh_planner.cpp:369-556), vectorized, in float32
    as the reference computes it without x64: planar coordinates of the
    virtual source S = (sx, sy) and of the free vertex (p, hc), u3 = |S - v3|,
    the obtuse-corner fallbacks u1 + b / u2 + a, and the rotation angle θ of
    the optimal direction. An infinite u1 or u2 gives an infinite value."""
    u1, u2, a, b, c = (x.to(torch.float32) for x in (u1, u2, a, b, c))
    both_finite = torch.isfinite(u1) & torch.isfinite(u2)
    u1s = torch.where(both_finite, u1, 0.0)
    u2s = torch.where(both_finite, u2, 0.0)

    c_safe = torch.clamp(c, min=_EPS)
    sx = (c * c + u1s * u1s - u2s * u2s) / (2.0 * c_safe)
    sy = -torch.sqrt(torch.clamp(u1s * u1s - sx * sx, min=0.0))
    p = (b * b + c * c - a * a) / (2.0 * c_safe)
    hc = torch.sqrt(torch.clamp(b * b - p * p, min=0.0))
    dx = p - sx
    dy = hc - sy
    u3_sq = dx * dx + dy * dy
    u3 = torch.sqrt(u3_sq)

    u3_safe = torch.clamp(u3, min=_EPS)
    t0a = (a * a + b * b - c * c) / torch.clamp(2.0 * a * b, min=_EPS)
    t1a = (u3_sq + b * b - u1s * u1s) / (2.0 * u3_safe * torch.clamp(b, min=_EPS))
    t2a = (a * a + u3_sq - u2s * u2s) / (2.0 * torch.clamp(a, min=_EPS) * u3_safe)

    theta0 = torch.arccos(torch.clamp(t0a, -1.0, 1.0))
    theta1 = torch.arccos(torch.clamp(t1a, -1.0, 1.0))
    theta2 = torch.arccos(torch.clamp(t2a, -1.0, 1.0))

    fb1 = u1 + b    # fallback through v1 (cvp_mesh_planner.cpp:419-436)
    fb2 = u2 + a    # fallback through v2 (:438-455)
    corner1 = torch.abs(t1a) > 1.0
    corner2 = torch.abs(t2a) > 1.0
    interior_ok = (theta1 < theta0) & (theta2 < theta0)
    prefer_v1 = theta1 < theta2

    # decision cascade, in the C++ order
    value = torch.where(
        corner1, fb1,
        torch.where(corner2, fb2,
                    torch.where(interior_ok, u3, torch.where(prefer_v1, fb1, fb2))),
    )
    pred_is_v1 = corner1 | (~corner2 & prefer_v1)
    theta = torch.where(
        ~corner1 & ~corner2 & interior_ok,
        torch.where(prefer_v1, theta1, -theta2),
        0.0,
    )
    value = torch.where(both_finite & torch.isfinite(value), value, INF)
    return TriangleCandidates(value=value, pred_is_v1=pred_is_v1, theta=theta)


def sethian_candidates(
    u1: torch.Tensor, u2: torch.Tensor,
    a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
    speed: float = 1.0,
) -> TriangleCandidates:
    """Sethian quadratic triangle update, vectorized, with the branch
    structure of InflationLayer::computeUpdateSethianMethod
    (inflation_layer.cpp:181-234): solve f2 t^2 + 2 f1 t + f0 = 0 for the
    arrival time at the free vertex, check the monotonicity window, else
    fall back to the edge relaxation min(b F + u1, a F + u2)."""
    eps = 1e-7  # |f2| guard
    both_finite = torch.isfinite(u1) & torch.isfinite(u2)
    u1s = torch.where(both_finite, u1, 0.0)
    u2s = torch.where(both_finite, u2, 0.0)
    F = speed

    dot = (a * a + b * b - c * c) / torch.clamp(2.0 * a * b, min=_EPS)
    dot = torch.clamp(dot, -1.0, 1.0)
    r_cos = dot
    r_sin = torch.sqrt(torch.clamp(1.0 - dot * dot, min=0.0))

    u = u2s - u1s
    f2 = a * a + b * b - 2.0 * a * b * r_cos
    f1 = b * u * (a * r_cos - b)
    f0 = b * b * (u * u - F * F * a * a * r_sin * r_sin)
    delta = f1 * f1 - f0 * f2

    sqrt_delta = torch.sqrt(torch.clamp(delta, min=0.0))
    f2_safe = torch.where(torch.abs(f2) > eps, f2, 1.0)
    t_minus = (-f1 - sqrt_delta) / f2_safe
    t_plus = (-f1 + sqrt_delta) / f2_safe
    f1_big = torch.abs(f1) > _EPS
    t_ratio = torch.where(f1_big, -f0 / torch.where(f1_big, f1, 1.0), -INF)

    cos_safe = torch.where(torch.abs(r_cos) > _EPS, r_cos, _EPS)
    t = t_minus
    t_div = torch.clamp(torch.abs(t), min=_EPS) * torch.sign(torch.where(t == 0, 1.0, t))
    retry = (t < u) | (b * (t - u) / t_div < a * r_cos) | (a / cos_safe < b * (t - u) / 2.0)
    t = torch.where(retry, t_plus, t_ratio)
    t = torch.where(torch.abs(f2) > eps, t, INF)
    t = torch.where(delta >= 0.0, t, -INF)

    t_div = torch.where(torch.abs(t) > _EPS, t, _EPS)
    window = (
        (u < t)
        & (a * r_cos < b * (t - u) / t_div)
        & (b * (t - u) / t_div < a / cos_safe)
    )
    interior = t + u1s
    fallback = torch.minimum(b * F + u1s, a * F + u2s)
    value = torch.where(window & torch.isfinite(interior), interior, fallback)
    pred_is_v1 = torch.where(window, True, b * F + u1s <= a * F + u2s)
    value = torch.where(both_finite & torch.isfinite(value), value, INF)
    return TriangleCandidates(
        value=value.to(torch.float32),
        pred_is_v1=pred_is_v1,
        theta=torch.zeros_like(value, dtype=torch.float32),
    )
