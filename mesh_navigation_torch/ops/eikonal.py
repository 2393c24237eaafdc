"""The Sethian triangle update (port of sethian_candidates,
mesh_navigation_tpu/ops/eikonal.py:128).

The inflation layer's wavefront (inflation_layer.cpp:181-234) updates a free
vertex from its face's two supporting vertices. The rest of the CVP and
eikonal machinery is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

INF = float("inf")
_EPS = 1e-12


class TriangleCandidates(NamedTuple):
    """Per-(face, corner) update proposal for the corner's free vertex."""
    value: torch.Tensor       # f32 candidate distance (inf = no update)
    pred_is_v1: torch.Tensor  # bool: which supporting vertex is predecessor
    theta: torch.Tensor       # f32 rotation angle of the optimal direction


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
