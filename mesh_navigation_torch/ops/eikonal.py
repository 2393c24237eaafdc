"""Triangle updates and the gather eikonal solvers (port of
mesh_navigation_tpu/ops/eikonal.py).

A wavefront over triangle interiors updates a free vertex from its face's
two supporting vertices: the CVP geometric unfolding update
(unfolding_candidates, cvp_mesh_planner.cpp:369-556), its FMM and with-S
variants (:559-649, :249-367) and the inflation layer's Sethian update
(sethian_candidates, inflation_layer.cpp:181-234).

The gather solvers iterate every (face, corner) candidate at once and let
each vertex take the minimum over its incident candidates (a fast
iterative method, Jacobi sweeps), to the fixed point of the reference's
heap order: eikonal_field for one seed field with predecessor, θ and
cutting-face bookkeeping, batched_eikonal_field for a [B, V] batch, and
cvp_vector_map for the per-vertex direction field. Convergence is read on
the host once per block of `block_sweeps` sweeps.
"""

from __future__ import annotations

from typing import NamedTuple

import math

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


def fmm_candidates(
    u1: torch.Tensor, u2: torch.Tensor,
    a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
) -> TriangleCandidates:
    """Textbook FMM quadratic update (CVPMeshPlanner::waveFrontUpdateFMM,
    cvp_mesh_planner.cpp:559-649): order the supports so u1 <= u2, solve
    k0 t^2 + k1 t + k2 = 0, check the monotonicity window
    a cosθ < e < a / cosθ with e = b (t - Δu) / t, else fall back to the
    cheaper of u1 + b / u2 + a; θ = θ_face + φ - π/2."""
    both_finite = torch.isfinite(u1) & torch.isfinite(u2)
    # the first support gets the smaller distance; side lengths follow
    swap = u2 < u1
    lo = torch.where(swap, u2, u1)
    hi = torch.where(swap, u1, u2)
    b_eff = torch.where(swap, a, b)
    a_eff = torch.where(swap, b, a)
    lo_s = torch.where(both_finite, lo, 0.0)
    hi_s = torch.where(both_finite, hi, 0.0)

    du = hi_s - lo_s
    cos_t = (a_eff * a_eff + b_eff * b_eff - c * c) / torch.clamp(2.0 * a_eff * b_eff, min=_EPS)
    cos_t = torch.clamp(cos_t, -1.0, 1.0)
    k0 = a_eff * a_eff + b_eff * b_eff - 2.0 * a_eff * b_eff * cos_t
    k1 = 2.0 * b_eff * du * (a_eff * cos_t - b_eff)
    k2 = b_eff * b_eff * (du * du - a_eff * a_eff * (1.0 - cos_t * cos_t))
    r = k1 * k1 - 4.0 * k0 * k2
    k0_safe = torch.where(torch.abs(k0) > _EPS, k0, _EPS)
    t = torch.where(r < 0.0, -k1 / (2.0 * k0_safe),
                    (-k1 + torch.sqrt(torch.clamp(r, min=0.0))) / (2.0 * k0_safe))
    t_safe = torch.where(torch.abs(t) > _EPS, t, _EPS)
    e = b_eff * (t - du) / t_safe
    cos_safe = torch.where(torch.abs(cos_t) > _EPS, cos_t, _EPS)
    window = (du < t) & (e < a_eff / cos_safe) & (e > a_eff * cos_t)

    interior = lo_s + t
    fb_lo = lo_s + b_eff
    fb_hi = hi_s + a_eff
    value = torch.where(window & torch.isfinite(interior), interior,
                        torch.minimum(fb_lo, fb_hi))
    pred_is_lo = window | (fb_lo <= fb_hi)
    # a predecessor "v1" is the original v1, through the swap
    pred_is_v1 = torch.where(swap, ~pred_is_lo, pred_is_lo)

    theta_ang = torch.arccos(cos_t)
    phi_denom = torch.sqrt(torch.clamp(a_eff * a_eff * e * e - 2.0 * a_eff * cos_t, min=_EPS))
    phi = torch.arcsin(torch.clamp(e * torch.sin(theta_ang) / phi_denom, -1.0, 1.0))
    theta = torch.where(window, theta_ang + phi - math.pi / 2.0, 0.0)
    value = torch.where(both_finite & torch.isfinite(value), value, INF)
    return TriangleCandidates(value=value.to(torch.float32), pred_is_v1=pred_is_v1,
                              theta=theta.to(torch.float32))


def with_s_candidates(
    u1: torch.Tensor, u2: torch.Tensor,
    a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
) -> TriangleCandidates:
    """Unfolding update with Heron-area terms (CVPMeshPlanner::
    waveFrontUpdateWithS, cvp_mesh_planner.cpp:249-367): areas A (source
    triangle) and B (face) give sy = -A / 2c, hc = B / 2c; the interior
    value is accepted by the sign of the orientation term S and a
    |cos| <= 1 angle check on the nearer support's side, else the edge
    fallback through the nearer support."""
    both_finite = torch.isfinite(u1) & torch.isfinite(u2)
    u1s = torch.where(both_finite, u1, 0.0)
    u2s = torch.where(both_finite, u2, 0.0)

    c_safe = torch.clamp(c, min=_EPS)
    heron_a = torch.sqrt(torch.clamp(
        (-u1s + u2s + c) * (u1s - u2s + c) * (u1s + u2s - c) * (u1s + u2s + c), min=0.0))
    heron_b = torch.sqrt(torch.clamp(
        (-a + b + c) * (a - b + c) * (a + b - c) * (a + b + c), min=0.0))
    sx = (c * c + u1s * u1s - u2s * u2s) / (2.0 * c_safe)
    sy = -heron_a / (2.0 * c_safe)
    p = (-a * a + b * b + c * c) / (2.0 * c_safe)
    hc = heron_b / (2.0 * c_safe)
    dx = p - sx
    dy = hc - sy
    u3_sq = dx * dx + dy * dy
    u3 = torch.sqrt(u3_sq)
    u3_safe = torch.clamp(u3, min=_EPS)

    v1_nearer = u1s < u2s
    s1 = sy * p - sx * hc
    s2 = sx * hc - hc * c + sy * c - sy * p
    t1cos = (u3_sq + b * b - u1s * u1s) / (2.0 * u3_safe * torch.clamp(b, min=_EPS))
    t2cos = (a * a + u3_sq - u2s * u2s) / (2.0 * torch.clamp(a, min=_EPS) * u3_safe)

    ok1 = (s1 <= 0.0) & (torch.abs(t1cos) <= 1.0)
    ok2 = (s2 <= 0.0) & (torch.abs(t2cos) <= 1.0)
    accept_interior = torch.where(v1_nearer, ok1, ok2)
    value = torch.where(accept_interior, u3, torch.where(v1_nearer, u1s + b, u2s + a))
    theta = torch.where(
        accept_interior,
        torch.where(v1_nearer, torch.arccos(torch.clamp(t1cos, -1.0, 1.0)),
                    -torch.arccos(torch.clamp(t2cos, -1.0, 1.0))),
        0.0,
    )
    value = torch.where(both_finite & torch.isfinite(value), value, INF)
    return TriangleCandidates(value=value.to(torch.float32), pred_is_v1=v1_nearer,
                              theta=theta.to(torch.float32))


_UPDATE_FNS = {
    "unfolding": unfolding_candidates,
    "sethian": sethian_candidates,
    "fmm": fmm_candidates,
    "with_s": with_s_candidates,
}


class EikonalResult(NamedTuple):
    dist: torch.Tensor           # [V] f32 potential
    pred: torch.Tensor           # [V] i32 predecessor vertex (self = none)
    theta: torch.Tensor          # [V] f32 direction rotation angle (CVP)
    cutting_face: torch.Tensor   # [V] i32 face of the winning update (-1 = none)
    sweeps: int
    converged: bool


class _GatherTables(NamedTuple):
    v1: torch.Tensor        # [F, 3] i64 supports of each (face, corner)
    v2: torch.Tensor
    a: torch.Tensor         # [F, 3] f32 side lengths
    b: torch.Tensor
    c: torch.Tensor
    vf: torch.Tensor        # [V, FD] i64 incident faces
    vc: torch.Tensor        # [V, FD] i64 corner of the vertex in each
    vf_mask: torch.Tensor   # [V, FD] bool
    target: torch.Tensor    # [V] bool vertices that take updates


def _gather_tables(mesh, side_lengths, target_mask) -> _GatherTables:
    v1, v2, _, ea, eb, ec = _face_corner_tables(mesh)
    sl = side_lengths.to(mesh.device, torch.float32)
    target = ~mesh.invalid
    if target_mask is not None:
        target = target & target_mask.to(mesh.device)
    return _GatherTables(v1, v2, sl[ea], sl[eb], sl[ec], mesh.vertex_faces.long(),
                         mesh.vertex_face_corner.long(), mesh.vertex_faces_mask, target)


def _capped(value, u1, u2, source_cap):
    """Suppress updates whose supports lie beyond `source_cap` (the
    inflation wave's radius bound, inflation_layer.cpp:310-312)."""
    if source_cap == INF:     # u <= inf holds for every label
        return value
    return torch.where((u1 <= source_cap) & (u2 <= source_cap), value, INF)


def eikonal_field(
    mesh,
    side_lengths: torch.Tensor,
    seed_dist: torch.Tensor,
    *,
    update: str = "unfolding",
    target_mask: torch.Tensor | None = None,
    source_cap: float = INF,
    max_sweeps: int = 0,
    block_sweeps: int = 8,
) -> EikonalResult:
    """Fast-iterative eikonal solve over triangle interiors (eikonal.py:
    331-429).

    side_lengths [E]: the per-edge metric (CVP: the cost-weighted edge
    weights, cvp_mesh_planner.cpp:746). seed_dist [V]: inf except at the
    seeds, which are clamped every sweep. update: a key of _UPDATE_FNS.
    target_mask [V] bool: the vertices that take updates (the cost-limit
    skip on free vertices, cvp_mesh_planner.cpp:802-851), always without the
    invalid ones. Each sweep every vertex takes its best incident candidate
    where it improves, with the predecessor, θ and face of the winner (the
    lowest slot on ties). Sweeps run in blocks of `block_sweeps` until a
    block changes no label or `max_sweeps` (0: 4 V) is reached."""
    V = mesh.num_vertices
    dev = mesh.device
    if max_sweeps <= 0:
        max_sweeps = 4 * V
    cap = -(-max_sweeps // block_sweeps) * block_sweeps
    t = _gather_tables(mesh, side_lengths, target_mask)
    cand_fn = _UPDATE_FNS[update]
    seed_dist = seed_dist.to(dev, torch.float32)
    is_seed = torch.isfinite(seed_dist)
    take = t.target & ~is_seed
    vidx = torch.arange(V, device=dev)

    def one_sweep(dist, pred, theta, cface):
        u1 = dist[t.v1]
        u2 = dist[t.v2]
        cands = cand_fn(u1, u2, t.a, t.b, t.c)
        value = _capped(cands.value, u1, u2, source_cap)
        cand_v = torch.where(t.vf_mask, value[t.vf, t.vc], INF)          # [V, FD]
        best, arg = torch.min(cand_v, dim=1)
        win_f = t.vf[vidx, arg]
        win_c = t.vc[vidx, arg]
        improved = (best < dist) & take
        win_pred = torch.where(cands.pred_is_v1[win_f, win_c], t.v1[win_f, win_c],
                               t.v2[win_f, win_c])
        return (torch.where(is_seed, seed_dist, torch.where(improved, best, dist)),
                torch.where(improved, win_pred, pred),
                torch.where(improved, cands.theta[win_f, win_c], theta),
                torch.where(improved, win_f, cface))

    state = (torch.where(is_seed, seed_dist, INF), vidx,
             torch.zeros(V, dtype=torch.float32, device=dev),
             torch.full((V,), -1, dtype=torch.int64, device=dev))
    sweeps, changed = 0, True
    while changed and sweeps < cap:
        before = state[0]
        for _ in range(block_sweeps):
            state = one_sweep(*state)
        sweeps += block_sweeps
        changed = bool((state[0] < before).any())
    dist, pred, theta, cface = state
    return EikonalResult(dist=dist, pred=pred.to(torch.int32), theta=theta,
                         cutting_face=cface.to(torch.int32), sweeps=sweeps,
                         converged=not changed)


class BatchedEikonalResult(NamedTuple):
    dist: torch.Tensor           # [B, V]
    pred: torch.Tensor           # [B, V] i32
    theta: torch.Tensor          # [B, V]
    cutting_face: torch.Tensor   # [B, V] i32
    sweeps: int
    converged: bool


def batched_eikonal_field(
    mesh,
    side_lengths: torch.Tensor,     # [E]
    seed_dist: torch.Tensor,        # [B, V]: inf except at the seeds
    *,
    update: str = "unfolding",
    target_mask: torch.Tensor | None = None,
    source_cap: float = INF,
    max_sweeps: int = 0,
    block_sweeps: int = 16,
) -> BatchedEikonalResult:
    """A batch of eikonal solves in [V, B] layout with one shared
    convergence test (eikonal.py:441-525): one sweep, then blocks of
    `block_sweeps` while a block lowers a label. Predecessor, θ and cutting
    face come from one candidate pass against the converged field, where
    the best candidate explains the label within 1e-6."""
    V = mesh.num_vertices
    dev = mesh.device
    B = seed_dist.shape[0]
    if max_sweeps <= 0:
        max_sweeps = 4 * V
    cap = -(-max_sweeps // block_sweeps) * block_sweeps
    t = _gather_tables(mesh, side_lengths, target_mask)
    a, b, c = t.a[..., None], t.b[..., None], t.c[..., None]          # [F, 3, 1]
    cand_fn = _UPDATE_FNS[update]
    seed_vb = seed_dist.to(dev, torch.float32).T                       # [V, B]
    is_seed = torch.isfinite(seed_vb)

    def candidate_values(dist_vb):
        u1 = dist_vb[t.v1]                                              # [F, 3, B]
        u2 = dist_vb[t.v2]
        cands = cand_fn(u1, u2, a, b, c)
        return _capped(cands.value, u1, u2, source_cap), cands

    def one_sweep(dist_vb):
        value, _ = candidate_values(dist_vb)
        best = torch.where(t.vf_mask[..., None], value[t.vf, t.vc], INF).amin(dim=1)
        best = torch.where(t.target[:, None], best, INF)
        return torch.where(is_seed, seed_vb, torch.minimum(dist_vb, best))

    d = one_sweep(torch.where(is_seed, seed_vb, INF))
    sweeps, changed = 1, True
    while changed and sweeps < cap:
        before = d
        for _ in range(block_sweeps):
            d = one_sweep(d)
        sweeps += block_sweeps
        changed = bool((d < before).any())

    # winner recovery against the converged field
    value, cands = candidate_values(d)
    cand_v = torch.where(t.vf_mask[..., None], value[t.vf, t.vc], INF)   # [V, FD, B]
    best, arg = torch.min(cand_v, dim=1)                                 # [V, B]
    vidx = torch.arange(V, device=dev)[:, None]
    win_f = t.vf[vidx, arg]
    win_c = t.vc[vidx, arg]
    has = (best <= d + 1e-6) & torch.isfinite(d) & ~is_seed
    bidx = torch.arange(B, device=dev)[None, :]
    win_pred = torch.where(cands.pred_is_v1[win_f, win_c, bidx], t.v1[win_f, win_c],
                           t.v2[win_f, win_c])
    pred = torch.where(has, win_pred, vidx)
    theta = torch.where(has, cands.theta[win_f, win_c, bidx], 0.0)
    cface = torch.where(has, win_f, -1)
    return BatchedEikonalResult(
        dist=d.T.contiguous(), pred=pred.T.to(torch.int32).contiguous(),
        theta=theta.T.contiguous(), cutting_face=cface.T.to(torch.int32).contiguous(),
        sweeps=sweeps, converged=not changed,
    )


def cvp_vector_map(mesh, result) -> torch.Tensor:
    """Per-vertex direction field of an eikonal result, [..., V, 3] for
    leaves [..., V] (CVPMeshPlanner::computeVectorMap, cvp_mesh_planner.cpp:
    204-239): pos[pred] - pos[v] rotated by θ about the vertex normal,
    normalized; zero where there is no predecessor or no cutting face."""
    from mesh_navigation_torch.mesh import geometry

    pred = result.pred.long()
    vidx = torch.arange(mesh.num_vertices, device=pred.device)
    has = (pred != vidx) & (result.cutting_face >= 0)
    d = mesh.vertices[pred] - mesh.vertices
    rotated = geometry.rotate_about_axis(d, mesh.vertex_normals, result.theta)
    unit = rotated / torch.clamp(geometry.norm(rotated)[..., None], min=1e-12)
    return torch.where(has[..., None], unit, 0.0)
