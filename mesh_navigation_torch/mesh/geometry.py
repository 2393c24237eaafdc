"""Batched geometry (port of mesh_navigation_tpu/mesh/geometry.py).

Every function takes batched operands whose leading dims broadcast.
"""

from __future__ import annotations

import torch

EPS_BARY = 0.01  # in/out tolerance — reference util.cpp:345 (EPSILON = 0.01)
EPS_RAY = 1e-8   # parallel-ray epsilon — reference mesh_map.cpp:1192 (kEpsilon)


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b, dim=-1)


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """dot over a last axis of 3, added x, then y, then z: the same float
    result on every device (torch.sum's order is not fixed)."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def norm(a: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.clamp(dot(a, a), min=0.0))


def normalize(a: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return a / torch.clamp(norm(a), min=eps)[..., None]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def rotate_about_axis(vec: torch.Tensor, axis: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Rodrigues rotation of vec around the unit axis by angle theta (lvr2's
    `Vector::rotated(normal, theta)` in the CVP vector field,
    cvp_mesh_planner.cpp:229-234)."""
    axis = normalize(axis)
    c = torch.cos(theta)[..., None]
    s = torch.sin(theta)[..., None]
    return vec * c + cross(axis, vec) * s + axis * dot(axis, vec)[..., None] * (1.0 - c)


def projected_barycentric_coords(p: torch.Tensor, tri: torch.Tensor):
    """Barycentric coords of p projected onto tri = [..., 3, 3] (Heidrich's
    method, util.cpp:320-347). Returns (bary [..., 3], signed_dist [...],
    inside [...]) with the reference's 0.01 epsilon band."""
    a, b, c = tri[..., 0, :], tri[..., 1, :], tri[..., 2, :]
    u = b - a
    v = c - a
    w = p - a
    n = cross(u, v)
    nn = dot(n, n)
    inv = 1.0 / torch.clamp(nn, min=1e-24)
    gamma = dot(cross(u, w), n) * inv
    beta = dot(cross(w, v), n) * inv
    alpha = 1.0 - gamma - beta
    bary = torch.stack([alpha, beta, gamma], dim=-1)
    dist = dot(n, w) / torch.clamp(torch.sqrt(nn), min=1e-12)
    inside = torch.all((bary >= -EPS_BARY) & (bary <= 1.0 + EPS_BARY), dim=-1)
    inside = inside & (nn > 1e-24)
    return bary, dist, inside


def bary_interpolate(values: torch.Tensor, bary: torch.Tensor) -> torch.Tensor:
    """Σ bary_k · values_k over the corner axis; values [..., 3] or
    [..., 3, C] (util.h:178-203)."""
    if values.ndim == bary.ndim:
        return torch.sum(values * bary, dim=-1)
    return torch.sum(values * bary[..., None], dim=-2)


def ray_triangle_intersect(orig: torch.Tensor, direction: torch.Tensor, tri: torch.Tensor):
    """Batched ray/triangle intersection, geometric method with
    inside-outside tests (MeshMap::rayTriangleIntersect,
    mesh_map.cpp:1247-1305): one-sided (front faces w.r.t. the CCW normal),
    hits with t < 0 rejected. Returns (t [...], hit [...])."""
    v0, v1, v2 = tri[..., 0, :], tri[..., 1, :], tri[..., 2, :]
    n = cross(v1 - v0, v2 - v0)
    denom = dot(n, n)
    nd = dot(n, direction)
    parallel = torch.abs(nd) < EPS_RAY
    t = dot(n, v0 - orig) / torch.where(parallel, 1.0, nd)
    p = orig + direction * t[..., None]

    def edge_ok(e0, e1):
        return dot(n, cross(e1 - e0, p - e0)) >= 0.0

    inside = edge_ok(v0, v1) & edge_ok(v1, v2) & edge_ok(v2, v0)
    hit = inside & ~parallel & (denom > 1e-24) & (t >= 0.0)
    return t, hit


def pose_from_direction(position, direction, normal) -> torch.Tensor:
    """Quaternion (x, y, z, w) facing `direction` with up-axis `normal`
    (util.cpp:267-285): ez = normal, ey = normal × direction, ex = ey × ez."""
    ez = normalize(normal)
    ey = normalize(cross(ez, direction))
    ex = normalize(cross(ey, ez))
    m = torch.stack([ex, ey, ez], dim=-1)   # [..., 3(row), 3(col)]
    return _mat_to_quat(m)


def _mat_to_quat(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] -> quaternion [..., 4] (x, y, z, w)."""
    m00, m11, m22 = m[..., 0, 0], m[..., 1, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.sqrt(torch.clamp(1.0 + tr, min=1e-12)) / 2.0
    qx = torch.sqrt(torch.clamp(1.0 + m00 - m11 - m22, min=1e-12)) / 2.0
    qy = torch.sqrt(torch.clamp(1.0 - m00 + m11 - m22, min=1e-12)) / 2.0
    qz = torch.sqrt(torch.clamp(1.0 - m00 - m11 + m22, min=1e-12)) / 2.0
    qx = torch.copysign(qx, m[..., 2, 1] - m[..., 1, 2])
    qy = torch.copysign(qy, m[..., 0, 2] - m[..., 2, 0])
    qz = torch.copysign(qz, m[..., 1, 0] - m[..., 0, 1])
    return normalize(torch.stack([qx, qy, qz, qw], dim=-1))


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector v by quaternion q = (x, y, z, w)."""
    u = q[..., :3]
    w = q[..., 3:4]
    return v + 2.0 * cross(u, cross(u, v) + w * v)


def direction_from_pose(quat: torch.Tensor, axis: torch.Tensor | None = None) -> torch.Tensor:
    """Unit direction of a pose along a body axis, default +x
    (mesh_controller.cpp:202-214)."""
    if axis is None:
        axis = torch.tensor([1.0, 0.0, 0.0], dtype=quat.dtype, device=quat.device)
    return quat_rotate(quat, torch.broadcast_to(axis, quat[..., :3].shape))
