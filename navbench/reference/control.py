"""The controller's command on a goal-seeded field (MeshController's
computeVelocityCommands and naiveControl, mesh_controller.cpp:67-242): at
the robot's face, each corner's direction toward its predecessor, blended
by the barycentric weights, and the heading law."""

from __future__ import annotations

import itertools
import math

import numpy as np

from .field import Graph


def predecessor_choices(graph: Graph, dist: np.ndarray, v: int, slack: float) -> list[int]:
    """The in-neighbours of v whose label plus arc weight lies within
    `slack` (relative to max(d, 1)) of the best: the predecessors a field
    within that slack of `dist` may give v. [v] itself where v is a seed or
    unreached."""
    if not np.isfinite(dist[v]) or dist[v] == 0.0:
        return [v]
    src, w = graph.in_arcs(v)
    val = dist[src] + w
    best = val.min()
    return src[val <= best + slack * max(dist[v], 1.0)].tolist()


SIGN_TOL = 1e-6   # below it, the turn's side is rounding's: either is right
EPS_BARY = 0.01   # the in-face band of mesh_map.cpp's projected barycentric test


def locate(mesh, point: np.ndarray, max_dist: float):
    """The robot's face as MeshMap's global search finds it
    (searchContainingFace, mesh_map.cpp:1120-1159): the faces around the
    vertex nearest the point, the one whose projected barycentric
    coordinates lie within EPS_BARY of the face and whose plane lies
    nearest, within max_dist. (face, bary) or None: a point whose nearest
    vertex is no corner of the face it lies on is off the map."""
    p = np.asarray(point, np.float64)
    v = int(mesh.nearest_vertex(p[None])[0])
    best = None
    for f in mesh.faces_of(v):
        a, b, c = mesh.v[mesh.f[f]].astype(np.float64)
        u, w2, w = b - a, c - a, p - a
        n = np.cross(u, w2)
        nn = float(n @ n)
        if not nn > 1e-24:
            continue
        gamma = float(np.cross(u, w) @ n) / nn
        beta = float(np.cross(w, w2) @ n) / nn
        bary = np.array([1.0 - gamma - beta, beta, gamma])
        dist = abs(float(n @ w)) / math.sqrt(nn)
        if (bary >= -EPS_BARY).all() and (bary <= 1.0 + EPS_BARY).all() and dist < max_dist \
                and (best is None or dist < best[0]):
            best = (dist, f, bary)
    return None if best is None else (best[1], best[2])


def command(mesh_v: np.ndarray, corners, preds, bary, heading, ctrl: dict):
    """(linear, angular, ok, side_open) of one robot facing `heading` (a
    unit vector in the plane, the pose's +x) whose face has `corners` with
    predecessors `preds`; the control plane's normal is +z. side_open: the
    field points straight ahead or behind, so the sign of the turn is
    rounding's (an exact zero signs as the controller's sum of products
    does)."""
    raw = np.zeros(3)
    for v, p, b in zip(corners, preds, bary):
        if p != v:
            d = mesh_v[p].astype(np.float64) - mesh_v[v]
            raw += b * d / max(np.linalg.norm(d), 1e-12)
    n = np.linalg.norm(raw)
    if not n > 1e-9:
        return 0.0, 0.0, False, False
    mesh_dir = raw / n
    phi = math.acos(float(np.clip(mesh_dir @ heading, -1.0, 1.0)))
    sign = float(np.cross(mesh_dir, heading) @ np.array([0.0, 0.0, 1.0]))
    angular = math.copysign(phi * ctrl["max_ang_velocity"] / math.pi, -sign)
    max_angle = ctrl["max_angle"] * math.pi / 180.0
    linear = ctrl["max_lin_velocity"] - phi * ctrl["max_lin_velocity"] / max_angle \
        if phi <= max_angle else 0.0
    linear = min(linear * ctrl["lin_vel_factor"], ctrl["max_lin_velocity"])
    angular = min(angular * ctrl["ang_vel_factor"], ctrl["max_ang_velocity"])
    return linear, angular, True, abs(sign) < SIGN_TOL


def command_gap(graph: Graph, dist: np.ndarray, position, heading, got, ctrl: dict,
                slack: float) -> float:
    """The least gap, max(|linear|, |angular|), between the command `got` =
    (linear, angular, ok) of a robot at `position` and the commands of every
    choice of predecessors within `slack` at its face's corners (either
    turn where the side is open); a robot off the map gets no command.
    inf where none agrees on whether there is a command."""
    fix = locate(graph.mesh, position, ctrl["max_search_distance"])
    if fix is None:
        return 0.0 if not got[2] else math.inf
    face, bary = graph.mesh.f[fix[0]], fix[1]
    choices = [predecessor_choices(graph, dist, int(v), slack) for v in face]
    best = math.inf
    for preds in itertools.product(*choices):
        lin, ang, ok, side_open = command(graph.mesh.v, face, preds, bary, heading, ctrl)
        if ok != got[2]:
            continue
        d_ang = min(abs(ang - got[1]), abs(-ang - got[1])) if side_open else abs(ang - got[1])
        best = min(best, max(abs(lin - got[0]), d_ang))
    return best
