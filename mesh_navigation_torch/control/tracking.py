"""On-surface tracking (port of mesh_navigation_tpu/control/tracking.py).

Face re-acquisition in the controller's order (mesh_controller.cpp:98-141):
project into the tracked face, then a bounded neighbour-face search, then
the global containing-face search. Batched over lanes; a stage runs only
when some lane needs it (a Python branch on `.any()`). The single-pose
forms (`locate`, `mesh_ahead`) are the batch forms at B = 1, and the
`meshAhead` surface walk (mesh_map.cpp:1070-1108) steps every lane at once.
"""

from __future__ import annotations

import dataclasses

import torch

from mesh_navigation_torch.mesh import geometry, query
from mesh_navigation_torch.mesh.arrays import MeshArrays


@dataclasses.dataclass(frozen=True)
class FaceFix:
    """Result of locating positions on the mesh surface."""
    face: torch.Tensor      # [B] i64 (-1 = lost)
    bary: torch.Tensor      # [B, 3]
    position: torch.Tensor  # [B, 3] projected onto the surface
    found: torch.Tensor     # [B] bool


def locate_batch(
    mesh: MeshArrays,
    grid: query.SpatialGrid,
    positions: torch.Tensor,       # [B, 3]
    current_faces: torch.Tensor,   # [B] (-1 = no tracked face)
    *,
    max_dist: float = 0.4,
    hops: int = 2,
) -> FaceFix:
    B = positions.shape[0]
    dev, dt = positions.device, positions.dtype
    current_faces = current_faces.long()
    has_face = current_faces >= 0
    safe_face = torch.clamp(current_faces, min=0)

    tri = mesh.vertices[mesh.faces[safe_face].long()]        # [B, 3, 3]
    bary0, dist0, inside0 = geometry.projected_barycentric_coords(positions, tri)
    ok0 = has_face & inside0 & (torch.abs(dist0) < max_dist)

    if bool((has_face & ~ok0).any()):
        nb_face, nb_bary, nb_found = query.neighbour_face_search_batch(
            mesh, positions, safe_face, max_dist, hops=hops
        )
    else:
        nb_face = torch.zeros(B, dtype=torch.int64, device=dev)
        nb_bary = torch.zeros((B, 3), dtype=dt, device=dev)
        nb_found = torch.zeros(B, dtype=torch.bool, device=dev)
    ok1 = has_face & ~ok0 & nb_found

    if bool((~ok0 & ~ok1).any()):
        g_face, g_bary, _, g_found = query.containing_face_batch(
            mesh, grid, positions, max_dist
        )
    else:
        g_face = torch.zeros(B, dtype=torch.int64, device=dev)
        g_bary = torch.zeros((B, 3), dtype=dt, device=dev)
        g_found = torch.zeros(B, dtype=torch.bool, device=dev)
    ok2 = ~ok0 & ~ok1 & g_found

    face = torch.where(
        ok0, safe_face, torch.where(ok1, nb_face, torch.where(ok2, g_face, -1))
    )
    bary = torch.where(ok0[:, None], bary0, torch.where(ok1[:, None], nb_bary, g_bary))
    found = ok0 | ok1 | ok2
    proj_tri = mesh.vertices[mesh.faces[torch.clamp(face, min=0)].long()]
    projected = geometry.bary_interpolate(proj_tri, bary)
    pos_out = torch.where(found[:, None], projected, positions)
    return FaceFix(face=face, bary=bary, position=pos_out, found=found)


def locate(
    mesh: MeshArrays,
    grid: query.SpatialGrid,
    position: torch.Tensor,       # [3]
    current_face,                 # [] (-1 = no tracked face)
    *,
    max_dist: float = 0.4,
    hops: int = 2,
) -> FaceFix:
    """locate_batch for one pose (tracking.py:30-69); the leaves are
    unbatched: face [], bary [3], position [3], found []."""
    faces = torch.as_tensor(current_face, device=position.device).reshape(1)
    fix = locate_batch(mesh, grid, position.reshape(1, 3), faces, max_dist=max_dist, hops=hops)
    return FaceFix(face=fix.face[0], bary=fix.bary[0], position=fix.position[0],
                   found=fix.found[0])


def _blend(mesh: MeshArrays, field: torch.Tensor, face: torch.Tensor,
           bary: torch.Tensor) -> torch.Tensor:
    """Barycentric blend of a [V, 3] field shared by the lanes, or of each
    lane's own [B, V, 3] field, at face [B], bary [B, 3] -> [B, 3]."""
    if field.dim() == 3:
        return direction_at(mesh, field, face, bary)
    vids = mesh.faces[torch.clamp(face, min=0)].long()
    return geometry.bary_interpolate(field[vids], bary)


def mesh_ahead_batch(
    mesh: MeshArrays,
    grid: query.SpatialGrid,
    vector_map: torch.Tensor,      # [B, V, 3] per lane, or [V, 3] shared
    positions: torch.Tensor,       # [B, 3]
    faces: torch.Tensor,           # [B]
    step_size: float,
    *,
    layer_vectors: torch.Tensor | None = None,   # [V, 3]
    max_dist: float = 0.4,
):
    """One surface-walk step of every lane along its vector field
    (MeshMap::meshAhead, mesh_map.cpp:1070-1108; tracking.py:172-196):
    re-acquire the face, blend the planner field with the layers' repulsive
    field at the barycentric position, normalize, step. Returns
    (new_positions [B, 3], new_faces [B], ok [B])."""
    fix = locate_batch(mesh, grid, positions, faces, max_dist=max_dist)
    d = geometry.normalize(_blend(mesh, vector_map, fix.face, fix.bary))
    if layer_vectors is not None:
        d = d + _blend(mesh, layer_vectors, fix.face, fix.bary)
    d = geometry.normalize(d)
    ok = fix.found & (geometry.norm(d) > 1e-6)
    new_pos = torch.where(ok[:, None], fix.position + d * step_size, positions)
    return new_pos, fix.face, ok


def mesh_ahead(
    mesh: MeshArrays,
    grid: query.SpatialGrid,
    vector_map: torch.Tensor,      # [V, 3]
    position: torch.Tensor,        # [3]
    face,                          # []
    step_size: float,
    *,
    layer_vectors: torch.Tensor | None = None,
    max_dist: float = 0.4,
):
    """mesh_ahead_batch for one pose. Returns (new_position [3],
    new_face [], ok [])."""
    faces = torch.as_tensor(face, device=position.device).reshape(1)
    p, f, ok = mesh_ahead_batch(mesh, grid, vector_map, position.reshape(1, 3), faces,
                                step_size, layer_vectors=layer_vectors, max_dist=max_dist)
    return p[0], f[0], ok[0]


def direction_at(
    mesh: MeshArrays, vector_map: torch.Tensor, face: torch.Tensor,
    bary: torch.Tensor,
) -> torch.Tensor:
    """Barycentric blend of each lane's per-vertex direction field
    (MeshMap::directionAtPosition, mesh_map.cpp:625-650): vector_map
    [B, V, 3], face [B], bary [B, 3] -> [B, 3]."""
    vids = mesh.faces[torch.clamp(face, min=0)].long()            # [B, 3]
    lanes = torch.arange(vids.shape[0], device=vids.device)[:, None]
    return geometry.bary_interpolate(vector_map[lanes, vids], bary)


def cost_at(
    mesh: MeshArrays, vertex_costs: torch.Tensor, face: torch.Tensor,
    bary: torch.Tensor,
) -> torch.Tensor:
    """Barycentric cost blend (MeshMap::costAtPosition, mesh_map.cpp:652-672)."""
    vids = mesh.faces[torch.clamp(face, min=0)].long()
    return geometry.bary_interpolate(vertex_costs[vids], bary)
