"""On-surface tracking (port of mesh_navigation_tpu/control/tracking.py:72-170).

Face re-acquisition in the controller's order (mesh_controller.cpp:98-141):
project into the tracked face, then a bounded neighbour-face search, then
the global containing-face search. Batched over lanes; a stage runs only
when some lane needs it (a Python branch on `.any()`).
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


def cost_at(
    mesh: MeshArrays, vertex_costs: torch.Tensor, face: torch.Tensor,
    bary: torch.Tensor,
) -> torch.Tensor:
    """Barycentric cost blend (MeshMap::costAtPosition, mesh_map.cpp:652-672)."""
    vids = mesh.faces[torch.clamp(face, min=0)].long()
    return geometry.bary_interpolate(vertex_costs[vids], bary)
