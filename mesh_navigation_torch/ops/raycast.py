"""Vertical ray casting against xy face bins (port of the FaceGrid2D route of
mesh_navigation_tpu/ops/raycast.py:71-144).

The reference's obstacle layer casts every sensed point straight down its
`down_axis` (obstacle_layer.cpp:229-239); a uniform xy binning of the faces
replaces the Embree BVH for such rays: each ray tests only its cell's K
candidate faces. The bins are built on the host once per mesh.
Brute-force casting and the 3D grid are not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mesh_navigation_torch.mesh import geometry
from mesh_navigation_torch.mesh.arrays import MeshArrays, host_array


@dataclasses.dataclass(frozen=True)
class FaceGrid2D:
    """Uniform xy binning of faces for vertical (+-z) rays."""
    origin: torch.Tensor       # [2] f32
    cell_size: torch.Tensor    # [] f32
    dims: torch.Tensor         # [2] i64
    cell_faces: torch.Tensor   # [C, K] i64 face ids per cell, ascending (pad 0)
    cell_mask: torch.Tensor    # [C, K] bool


def build_face_grid(mesh: MeshArrays, cell_size: float | None = None) -> FaceGrid2D:
    """Host-side: bin each face into every xy cell its AABB overlaps. Within
    a cell the faces are in ascending id, and K is the largest cell's count
    (the tables of the reference's per-face loop, built with numpy)."""
    tris = host_array(mesh, "vertices")[host_array(mesh, "faces")]   # [F, 3, 3]
    if cell_size is None:
        ed = host_array(mesh, "edge_dist")
        cell_size = 2.0 * float(ed.mean()) if len(ed) else 1.0
    lo = tris[..., :2].min(axis=(0, 1)) - 1e-4
    hi = tris[..., :2].max(axis=(0, 1)) + 1e-4
    dims = np.maximum(np.ceil((hi - lo) / cell_size).astype(np.int64), 1)
    fmin = np.floor((tris[..., :2].min(axis=1) - lo) / cell_size).astype(np.int64)
    fmax = np.floor((tris[..., :2].max(axis=1) - lo) / cell_size).astype(np.int64)
    fmin = np.clip(fmin, 0, dims - 1)
    fmax = np.clip(fmax, 0, dims - 1)
    C = int(dims[0] * dims[1])
    # one entry per (face, overlapped cell), faces in ascending id
    ny = fmax[:, 1] - fmin[:, 1] + 1
    cnt = (fmax[:, 0] - fmin[:, 0] + 1) * ny
    face = np.repeat(np.arange(len(tris), dtype=np.int64), cnt)
    k = np.arange(len(face)) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    cx = fmin[face, 0] + k // ny[face]
    cy = fmin[face, 1] + k % ny[face]
    cid = cx * dims[1] + cy
    order = np.argsort(cid, kind="stable")          # stable: ids stay ascending
    cid, face = cid[order], face[order]
    counts = np.bincount(cid, minlength=C)
    K = max(1, int(counts.max()) if len(counts) else 1)
    slot = np.arange(len(cid)) - np.repeat(np.cumsum(counts) - counts, counts)
    cell_faces = np.zeros((C, K), np.int64)
    cell_mask = np.zeros((C, K), bool)
    cell_faces[cid, slot] = face
    cell_mask[cid, slot] = True
    dev = mesh.device
    return FaceGrid2D(
        origin=torch.from_numpy(lo.astype(np.float32)).to(dev),
        cell_size=torch.tensor(cell_size, dtype=torch.float32, device=dev),
        dims=torch.from_numpy(dims).to(dev),
        cell_faces=torch.from_numpy(cell_faces).to(dev),
        cell_mask=torch.from_numpy(cell_mask).to(dev),
    )


def raycast_vertical(
    mesh: MeshArrays, fgrid: FaceGrid2D, origins: torch.Tensor, *, down: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Nearest hit of vertical rays from `origins` [N, 3] among their cells'
    faces. Returns (t [N], face_id [N] (-1 = miss), hit [N] bool), the
    `castRays -> (hit, dist, face_id)` contract of the lvr2 raycasters."""
    direction = torch.tensor([0.0, 0.0, -1.0 if down else 1.0],
                             dtype=torch.float32, device=origins.device)
    cell = torch.floor((origins[:, :2] - fgrid.origin) / fgrid.cell_size).to(torch.int64)
    inside = torch.all((cell >= 0) & (cell < fgrid.dims[None, :]), dim=-1)
    cell = torch.minimum(torch.clamp(cell, min=0), fgrid.dims - 1)
    cid = cell[:, 0] * fgrid.dims[1] + cell[:, 1]
    cands = fgrid.cell_faces[cid]                                 # [N, K]
    cmask = fgrid.cell_mask[cid] & inside[:, None]
    tri = mesh.vertices[mesh.faces.long()[cands]]                 # [N, K, 3, 3]
    t, hit = geometry.ray_triangle_intersect(origins[:, None, :], direction[None, None, :], tri)
    t = torch.where(hit & cmask, t, torch.inf)
    tmin, arg = torch.min(t, dim=1)
    fbest = torch.gather(cands, 1, arg[:, None])[:, 0]
    ok = torch.isfinite(tmin)
    return tmin, torch.where(ok, fbest, -1), ok
