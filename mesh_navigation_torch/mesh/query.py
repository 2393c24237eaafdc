"""Spatial queries: nearest vertex, containing face, neighbour face search
(port of mesh_navigation_tpu/mesh/query.py).

A uniform hash grid over the vertices is built on the host; queries probe
the 3x3x3 neighbouring cells (3x3 full-height columns with `flat_z`) with
fixed-size gathers, batched over query points.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mesh_navigation_torch.mesh import geometry
from mesh_navigation_torch.mesh.arrays import MeshArrays, host_array


@dataclasses.dataclass(frozen=True)
class SpatialGrid:
    """Uniform hash grid over vertex positions (host-built)."""
    origin: torch.Tensor           # [3] f32 grid min corner
    cell_size: float
    dims: torch.Tensor             # [3] i64 cells per axis
    cell_start: torch.Tensor       # [C+1] i64 prefix offsets into sorted_vertices
    sorted_vertices: torch.Tensor  # [V] i64 vertex ids sorted by cell
    max_per_cell: int = 32         # probes sized to this are exact
    flat_z: bool = False           # cells are full-height z columns
    # dense cell tables (positions padded with +inf so empty slots never win)
    cell_pos: torch.Tensor | None = None   # [C, P, 3] f32
    cell_vid: torch.Tensor | None = None   # [C, P] i64


def build_grid(
    mesh: MeshArrays,
    cell_size: float | None = None,
    *,
    flatten_z: bool | None = None,
) -> SpatialGrid:
    """Host-side grid build; default cell size is 2x the mean edge length.
    `flatten_z` (auto: on when the mesh spans at most 8 cells of height)
    makes every cell a full-height column, so a query offset from the
    surface along z still probes the vertices under it (query.py:54-114 of
    the reference package)."""
    pos = host_array(mesh, "vertices")
    if cell_size is None:
        ed = host_array(mesh, "edge_dist")
        cell_size = 2.0 * float(ed.mean()) if len(ed) else 1.0
    origin = pos.min(axis=0) - 1e-4
    extent = pos.max(axis=0) - origin + 1e-3
    dims = np.maximum(np.ceil(extent / cell_size).astype(np.int64), 1)
    if flatten_z is None:
        flatten_z = dims[2] <= 8
    if flatten_z:
        dims[2] = 1
    cell = np.floor((pos - origin) / cell_size).astype(np.int64)
    cell = np.clip(cell, 0, dims - 1)
    cid = (cell[:, 0] * dims[1] + cell[:, 1]) * dims[2] + cell[:, 2]
    order = np.argsort(cid, kind="stable")
    sorted_cid = cid[order]
    C = int(dims[0] * dims[1] * dims[2])
    cell_start = np.searchsorted(sorted_cid, np.arange(C + 1))
    counts = np.diff(cell_start)
    P = int(counts.max()) if len(counts) else 1
    dev = mesh.device
    cell_pos = cell_vid = None
    if C * max(P, 1) <= 32_000_000:
        cell_pos_np = np.full((C, P, 3), np.inf, np.float32)
        cell_vid_np = np.zeros((C, P), np.int64)
        slot = np.arange(len(order)) - cell_start[sorted_cid]
        cell_pos_np[sorted_cid, slot] = pos[order]
        cell_vid_np[sorted_cid, slot] = order
        cell_pos = torch.from_numpy(cell_pos_np).to(dev)
        cell_vid = torch.from_numpy(cell_vid_np).to(dev)
    return SpatialGrid(
        origin=torch.from_numpy(origin.astype(np.float32)).to(dev),
        cell_size=float(np.float32(cell_size)),
        dims=torch.from_numpy(dims.astype(np.int64)).to(dev),
        cell_start=torch.from_numpy(cell_start.astype(np.int64)).to(dev),
        sorted_vertices=torch.from_numpy(order.astype(np.int64)).to(dev),
        max_per_cell=P,
        flat_z=bool(flatten_z),
        cell_pos=cell_pos,
        cell_vid=cell_vid,
    )


def _probe_cells(grid: SpatialGrid, points: torch.Tensor):
    """Cell ids [B, 9|27] around each point and their in-range mask."""
    dev = points.device
    cell = torch.floor((points - grid.origin) / grid.cell_size).to(torch.int64)
    hi = grid.dims - 1
    cell = torch.minimum(torch.clamp(cell, min=0), hi)
    r = torch.arange(-1, 2, device=dev)
    zr = torch.arange(0, 1, device=dev) if grid.flat_z else r
    offsets = torch.stack(
        torch.meshgrid(r, r, zr, indexing="ij"), dim=-1
    ).reshape(-1, 3)                                        # [27, 3] or [9, 3]
    nb = cell[:, None, :] + offsets[None, :, :]
    ok = torch.all((nb >= 0) & (nb < grid.dims), dim=-1)
    nb = torch.minimum(torch.clamp(nb, min=0), hi)
    cids = (nb[..., 0] * grid.dims[1] + nb[..., 1]) * grid.dims[2] + nb[..., 2]
    return cids, ok


def nearest_vertex_batch(
    mesh: MeshArrays, grid: SpatialGrid, points: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact nearest-vertex snap of [B, 3] points (mesh_map.cpp:1161-1174).
    Dense cell tables when the grid has them, else the CSR probe; both scan
    candidates in the same (cell, slot) order, so ties resolve alike.
    Returns (vertex_ids [B] i64, distance_sq [B])."""
    B = points.shape[0]
    lane = torch.arange(B, device=points.device)
    cids, ok = _probe_cells(grid, points)
    if grid.cell_pos is not None:
        pos = grid.cell_pos[cids]                           # [B, 27, P, 3]
        d2 = torch.sum((pos - points[:, None, None, :]) ** 2, dim=-1)
        d2 = torch.where(ok[..., None], d2, torch.inf)      # [B, 27, P]
        flat = torch.argmin(d2.reshape(B, -1), dim=1)
        cp = flat // d2.shape[2]
        sp = flat % d2.shape[2]
        vid = grid.cell_vid[cids[lane, cp], sp]
        return vid, d2.reshape(B, -1)[lane, flat]
    P = max(1, grid.max_per_cell)
    starts = grid.cell_start[cids]
    ends = grid.cell_start[cids + 1]
    idx = starts[..., None] + torch.arange(P, device=points.device)   # [B, 27, P]
    valid = ok[..., None] & (idx < ends[..., None])
    cand = grid.sorted_vertices[
        torch.clamp(idx, max=grid.sorted_vertices.shape[0] - 1)
    ]
    d2 = torch.sum((mesh.vertices[cand] - points[:, None, None, :]) ** 2, dim=-1)
    d2 = torch.where(valid, d2, torch.inf).reshape(B, -1)
    flat = torch.argmin(d2, dim=1)
    return cand.reshape(B, -1)[lane, flat], d2[lane, flat]


def containing_face_batch(
    mesh: MeshArrays, grid: SpatialGrid, points: torch.Tensor, max_dist: float = 0.4
):
    """Containing face of each point: nearest vertex, then the incident face
    with the smallest |projected distance| barycentric hit
    (mesh_map.cpp:1120-1159). Returns (face [B] or -1, bary [B, 3],
    dist [B], found [B])."""
    B = points.shape[0]
    lane = torch.arange(B, device=points.device)
    v, _ = nearest_vertex_batch(mesh, grid, points)
    faces = mesh.vertex_faces[v].long()                    # [B, FD]
    fmask = mesh.vertex_faces_mask[v]
    tri = mesh.vertices[mesh.faces[faces].long()]           # [B, FD, 3, 3]
    bary, dist, inside = geometry.projected_barycentric_coords(points[:, None, :], tri)
    score = torch.where(
        inside & fmask & (torch.abs(dist) < max_dist), torch.abs(dist), torch.inf
    )
    best = torch.argmin(score, dim=1)
    found = torch.isfinite(score[lane, best])
    face = torch.where(found, faces[lane, best], -1)
    return face, bary[lane, best], dist[lane, best], found


def neighbour_face_search_batch(
    mesh: MeshArrays, points: torch.Tensor, face: torch.Tensor,
    max_dist: float = 0.4, *, hops: int = 2,
):
    """Bounded BFS over face adjacency from `face` for a projected
    barycentric hit (mesh_map.cpp:999-1068, static hop bound). Returns
    (face [B] or -1, bary [B, 3], found [B])."""
    B = points.shape[0]
    lane = torch.arange(B, device=points.device)
    cands = face.long()[:, None]
    frontier = cands
    for _ in range(hops):
        frontier = mesh.face_neighbors[frontier].long().reshape(B, -1)
        cands = torch.cat([cands, frontier], dim=1)
    tri = mesh.vertices[mesh.faces[cands].long()]           # [B, K, 3, 3]
    bary, dist, inside = geometry.projected_barycentric_coords(points[:, None, :], tri)
    score = torch.where(inside & (torch.abs(dist) < max_dist), torch.abs(dist), torch.inf)
    best = torch.argmin(score, dim=1)
    found = torch.isfinite(score[lane, best])
    return torch.where(found, cands[lane, best], -1), bary[lane, best], found
