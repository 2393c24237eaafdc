"""Batched ray/mesh casting (port of mesh_navigation_tpu/ops/raycast.py), the
replacement for the reference's Embree/BVH raycasters (mesh_map.cpp:315-324).

Three routes, all plain torch on the mesh's device, each returning the
`castRays -> (hit, dist, face_id)` contract of the lvr2 raycasters as
(t [N], face_id [N] (-1 = miss), hit [N] bool), one-sided with t >= 0:

- raycast_bruteforce: every ray against every face, in face chunks.
- raycast_vertical: vertical rays against a uniform xy binning of the
  faces (FaceGrid2D), the obstacle layer's straight-down cast
  (obstacle_layer.cpp:229-239).
- raycast_grid: rays in any direction walk a uniform 3-D binning
  (FaceGrid3D, CSR buckets) cell by cell, an Amanatides-Woo DDA in lockstep.

The grids are built on the host once per mesh, vectorised in numpy. Where a
ray hits several faces at one t, raycast_bruteforce and raycast_grid keep
the lowest candidate slot (the first index of the minimum, taken
explicitly, so the card and the CPU agree).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mesh_navigation_torch.mesh import geometry
from mesh_navigation_torch.mesh.arrays import MeshArrays, host_array


def _first_argmin(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Index of the first entry of each row of x [N, K] equal to its row
    minimum m [N] (0 where the row is all inf), the same on every device."""
    idx = torch.arange(x.shape[1], device=x.device)
    return torch.where(x == m[:, None], idx, x.shape[1]).amin(dim=1).clamp(max=x.shape[1] - 1)


def raycast_bruteforce(
    mesh: MeshArrays,
    origins: torch.Tensor,      # [N, 3]
    directions: torch.Tensor,   # [N, 3]
    *,
    face_chunk: int = 4096,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Nearest front-face hit of each ray among all faces (raycast.py:27-66),
    `face_chunk` faces at a time (MeshMap::rayTriangleIntersect semantics,
    mesh_map.cpp:1247-1305)."""
    tris = mesh.vertices[mesh.faces.long()]                    # [F, 3, 3]
    N = origins.shape[0]
    best_t = torch.full((N,), torch.inf, dtype=torch.float32, device=origins.device)
    best_f = torch.full((N,), -1, dtype=torch.int64, device=origins.device)
    for s in range(0, mesh.num_faces, face_chunk):
        t, hit = geometry.ray_triangle_intersect(
            origins[:, None, :], directions[:, None, :], tris[None, s:s + face_chunk])
        t = torch.where(hit, t, torch.inf)                      # [N, chunk]
        tmin = t.amin(dim=1)
        better = tmin < best_t
        best_t = torch.where(better, tmin, best_t)
        best_f = torch.where(better, _first_argmin(t, tmin) + s, best_f)
    hit = torch.isfinite(best_t)
    return best_t, torch.where(hit, best_f, -1), hit


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


def vertex_clearance(
    mesh: MeshArrays,
    max_dist: float,
    *,
    offset: float = 1e-3,
    face_chunk: int = 4096,
    vertex_ids: torch.Tensor | None = None,
) -> torch.Tensor:
    """Free space along each vertex normal by the brute-force cast
    (raycast.py:147-162; lvr2::calcNormalClearance, clearance_layer.cpp:161).
    Rays start `offset` off the surface to avoid self-hits; a miss reads
    max_dist (open sky). `vertex_ids` casts only from those vertices."""
    pos, nrm = mesh.vertices, mesh.vertex_normals
    if vertex_ids is not None:
        pos, nrm = pos[vertex_ids], nrm[vertex_ids]
    t, _, hit = raycast_bruteforce(mesh, pos + nrm * offset, nrm, face_chunk=face_chunk)
    t = t + offset
    return torch.where(hit & (t < max_dist), t, max_dist).to(torch.float32)


@dataclasses.dataclass(frozen=True)
class FaceGrid3D:
    """Uniform 3-D binning of faces in CSR buckets, for rays in any
    direction (raycast.py:165-182): a ray walks its cells and tests only
    their faces instead of all F."""
    origin: torch.Tensor        # [3] f32
    cell_size: torch.Tensor     # [] f32
    dims: torch.Tensor          # [3] i64
    cell_start: torch.Tensor    # [C + 1] i64 CSR offsets
    bucket_faces: torch.Tensor  # [Z] i64 face ids, by cell, ascending within one
    max_per_cell: int           # the largest bucket (the default probe)
    cell_size_static: float     # cell_size as a float, for step counts


def build_face_grid3d(mesh: MeshArrays, cell_size: float | None = None) -> FaceGrid3D:
    """Host-side: bin each face into every 3-D cell its AABB overlaps
    (raycast.py:185-234), vectorised over the few cells a face spans per
    axis (faces are an edge long, cells two)."""
    tris = host_array(mesh, "vertices")[host_array(mesh, "faces")]   # [F, 3, 3]
    F = len(tris)
    if cell_size is None:
        ed = host_array(mesh, "edge_dist")
        cell_size = 2.0 * float(ed.mean()) if len(ed) else 1.0
    lo = tris.min(axis=(0, 1)) - 1e-4
    hi = tris.max(axis=(0, 1)) + 1e-4
    dims = np.maximum(np.ceil((hi - lo) / cell_size).astype(np.int64), 1)
    fmin = np.clip(np.floor((tris.min(axis=1) - lo) / cell_size).astype(np.int64), 0, dims - 1)
    fmax = np.clip(np.floor((tris.max(axis=1) - lo) / cell_size).astype(np.int64), 0, dims - 1)
    span = fmax - fmin                                            # [F, 3]
    max_span = span.max(axis=0) if F else np.zeros(3, np.int64)
    cells_list, faces_list = [], []
    fidx = np.arange(F, dtype=np.int64)
    for dx in range(int(max_span[0]) + 1):
        for dy in range(int(max_span[1]) + 1):
            for dz in range(int(max_span[2]) + 1):
                sel = (span[:, 0] >= dx) & (span[:, 1] >= dy) & (span[:, 2] >= dz)
                c = fmin[sel] + np.asarray([dx, dy, dz])
                cells_list.append((c[:, 0] * dims[1] + c[:, 1]) * dims[2] + c[:, 2])
                faces_list.append(fidx[sel])
    cells = np.concatenate(cells_list) if cells_list else np.zeros(0, np.int64)
    facez = np.concatenate(faces_list) if faces_list else np.zeros(0, np.int64)
    order = np.argsort(cells, kind="stable")
    cells, facez = cells[order], facez[order]
    C = int(dims[0] * dims[1] * dims[2])
    cell_start = np.searchsorted(cells, np.arange(C + 1))
    counts = np.diff(cell_start)
    dev = mesh.device
    return FaceGrid3D(
        origin=torch.from_numpy(lo.astype(np.float32)).to(dev),
        cell_size=torch.tensor(cell_size, dtype=torch.float32, device=dev),
        dims=torch.from_numpy(dims).to(dev),
        cell_start=torch.from_numpy(cell_start.astype(np.int64)).to(dev),
        bucket_faces=torch.from_numpy(facez).to(dev),
        max_per_cell=int(counts.max()) if len(counts) else 1,
        cell_size_static=float(cell_size),
    )


def raycast_grid(
    mesh: MeshArrays,
    g: FaceGrid3D,
    origins: torch.Tensor,       # [N, 3]
    directions: torch.Tensor,    # [N, 3], need not be unit
    *,
    n_steps: int = 16,
    probe: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Nearest front hit of each ray by an Amanatides-Woo DDA over the face
    grid (raycast.py:237-303): all rays step in lockstep, n_steps cells
    from the origin's cell, and each step tests `probe` faces of the
    current cell's bucket (default the largest bucket, so no candidate is
    dropped). A hit beyond the cells walked is missed: size n_steps from
    the distance of interest (max_dist / cell_size + 2). t is in units of
    |directions|."""
    if probe <= 0:
        probe = max(1, g.max_per_cell)
    N = origins.shape[0]
    dev = origins.device
    d = directions
    inv = 1.0 / torch.where(torch.abs(d) < 1e-12, 1e-12, d)
    cell = torch.floor((origins - g.origin) / g.cell_size).to(torch.int64)
    step = torch.where(d >= 0, 1, -1)
    # parametric distance to the next cell boundary on each axis
    next_b = g.origin + (cell + (step > 0).to(torch.int64)) * g.cell_size
    tmax = (next_b - origins) * inv                            # [N, 3]
    tdelta = torch.abs(g.cell_size * inv)
    tris_all = mesh.vertices[mesh.faces.long()]                # [F, 3, 3]
    Z = g.bucket_faces.shape[0]
    slots = torch.arange(probe, device=dev)
    axes = torch.arange(3, device=dev)
    best_t = torch.full((N,), torch.inf, dtype=torch.float32, device=dev)
    best_f = torch.full((N,), -1, dtype=torch.int64, device=dev)
    for _ in range(n_steps):
        ok = torch.all((cell >= 0) & (cell < g.dims), dim=-1)
        cl = torch.minimum(torch.clamp(cell, min=0), g.dims - 1)
        cid = (cl[:, 0] * g.dims[1] + cl[:, 1]) * g.dims[2] + cl[:, 2]
        s = g.cell_start[cid]
        idx = s[:, None] + slots                               # [N, P]
        valid = ok[:, None] & (idx < g.cell_start[cid + 1][:, None])
        fc = g.bucket_faces[torch.clamp(idx, 0, max(Z - 1, 0))]
        t, hit = geometry.ray_triangle_intersect(origins[:, None, :], d[:, None, :],
                                                 tris_all[fc])
        t = torch.where(hit & valid, t, torch.inf)
        tm = t.amin(dim=1)
        fm = torch.gather(fc, 1, _first_argmin(t, tm)[:, None])[:, 0]
        better = tm < best_t
        best_t = torch.where(better, tm, best_t)
        best_f = torch.where(better, fm, best_f)
        # advance every ray along the axis of its nearest boundary
        onehot = axes == _first_argmin(tmax, tmax.amin(dim=1))[:, None]
        cell = cell + onehot * step
        tmax = tmax + onehot * tdelta
    hit = torch.isfinite(best_t)
    return best_t, torch.where(hit, best_f, -1), hit


def vertex_clearance_grid(
    mesh: MeshArrays,
    g: FaceGrid3D,
    max_dist: float,
    *,
    offset: float = 1e-3,
    chunk: int = 65536,
    vertex_ids: torch.Tensor | None = None,
) -> torch.Tensor:
    """Free space along each vertex normal through the 3-D grid
    (raycast.py:306-332): O(V · probe · steps) instead of the brute force's
    O(V · F). Vertices go `chunk` at a time, so the [chunk, P, 3, 3]
    gather stays bounded. `vertex_ids` casts only from those vertices."""
    pos, nrm = mesh.vertices, mesh.vertex_normals
    if vertex_ids is not None:
        pos, nrm = pos[vertex_ids], nrm[vertex_ids]
    n_steps = int(np.ceil(max_dist / max(g.cell_size_static, 1e-6))) + 2
    out = []
    for s in range(0, pos.shape[0], chunk):
        p, n = pos[s:s + chunk], nrm[s:s + chunk]
        t, _, hit = raycast_grid(mesh, g, p + n * offset, n, n_steps=n_steps)
        t = t + offset
        out.append(torch.where(hit & (t < max_dist), t, max_dist))
    return torch.cat(out).to(torch.float32)
