"""Static CSR mesh bundle (port of mesh_navigation_tpu/mesh/arrays.py).

`MeshArrays` holds the padded incidence tables as tensors on one device.
Padding convention as in the reference: adjacency rows are padded to the max
degree with the vertex's own id (vertex tables) or 0 (face tables) plus an
explicit mask, so gathers of padded slots stay in bounds.

Every mesh is built on the host, so the numpy originals are kept beside the
tensors (`host`, the counterpart of the reference's register_host_arrays):
plan and grid builders read them through `host_array` without a copy back
from the card.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mesh_navigation_torch.device import resolve_device

FIELDS = (
    "vertices", "faces", "edges", "edge_dist", "face_normals",
    "vertex_normals", "adj_vertex", "adj_edge", "adj_mask", "vertex_faces",
    "vertex_face_corner", "vertex_faces_mask", "face_edges", "face_neighbors",
    "face_neighbors_mask", "boundary_vertex", "invalid",
)


@dataclasses.dataclass(frozen=True)
class MeshArrays:
    """CSR bundle describing a triangle mesh and its adjacency."""
    vertices: torch.Tensor            # [V, 3] f32
    faces: torch.Tensor               # [F, 3] i32
    edges: torch.Tensor               # [E, 2] i32 (lo < hi)
    edge_dist: torch.Tensor           # [E] f32
    face_normals: torch.Tensor        # [F, 3] f32
    vertex_normals: torch.Tensor      # [V, 3] f32 area-weighted
    adj_vertex: torch.Tensor          # [V, D] i32 (pad: self)
    adj_edge: torch.Tensor            # [V, D] i32 (pad: 0)
    adj_mask: torch.Tensor            # [V, D] bool
    vertex_faces: torch.Tensor        # [V, FD] i32 (pad: 0)
    vertex_face_corner: torch.Tensor  # [V, FD] i32
    vertex_faces_mask: torch.Tensor   # [V, FD] bool
    face_edges: torch.Tensor          # [F, 3] i32 edge opposite corner k
    face_neighbors: torch.Tensor      # [F, 3] i32 (pad: self)
    face_neighbors_mask: torch.Tensor  # [F, 3] bool
    boundary_vertex: torch.Tensor     # [V] bool
    invalid: torch.Tensor             # [V] bool non-manifold vertices
    host: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

    @property
    def device(self) -> torch.device:
        return self.vertices.device

    @property
    def num_vertices(self) -> int:
        return self.vertices.shape[0]

    @property
    def num_faces(self) -> int:
        return self.faces.shape[0]

    @property
    def num_edges(self) -> int:
        return self.edges.shape[0]

    @property
    def max_degree(self) -> int:
        return self.adj_vertex.shape[1]

    def to(self, device) -> "MeshArrays":
        dev = resolve_device(device)
        if dev == self.device:
            return self
        return MeshArrays(
            **{k: getattr(self, k).to(dev) for k in FIELDS}, host=self.host
        )


def host_array(mesh: MeshArrays, name: str) -> np.ndarray:
    """Numpy copy of a mesh table; served from the host originals when the
    mesh was built on the host (always true for build_mesh)."""
    if name not in mesh.host:
        mesh.host[name] = getattr(mesh, name).cpu().numpy()
    return mesh.host[name]


def host_array_opt(mesh: MeshArrays, name: str):
    """A registered host table that is not a mesh field (the `band_hint` of
    mesh/reorder.build_reordered_mesh), or None where it is absent."""
    return mesh.host.get(name)


def from_host_tables(tables: dict[str, np.ndarray], device) -> MeshArrays:
    """Upload host tables to `device`, keeping the numpy originals."""
    dev = resolve_device(device)
    return MeshArrays(
        **{k: torch.from_numpy(np.ascontiguousarray(tables[k])).to(dev) for k in FIELDS},
        host=dict(tables),
    )


def _compute_normals(vertices: np.ndarray, faces: np.ndarray):
    """Cross-product face normals + area-weighted vertex normals."""
    V, F = len(vertices), len(faces)
    if not F:
        return (
            np.zeros((0, 3), np.float32),
            np.tile(np.array([0, 0, 1], np.float32), (V, 1)),
        )
    p0, p1, p2 = vertices[faces[:, 0]], vertices[faces[:, 1]], vertices[faces[:, 2]]
    cross = np.cross(p1 - p0, p2 - p0)
    norm = np.linalg.norm(cross, axis=1, keepdims=True)
    face_normals = (cross / np.maximum(norm, 1e-12)).astype(np.float32)
    vertex_normals = np.zeros((V, 3), dtype=np.float64)
    for k in range(3):
        np.add.at(vertex_normals, faces[:, k], cross)
    vn = np.linalg.norm(vertex_normals, axis=1, keepdims=True)
    fallback = np.tile(np.array([0.0, 0.0, 1.0]), (V, 1))
    vertex_normals = np.where(vn > 1e-12, vertex_normals / np.maximum(vn, 1e-12), fallback)
    return face_normals, vertex_normals.astype(np.float32)


def _face_neighbors_from_edges(face_edges: np.ndarray, num_edges: int):
    """Face adjacency across shared edges."""
    F = len(face_edges)
    face_neighbors = np.tile(np.arange(F, dtype=np.int32)[:, None], (1, 3))
    face_neighbors_mask = np.zeros((F, 3), dtype=bool)
    if not F:
        return face_neighbors, face_neighbors_mask
    flat_e = face_edges.ravel()
    flat_f = np.repeat(np.arange(F, dtype=np.int64), 3)
    order = np.argsort(flat_e, kind="stable")
    fe, ff = flat_e[order], flat_f[order]
    starts = np.searchsorted(fe, np.arange(num_edges + 1))
    cnt = np.diff(starts)
    first = np.full(num_edges, -1, np.int64)
    second = np.full(num_edges, -1, np.int64)
    has1 = cnt > 0
    has2 = cnt > 1
    first[has1] = ff[starts[:-1][has1]]
    second[has2] = ff[starts[:-1][has2] + 1]
    fidx = np.arange(F)
    for k in range(3):
        e = face_edges[:, k]
        a, b = first[e], second[e]
        other = np.where(a == fidx, b, a)
        ok = other >= 0
        face_neighbors[:, k] = np.where(ok, other, fidx).astype(np.int32)
        face_neighbors_mask[:, k] = ok
    return face_neighbors, face_neighbors_mask


def build_mesh(vertices: np.ndarray, faces: np.ndarray, *, device=None) -> MeshArrays:
    """Build the CSR bundle on the host through the native core
    (native/meshcore.cpp) and upload it to `device` (default: the card)."""
    dev = resolve_device(device)
    vertices = np.asarray(vertices, dtype=np.float32)
    faces = np.asarray(faces, dtype=np.int32)
    if vertices.ndim != 2 or vertices.shape[1] != 3:
        raise ValueError(f"vertices must be [V,3], got {vertices.shape}")
    if faces.ndim != 2 or faces.shape[1] != 3:
        raise ValueError(f"faces must be [F,3], got {faces.shape}")
    from mesh_navigation_torch.native import NativeMesh

    nm = NativeMesh(vertices, faces)
    try:
        t = nm.tables()
        num_edges = nm.E
    finally:
        nm.close()
    face_normals, vertex_normals = _compute_normals(vertices, t["faces"])
    face_neighbors, face_neighbors_mask = _face_neighbors_from_edges(
        t["face_edges"], num_edges
    )
    tables = dict(
        vertices=vertices,
        faces=t["faces"],
        edges=t["edges"],
        edge_dist=t["edge_dist"],
        face_normals=face_normals,
        vertex_normals=vertex_normals,
        adj_vertex=t["adj_vertex"],
        adj_edge=t["adj_edge"],
        adj_mask=t["adj_mask"].astype(bool),
        vertex_faces=t["vf_face"],
        vertex_face_corner=t["vf_corner"],
        vertex_faces_mask=t["vf_mask"].astype(bool),
        face_edges=t["face_edges"],
        face_neighbors=face_neighbors,
        face_neighbors_mask=face_neighbors_mask,
        boundary_vertex=t["boundary"].astype(bool),
        invalid=t["invalid"].astype(bool),
    )
    return from_host_tables(tables, dev)
