"""The map as the reference sees it: read from the PLY file, with its edges,
edge lengths, vertex normals and a vertex lookup by exact coordinates."""

from __future__ import annotations

import numpy as np

def read_ply(path: str) -> tuple[np.ndarray, np.ndarray]:
    """A binary little-endian PLY of float x, y, z vertices and
    uchar-counted int triangles: (vertices [V, 3] f32, faces [F, 3] i64)."""
    with open(path, "rb") as fh:
        counts, props, cur = {}, {}, None
        while True:
            line = fh.readline().decode("ascii").strip()
            if line == "end_header":
                break
            parts = line.split()
            if parts[0] == "format" and parts[1] != "binary_little_endian":
                raise ValueError(f"{path}: only binary little-endian PLY, got {parts[1]}")
            if parts[0] == "element":
                cur = parts[1]
                counts[cur] = int(parts[2])
                props[cur] = []
            elif parts[0] == "property":
                props[cur].append(parts[1:])
        if [p[-1] for p in props["vertex"]] != ["x", "y", "z"] or \
                any(p[0] != "float" for p in props["vertex"]):
            raise ValueError(f"{path}: vertices must be float x, y, z")
        if props["face"] != [["list", "uchar", "int", "vertex_indices"]]:
            raise ValueError(f"{path}: faces must be a uchar-counted int list")
        nv, nf = counts["vertex"], counts["face"]
        verts = np.frombuffer(fh.read(12 * nv), "<f4").reshape(nv, 3).astype(np.float32)
        rec = np.dtype([("n", "u1"), ("i", "<i4", (3,))])
        faces = np.frombuffer(fh.read(rec.itemsize * nf), rec)
    if not (faces["n"] == 3).all():
        raise ValueError(f"{path}: faces must be triangles")
    return verts, faces["i"].astype(np.int64)


def coordinate_keys(points: np.ndarray) -> np.ndarray:
    """One sortable key a row of f32 coordinates (their bytes)."""
    p = np.ascontiguousarray(points, np.float32)
    return p.view(np.dtype((np.void, p.dtype.itemsize * p.shape[1])))[:, 0]


class RefMesh:
    """Vertices, faces, the undirected edges (lo < hi) with their lengths,
    the in-edges of each vertex as a CSR table and the area-weighted vertex
    normals."""

    def __init__(self, vertices: np.ndarray, faces: np.ndarray):
        self.v = np.asarray(vertices, np.float32)
        self.f = np.asarray(faces, np.int64)
        V = self.V = len(self.v)
        pairs = np.concatenate([self.f[:, [0, 1]], self.f[:, [1, 2]], self.f[:, [2, 0]]])
        lo, hi = pairs.min(axis=1), pairs.max(axis=1)
        self.edge_key = np.unique(lo * V + hi)
        self.e_lo, self.e_hi = self.edge_key // V, self.edge_key % V
        d = self.v[self.e_hi].astype(np.float64) - self.v[self.e_lo]
        self.edge_len = np.sqrt((d * d).sum(axis=1)).astype(np.float32)
        # directed arcs (src -> dst), both ways, grouped by dst
        src = np.concatenate([self.e_lo, self.e_hi])
        dst = np.concatenate([self.e_hi, self.e_lo])
        eid = np.concatenate([np.arange(len(self.e_lo))] * 2)
        order = np.argsort(dst, kind="stable")
        self.arc_src, self.arc_dst, self.arc_edge = src[order], dst[order], eid[order]
        self.in_start = np.searchsorted(self.arc_dst, np.arange(V + 1))
        # the faces around each vertex, grouped by vertex
        corner_v = self.f.ravel()
        order = np.argsort(corner_v, kind="stable")
        self.vf_face = order // 3
        self.vf_start = np.searchsorted(corner_v[order], np.arange(V + 1))
        self._keys = None

    def vertex_normals(self) -> np.ndarray:
        """Area-weighted: the sum of the incident faces' cross products
        (f32 corners, summed in f64), normalized, as f32."""
        p0, p1, p2 = (self.v[self.f[:, k]] for k in range(3))
        cross = np.cross(p1 - p0, p2 - p0).astype(np.float64)
        acc = np.zeros((self.V, 3))
        for k in range(3):
            for c in range(3):
                acc[:, c] += np.bincount(self.f[:, k], weights=cross[:, c], minlength=self.V)
        n = np.linalg.norm(acc, axis=1, keepdims=True)
        out = np.where(n > 1e-12, acc / np.maximum(n, 1e-12), [0.0, 0.0, 1.0])
        return out.astype(np.float32)

    def edge_index(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        """The edge id of each vertex pair (a, b), -1 where it is no edge."""
        a, b = np.asarray(a, np.int64), np.asarray(b, np.int64)
        key = np.minimum(a, b) * self.V + np.maximum(a, b)
        i = np.clip(np.searchsorted(self.edge_key, key), 0, len(self.edge_key) - 1)
        return np.where(self.edge_key[i] == key, i, -1)

    def vertex_at(self, points: np.ndarray) -> np.ndarray:
        """The vertex whose coordinates equal each point bit for bit, -1
        where none does."""
        if self._keys is None:
            keys = coordinate_keys(self.v)
            order = np.argsort(keys, kind="stable")
            self._keys = (keys[order], order)
        skeys, order = self._keys
        k = coordinate_keys(points)
        i = np.clip(np.searchsorted(skeys, k), 0, len(skeys) - 1)
        return np.where(skeys[i] == k, order[i], -1)

    def faces_of(self, v: int) -> np.ndarray:
        return self.vf_face[self.vf_start[v]:self.vf_start[v + 1]]

    def nearest_vertex(self, points: np.ndarray) -> np.ndarray:
        """The vertex nearest each point in 3-D (brute force)."""
        out = np.empty(len(points), np.int64)
        for i, p in enumerate(np.asarray(points, np.float32)):
            d = self.v - p
            out[i] = int(np.argmin((d * d).sum(axis=1)))
        return out
