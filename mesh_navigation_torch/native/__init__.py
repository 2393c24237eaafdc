"""ctypes binding for the native host core (meshcore.cpp, a copy of the
reference package's mesh_navigation_tpu/native/meshcore.cpp).

Built with g++ on first use into mesh_navigation_torch/build/ (see
buildutil.py). Provides the CSR mesh build, the radius neighbourhoods of
the local cost layers (`meshcore_radius_neighborhood`,
lvr2::visitLocalVertexNeighborhood semantics), the heap-Dijkstra oracle
(`meshcore_dijkstra`, dijkstra_mesh_planner.cpp:287-348 semantics) and the
CVP fast-marching oracle (`meshcore_cvp`, cvp_mesh_planner.cpp:651-886). A
failed build raises: the port has no pure-Python mesh builder and no
Python neighbourhood search.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from mesh_navigation_torch import buildutil

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "meshcore.cpp")
_LIB = os.path.join(buildutil.BUILD_DIR, "native", "libmeshcore.so")

_lib: ctypes.CDLL | None = None
_lock = threading.Lock()


def get_lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if buildutil.is_stale(_SRC, _LIB):
            proc, tmp = buildutil.start_build(
                lambda out: ["g++", "-O3", "-std=c++17", "-shared", "-fPIC",
                             _SRC, "-o", out],
                _LIB,
            )
            buildutil.finish_build(proc, tmp, _LIB, timeout=300)
        lib = ctypes.CDLL(_LIB)
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        c = ctypes.c_int32
        lib.meshcore_build.restype = ctypes.c_void_p
        lib.meshcore_build.argtypes = [c, c, f32p, i32p]
        lib.meshcore_free.restype = None
        lib.meshcore_free.argtypes = [ctypes.c_void_p]
        for name in ("num_faces", "num_edges", "max_degree", "max_vertex_faces"):
            fn = getattr(lib, f"meshcore_{name}")
            fn.restype = c
            fn.argtypes = [ctypes.c_void_p]
        lib.meshcore_fill.restype = None
        lib.meshcore_fill.argtypes = [
            ctypes.c_void_p, i32p, i32p, f32p, i32p,
            c, i32p, i32p, u8p, c, i32p, i32p, u8p, u8p, u8p,
        ]
        lib.meshcore_radius_neighborhood.restype = c
        lib.meshcore_radius_neighborhood.argtypes = [
            ctypes.c_void_p, ctypes.c_float, c, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.meshcore_dijkstra.restype = None
        lib.meshcore_dijkstra.argtypes = [
            ctypes.c_void_p, f32p, f32p, ctypes.c_float, c, f32p, i32p,
        ]
        lib.meshcore_cvp.restype = None
        lib.meshcore_cvp.argtypes = [
            ctypes.c_void_p, f32p, f32p, ctypes.c_float, i32p, f32p, c,
            f32p, i32p, f32p,
        ]
        _lib = lib
        return _lib


class NativeMesh:
    """Owner of one meshcore handle; freed by close() or on collection."""

    def __init__(self, vertices: np.ndarray, faces: np.ndarray):
        self._lib = get_lib()
        self.vertices = np.ascontiguousarray(vertices, np.float32)
        faces = np.ascontiguousarray(faces, np.int32)
        self.V = len(self.vertices)
        self._h = self._lib.meshcore_build(self.V, len(faces), self.vertices, faces)
        self.F = self._lib.meshcore_num_faces(self._h)
        self.E = self._lib.meshcore_num_edges(self._h)
        self.max_degree = max(1, self._lib.meshcore_max_degree(self._h))
        self.max_vertex_faces = max(1, self._lib.meshcore_max_vertex_faces(self._h))

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.meshcore_free(self._h)
            self._h = None

    def __del__(self):
        self.close()

    def tables(self) -> dict[str, np.ndarray]:
        V, F, E = self.V, self.F, self.E
        D, FD = self.max_degree, self.max_vertex_faces
        out = dict(
            faces=np.zeros((F, 3), np.int32),
            edges=np.zeros((E, 2), np.int32),
            edge_dist=np.zeros(E, np.float32),
            face_edges=np.zeros((F, 3), np.int32),
            adj_vertex=np.zeros((V, D), np.int32),
            adj_edge=np.zeros((V, D), np.int32),
            adj_mask=np.zeros((V, D), np.uint8),
            vf_face=np.zeros((V, FD), np.int32),
            vf_corner=np.zeros((V, FD), np.int32),
            vf_mask=np.zeros((V, FD), np.uint8),
            boundary=np.zeros(V, np.uint8),
            invalid=np.zeros(V, np.uint8),
        )
        self._lib.meshcore_fill(
            self._h, out["faces"], out["edges"], out["edge_dist"],
            out["face_edges"], D, out["adj_vertex"], out["adj_edge"],
            out["adj_mask"], FD, out["vf_face"], out["vf_corner"],
            out["vf_mask"], out["boundary"], out["invalid"],
        )
        return out

    def radius_neighborhood(self, radius: float) -> tuple[np.ndarray, np.ndarray]:
        """Every vertex's neighbours within Euclidean `radius`, found by a
        BFS along edges from the vertex (the vertex itself excluded). Returns
        (neigh [V, K] int32, padded with the vertex's own id; mask [V, K]
        bool), K the longest row (at least 1)."""
        K = self._lib.meshcore_radius_neighborhood(self._h, float(radius), 0, None, None)
        neigh = np.zeros((self.V, K), np.int32)
        mask = np.zeros((self.V, K), np.uint8)
        self._lib.meshcore_radius_neighborhood(
            self._h, float(radius), K,
            neigh.ctypes.data_as(ctypes.c_void_p), mask.ctypes.data_as(ctypes.c_void_p),
        )
        return neigh, mask.astype(bool)

    def dijkstra(
        self,
        edge_weights: np.ndarray,
        vertex_costs: np.ndarray,
        seed: int,
        cost_limit: float = 1.0,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Heap Dijkstra from `seed` over per-edge weights, skipping
        relaxation out of vertices whose cost exceeds `cost_limit`.
        Returns (dist [V] f32, pred [V] i32)."""
        if not 0 <= seed < self.V:
            raise ValueError(f"seed {seed} out of range for {self.V} vertices")
        if len(edge_weights) != self.E or len(vertex_costs) != self.V:
            raise ValueError("edge_weights must be [E] and vertex_costs [V]")
        dist = np.zeros(self.V, np.float32)
        pred = np.zeros(self.V, np.int32)
        self._lib.meshcore_dijkstra(
            self._h,
            np.ascontiguousarray(edge_weights, np.float32),
            np.ascontiguousarray(vertex_costs, np.float32),
            float(cost_limit), int(seed), dist, pred,
        )
        return dist, pred

    def cvp(
        self,
        side_weights: np.ndarray,
        vertex_costs: np.ndarray,
        seeds: np.ndarray,
        seed_dists: np.ndarray,
        cost_limit: float = 1.0,
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Heap-ordered CVP fast marching (waveFrontPropagation,
        cvp_mesh_planner.cpp:651-886) over per-edge triangle side lengths,
        from `seeds` fixed at `seed_dists`; vertices whose cost is at least
        `cost_limit` are neither updated nor expanded. Returns
        (dist [V] f32, pred [V] i32, theta [V] f32)."""
        seeds = np.ascontiguousarray(seeds, np.int32)
        seed_dists = np.ascontiguousarray(seed_dists, np.float32)
        if seeds.ndim != 1 or seeds.shape != seed_dists.shape:
            raise ValueError("seeds and seed_dists must be [S]")
        if len(seeds) and not (0 <= seeds.min() and seeds.max() < self.V):
            raise ValueError("seed out of range")
        if len(side_weights) != self.E or len(vertex_costs) != self.V:
            raise ValueError("side_weights must be [E] and vertex_costs [V]")
        dist = np.zeros(self.V, np.float32)
        pred = np.zeros(self.V, np.int32)
        theta = np.zeros(self.V, np.float32)
        self._lib.meshcore_cvp(
            self._h,
            np.ascontiguousarray(side_weights, np.float32),
            np.ascontiguousarray(vertex_costs, np.float32),
            float(cost_limit), seeds, seed_dists, len(seeds), dist, pred, theta,
        )
        return dist, pred, theta
