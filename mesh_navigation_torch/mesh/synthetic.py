"""Synthetic meshes for tests and benchmarks.

The reference validates its numeric kernels on hand-built tiny meshes
(mesh_layers/test/inflation_layer_test.cpp:7-23 genTriangle, and
lvr2/util/Synthetic.hpp). We provide the same style of fixtures plus
procedural terrain grids at arbitrary scale for benchmarking.
"""

from __future__ import annotations

import numpy as np


def single_triangle() -> tuple[np.ndarray, np.ndarray]:
    """The unit right triangle used by the reference's inflation kernel test
    (inflation_layer_test.cpp:7-23): vertices (0,0,0), (1,0,0), (0,1,0)."""
    vertices = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], dtype=np.float32)
    faces = np.array([[0, 1, 2]], dtype=np.int32)
    return vertices, faces


def grid_mesh(
    nx: int,
    ny: int,
    *,
    spacing: float = 1.0,
    height_fn=None,
) -> tuple[np.ndarray, np.ndarray]:
    """Regular triangulated grid of nx × ny vertices in the XY plane.

    `height_fn(x, y) -> z` makes it a terrain. Each quad is split into two
    triangles with CCW (+z) orientation.
    """
    xs = np.arange(nx, dtype=np.float32) * spacing
    ys = np.arange(ny, dtype=np.float32) * spacing
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    gz = height_fn(gx, gy).astype(np.float32) if height_fn else np.zeros_like(gx)
    vertices = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3).astype(np.float32)

    i, j = np.meshgrid(np.arange(nx - 1), np.arange(ny - 1), indexing="ij")
    v00 = (i * ny + j).ravel()
    v10 = ((i + 1) * ny + j).ravel()
    v01 = (i * ny + j + 1).ravel()
    v11 = ((i + 1) * ny + j + 1).ravel()
    t1 = np.stack([v00, v10, v11], axis=1)
    t2 = np.stack([v00, v11, v01], axis=1)
    faces = np.concatenate([t1, t2]).astype(np.int32)
    return vertices, faces


def terrain_mesh(
    nx: int,
    ny: int,
    *,
    spacing: float = 1.0,
    roughness: float = 0.0,
    hills: float = 0.0,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Procedural outdoor-terrain style mesh: smooth hills + high-freq noise."""
    rng = np.random.default_rng(seed)
    phase = rng.uniform(0, 2 * np.pi, size=(4,))

    def height(x, y):
        z = np.zeros_like(x)
        if hills:
            z = hills * (
                np.sin(x * 0.05 + phase[0]) * np.cos(y * 0.07 + phase[1])
                + 0.5 * np.sin(x * 0.11 + phase[2]) * np.sin(y * 0.13 + phase[3])
            )
        if roughness:
            z = z + rng.normal(0.0, roughness, size=x.shape)
        return z

    return grid_mesh(nx, ny, spacing=spacing, height_fn=height)


def icosphere(subdivisions: int = 2, radius: float = 1.0) -> tuple[np.ndarray, np.ndarray]:
    """Icosphere — a closed manifold (no boundary) test fixture."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        dtype=np.float64,
    )
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        dtype=np.int64,
    )
    for _ in range(subdivisions):
        edge_mid: dict[tuple[int, int], int] = {}
        new_faces = []
        verts_list = list(verts)

        def midpoint(a: int, b: int) -> int:
            key = (min(a, b), max(a, b))
            if key not in edge_mid:
                verts_list.append((verts_list[a] + verts_list[b]) / 2.0)
                edge_mid[key] = len(verts_list) - 1
            return edge_mid[key]

        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.array(verts_list)
        faces = np.array(new_faces, dtype=np.int64)

    verts = verts / np.linalg.norm(verts, axis=1, keepdims=True) * radius
    return verts.astype(np.float32), faces.astype(np.int32)


def irregular_terrain_mesh(
    nx: int,
    ny: int,
    *,
    spacing: float = 1.0,
    jitter: float = 0.45,
    roughness: float = 0.0,
    hills: float = 0.0,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Irregular (scanned-style) terrain: grid sample positions jittered in
    the plane by up to `jitter`·spacing, then RE-TRIANGULATED by Delaunay —
    the topology is genuinely non-grid (vertex degrees ~3..20, no constant
    index offsets), the class of mesh the reference's planners consume
    (arbitrary PMPMesh, dijkstra_mesh_planner.cpp:217-398). Heights use the
    same hill/noise model as terrain_mesh."""
    from scipy.spatial import Delaunay

    rng = np.random.default_rng(seed)
    phase = rng.uniform(0, 2 * np.pi, size=(4,))
    xs, ys = np.meshgrid(
        np.arange(nx, dtype=np.float64) * spacing,
        np.arange(ny, dtype=np.float64) * spacing,
        indexing="ij",
    )
    pts = np.stack([xs.ravel(), ys.ravel()], axis=1)
    pts += rng.uniform(-jitter, jitter, pts.shape) * spacing
    tri = Delaunay(pts)
    faces = tri.simplices.astype(np.int32)
    x, y = pts[:, 0], pts[:, 1]
    z = np.zeros_like(x)
    if hills:
        z = hills * (
            np.sin(x * 0.05 + phase[0]) * np.cos(y * 0.07 + phase[1])
            + 0.5 * np.sin(x * 0.11 + phase[2]) * np.sin(y * 0.13 + phase[3])
        )
    if roughness:
        z = z + rng.normal(0.0, roughness, size=x.shape)
    vertices = np.stack([x, y, z], axis=1).astype(np.float32)
    # Delaunay orientation is arbitrary; flip to CCW seen from +z
    p0, p1, p2 = pts[faces[:, 0]], pts[faces[:, 1]], pts[faces[:, 2]]
    area2 = (p1[:, 0] - p0[:, 0]) * (p2[:, 1] - p0[:, 1]) - (
        p1[:, 1] - p0[:, 1]
    ) * (p2[:, 0] - p0[:, 0])
    flip = area2 < 0
    faces[flip] = faces[flip][:, ::-1]
    return vertices, faces
