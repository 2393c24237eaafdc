"""Visualization exports (port of mesh_navigation_tpu/utils/viz.py).

The reference publishes mesh geometry with vertex colours, per-layer vertex
costs, vector-field markers and paths for RViz (mesh_map.cpp:674-990).
Without DDS the same artifacts are files: rainbow-coloured PLY meshes for
cost fields (the colour map of mesh_map::getRainbowColor, util.cpp:401-433)
and OBJ line sets for vector fields and paths.

Departure (same bytes, faster): the reference formats each number in a
Python loop; here whole columns are turned into text at once, each number
as the reference's f-string writes it (_text), so a 1M-vertex export takes
seconds. The files are byte-equal to the reference's.
"""

from __future__ import annotations

import numpy as np

# how an f-string writes a float32 scalar: numpy 2 writes the repr of its
# value as a Python float, numpy 1 the shortest float32 repr
_FLOAT32_AS_DOUBLE = f"{np.float32(0.1)}" != "0.1"


def _text(a: np.ndarray) -> list[str]:
    """Each element of a as f"{x}" writes it."""
    if a.dtype == np.float32 and _FLOAT32_AS_DOUBLE:
        a = a.astype(np.float64)
    return a.astype(str).tolist()


def _rows(*cols: np.ndarray) -> str:
    """One line a row: the columns' texts joined by spaces."""
    return "".join(" ".join(t) + "\n" for t in zip(*(_text(c) for c in cols)))


def rainbow_color(values: np.ndarray) -> np.ndarray:
    """Vectorized parity with mesh_map::getRainbowColor (util.cpp:411-433):
    value in [0,1] -> (r, g, b). Non-finite values -> black (the reference
    returns a zero ColorRGBA for them, util.cpp:403-404)."""
    v = np.asarray(values, np.float64)
    finite = np.isfinite(v)
    v = np.clip(np.where(finite, v, 0.0), 0.0, 1.0)
    h = v * 5.0 + 1.0
    i = np.floor(h).astype(np.int64)
    f = h - i
    f = np.where(i % 2 == 0, 1.0 - f, f)  # if i is even
    n = 1.0 - f
    r = np.select([i <= 1, i == 2, i == 3, i == 4, i >= 5], [n, 0.0, 0.0, n, 1.0])
    g = np.select([i <= 1, i == 2, i == 3, i == 4, i >= 5], [0.0, n, 1.0, 1.0, n])
    b = np.select([i <= 1, i == 2, i == 3, i == 4, i >= 5], [1.0, 1.0, n, 0.0, 0.0])
    rgb = np.stack([r, g, b], axis=-1)
    rgb[~finite] = 0.0
    return rgb


def write_cost_ply(
    path: str,
    vertices: np.ndarray,
    faces: np.ndarray,
    costs: np.ndarray,
    *,
    normalize: bool = True,
) -> None:
    """Coloured-mesh export of a per-vertex cost field (the ~/vertex_costs
    channel a MeshVertexCostsStamped subscriber renders)."""
    vertices = np.asarray(vertices, np.float32)
    faces = np.asarray(faces, np.int64)
    c = np.asarray(costs, np.float64)
    if normalize:
        finite = np.isfinite(c)
        lo = c[finite].min() if finite.any() else 0.0
        hi = c[finite].max() if finite.any() else 1.0
        c = (c - lo) / max(hi - lo, 1e-9)
    rgb = (rainbow_color(c) * 255).astype(np.uint8)
    with open(path, "w") as fh:
        fh.write("ply\nformat ascii 1.0\n")
        fh.write(f"element vertex {len(vertices)}\n")
        fh.write("property float x\nproperty float y\nproperty float z\n")
        fh.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        fh.write(f"element face {len(faces)}\n")
        fh.write("property list uchar int vertex_indices\nend_header\n")
        fh.write(_rows(*vertices.reshape(-1, 3).T, *rgb.reshape(-1, 3).T))
        fh.write(_rows(np.full(len(faces), 3), *faces.reshape(-1, 3).T))


def write_vector_field_obj(
    path: str,
    origins: np.ndarray,
    vectors: np.ndarray,
    *,
    scale: float = 0.5,
    stride: int = 1,
) -> None:
    """Line-list export of a vector field (the ~/vector_field marker,
    mesh_map.cpp:839-990): one segment per vertex, origin -> origin + v·scale."""
    o = np.asarray(origins, np.float32)[::stride]
    v = np.asarray(vectors, np.float32)[::stride]
    keep = np.linalg.norm(v, axis=1) > 1e-9
    o, v = o[keep], v[keep]
    n = len(o)
    ends = o + v * scale
    with open(path, "w") as fh:
        fh.write(_rows(np.full(n, "v"), *o.T))
        fh.write(_rows(np.full(n, "v"), *ends.T))
        fh.write(_rows(np.full(n, "l"), np.arange(1, n + 1), np.arange(1 + n, 2 * n + 1)))


def write_path_obj(path: str, positions: np.ndarray, valid: np.ndarray | None = None) -> None:
    """Polyline export of a planned path (the planners' ~/path topic)."""
    p = np.asarray(positions, np.float32)
    if valid is not None:
        p = p[np.asarray(valid, bool)]
    with open(path, "w") as fh:
        fh.write(_rows(np.full(len(p), "v"), *p.reshape(-1, 3).T))
        fh.write("l " + " ".join(str(i + 1) for i in range(len(p))) + "\n")
