"""Bandwidth-minimizing vertex reorderings (port of
mesh_navigation_tpu/mesh/reorder.py:32-145): the build-time step that gives
arbitrary meshes the band structure the banded solver needs.

The banded kernel relaxes by constant offsets, so vertex numbering is the
data layout: it wants row-major numbering where almost every edge joins
(r, c) to (r + dr, c + dc), |dr| <= 1, |dc| <= 1.

- `band_order`: spatial row binning, rows of a fixed width n along one
  planar axis, sorted within each row by the other. On scanned-terrain
  meshes (near-uniform sampling) it recovers ~97% 8-class coverage even for
  jittered-Delaunay topology; the leftovers go to the solver's residual
  scatter-min and extended lanes.
- `rcm_order`: reverse Cuthill-McKee over the vertex graph (scipy), for
  meshes without a planar parametrization; it feeds the structured solver.

`build_reordered_mesh` relabels, builds the mesh and records the row width
as the `band_hint` host table, which ops/banded.infer_band_width reads
first. Pure numpy and scipy, on the host.
"""

from __future__ import annotations

import numpy as np

from mesh_navigation_torch.mesh.arrays import MeshArrays, build_mesh


def band_order(
    vertices: np.ndarray,
    *,
    n_cols: int = 0,
    col_axis: int = -1,
) -> tuple[np.ndarray, int]:
    """Spatial row-binning permutation: (perm, n_cols), perm listing old
    vertex ids in the new order (new id i is old id perm[i]). Rows bin along
    the non-column axis; columns sort along `col_axis` (default: the planar
    axis with the larger extent, so a W x H sampled area gets
    n ~ sqrt(V W / H), the grid's row width when the input is a grid)."""
    v = np.asarray(vertices, np.float64)
    V = len(v)
    ext = v.max(axis=0) - v.min(axis=0)
    if col_axis < 0:
        planar = np.argsort(ext)[-2:]
        col_axis = int(planar[np.argmax(ext[planar])])
        row_axis = int(planar[np.argmin(ext[planar])])
    else:
        rest = [a for a in range(3) if a != col_axis]
        row_axis = int(rest[int(np.argmax(ext[rest]))])
    if n_cols <= 0:
        w = max(ext[col_axis], 1e-9)
        h = max(ext[row_axis], 1e-9)
        n_cols = max(8, int(round(np.sqrt(V * w / h))))
    # rows of exactly n_cols vertices by row-axis rank, sorted along the
    # column axis within each row
    by_row = np.argsort(v[:, row_axis], kind="stable")
    row_of = np.empty(V, np.int64)
    row_of[by_row] = np.arange(V) // n_cols
    perm = np.lexsort((v[:, col_axis], row_of))
    return perm, int(n_cols)


def rcm_order(edges: np.ndarray, num_vertices: int) -> np.ndarray:
    """Reverse Cuthill-McKee permutation over the undirected edge list (old
    ids in the new order, as band_order)."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    e = np.asarray(edges, np.int64)
    data = np.ones(2 * len(e), np.int8)
    rows = np.concatenate([e[:, 0], e[:, 1]])
    cols = np.concatenate([e[:, 1], e[:, 0]])
    g = coo_matrix((data, (rows, cols)), shape=(num_vertices, num_vertices)).tocsr()
    return np.asarray(reverse_cuthill_mckee(g, symmetric_mode=True), np.int64)


def apply_order(
    vertices: np.ndarray, faces: np.ndarray, perm: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Relabel (vertices, faces) by a permutation (old ids in the new order)."""
    V = len(vertices)
    inv = np.empty(V, np.int64)
    inv[perm] = np.arange(V)
    return (np.ascontiguousarray(vertices[perm]),
            inv[np.asarray(faces, np.int64)].astype(np.int32))


def reorder_mesh(
    vertices: np.ndarray,
    faces: np.ndarray,
    *,
    method: str = "band",
    n_cols: int = 0,
) -> tuple[np.ndarray, np.ndarray, int]:
    """Relabel a raw mesh for the solvers: (vertices, faces, band_hint), the
    hint being the banded kernel's row width (0 for "rcm", whose numbering
    suits the structured solver)."""
    if method == "band":
        perm, n = band_order(vertices, n_cols=n_cols)
        v2, f2 = apply_order(vertices, faces, perm)
        return v2, f2, n
    if method == "rcm":
        raw = np.sort(
            np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]]), axis=1,
        )
        edges = np.unique(raw, axis=0)
        perm = rcm_order(edges, len(vertices))
        v2, f2 = apply_order(vertices, faces, perm)
        return v2, f2, 0
    raise ValueError(f"unknown reorder method: {method}")


def build_reordered_mesh(
    vertices: np.ndarray,
    faces: np.ndarray,
    *,
    method: str = "band",
    n_cols: int = 0,
    device=None,
) -> MeshArrays:
    """reorder_mesh, then build_mesh on `device` (default: the card), with
    the row width recorded as the `band_hint` host table."""
    v2, f2, hint = reorder_mesh(vertices, faces, method=method, n_cols=n_cols)
    mesh = build_mesh(v2, f2, device=device)
    if hint:
        mesh.host["band_hint"] = np.int64(hint)
    return mesh
