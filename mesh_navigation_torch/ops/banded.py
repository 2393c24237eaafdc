"""Band-width inference (port of mesh_navigation_tpu/ops/banded.py:77)."""

from __future__ import annotations

import numpy as np

from mesh_navigation_torch.mesh.arrays import MeshArrays, host_array, host_array_opt


def infer_band_width(mesh: MeshArrays) -> int:
    """Most common |offset| > 2 in the adjacency — the grid minor-axis length
    for x-major terrain meshes. A `band_hint` registered by
    mesh/reorder.build_reordered_mesh (the row width it binned with) comes
    first: on irregular reordered meshes the offset histogram jitters around
    the true width."""
    hint = host_array_opt(mesh, "band_hint")
    if hint is not None:
        return int(hint)
    adj = host_array(mesh, "adj_vertex")
    V = adj.shape[0]
    delta = np.abs(adj - np.arange(V)[:, None])
    mask = host_array(mesh, "adj_mask") & (delta > 2)
    if not mask.any():
        return 0
    vals, cnts = np.unique(delta[mask], return_counts=True)
    return int(vals[np.argmax(cnts)])
