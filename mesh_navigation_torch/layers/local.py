"""The local geometry cost layers (port of mesh_navigation_tpu/layers/local.py).

Each layer turns local geometry into per-vertex costs and a lethal set
(SURVEY.md §2.1 C4-C9): height_diff, roughness, steepness, ridge, border and
clearance. The lvr2 neighbourhood visitors the reference's plugins call are
replaced by gathers over a padded radius-neighbourhood table, built once per
(mesh, radius) on the host by the native core and shared by every layer of
that radius under the state key `neigh:{radius}`. Sums over a neighbourhood
or a vector's components run in a fixed order, so the card and the CPU add
the same numbers in the same order.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from mesh_navigation_torch.config import LayerConfig
from mesh_navigation_torch.layers.base import LayerOutput, register_layer, zero_vectors
from mesh_navigation_torch.mesh import geometry
from mesh_navigation_torch.mesh.arrays import MeshArrays, host_array
from mesh_navigation_torch.ops import raycast


def radius_neighborhood(mesh: MeshArrays, radius: float) -> tuple[np.ndarray, np.ndarray]:
    """Padded table of the vertices within Euclidean `radius` of each
    vertex, found by a BFS along edges from it (lvr2::
    visitLocalVertexNeighborhood, ridge_layer.cpp:155-184), the vertex
    itself excluded. Host-side, by the native core; a failed build raises
    (the reference's per-vertex Python BFS fallback would take hours at 1M).
    Returns (neigh [V, K] int32, padded with the vertex's own id; mask
    [V, K] bool)."""
    from mesh_navigation_torch.native import NativeMesh

    nm = NativeMesh(host_array(mesh, "vertices"), host_array(mesh, "faces"))
    try:
        return nm.radius_neighborhood(float(radius))
    finally:
        nm.close()


def _neighborhood_state(radius: float, state_key: str):
    """`prepare` of a layer that reads the radius table: the table is built
    once per mesh and radius, kept with the mesh's host tables, so layers
    of one radius share it."""
    def prepare(m: MeshArrays) -> dict:
        if state_key not in m.host:
            m.host[state_key] = radius_neighborhood(m, radius)
        neigh, mask = m.host[state_key]
        return {state_key: (torch.from_numpy(neigh).to(m.device, torch.int64),
                            torch.from_numpy(mask).to(m.device))}
    return prepare


def _row_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum of [V, K] over K, column after column."""
    out = x[:, 0]
    for k in range(1, x.shape[1]):
        out = out + x[:, k]
    return out


def _output(mesh: MeshArrays, costs: torch.Tensor, threshold: float) -> LayerOutput:
    costs = costs.to(torch.float32)
    return LayerOutput(costs=costs, lethal=costs > threshold, vectors=zero_vectors(mesh))


@register_layer("height_diff")
def make_height_diff(cfg: LayerConfig):
    """Local height spread within `radius` (lvr2::calcVertexHeightDifferences,
    height_diff_layer.cpp:108): max minus min z over the neighbourhood and
    the vertex. Lethal above threshold (height_diff_layer.cpp:67-79);
    defaults threshold=0.185, radius=0.3 (height_diff_layer.h:131-134)."""
    threshold = cfg.param("threshold", 0.185)
    radius = cfg.param("radius", 0.3)
    key = f"neigh:{radius}"

    def fn(mesh: MeshArrays, inputs, state) -> LayerOutput:
        neigh, mask = state[key]
        z = mesh.vertices[:, 2]
        nz = torch.where(mask, z[neigh], z[:, None])
        zmax = torch.maximum(nz.amax(dim=1), z)
        zmin = torch.minimum(nz.amin(dim=1), z)
        return _output(mesh, zmax - zmin, threshold)

    fn.prepare = _neighborhood_state(radius, key)  # type: ignore[attr-defined]
    return fn


@register_layer("roughness")
def make_roughness(cfg: LayerConfig):
    """Local normal dispersion (lvr2::calcVertexRoughness,
    roughness_layer.cpp:143-144): the mean angle between the vertex normal
    and its neighbours' normals. Lethal above threshold
    (roughness_layer.cpp:77-87); defaults threshold=0.3, radius=0.3."""
    threshold = cfg.param("threshold", 0.3)
    radius = cfg.param("radius", 0.3)
    key = f"neigh:{radius}"

    def fn(mesh: MeshArrays, inputs, state) -> LayerOutput:
        neigh, mask = state[key]
        n = mesh.vertex_normals
        ang = torch.arccos(torch.clamp(geometry.dot3(n[:, None, :], n[neigh]), -1.0, 1.0))
        cnt = torch.clamp(mask.sum(dim=1), min=1)
        return _output(mesh, _row_sum(torch.where(mask, ang, 0.0)) / cnt, threshold)

    fn.prepare = _neighborhood_state(radius, key)  # type: ignore[attr-defined]
    return fn


@register_layer("steepness")
def make_steepness(cfg: LayerConfig):
    """Per-vertex steepness = acos(normal.z) (steepness_layer.cpp:157-166);
    lethal iff > threshold (steepness_layer.cpp:82-93); default 0.3."""
    threshold = cfg.param("threshold", 0.3)

    def fn(mesh: MeshArrays, inputs, state) -> LayerOutput:
        nz = torch.clamp(mesh.vertex_normals[:, 2], -1.0, 1.0)
        return _output(mesh, torch.arccos(nz), threshold)

    return fn


@register_layer("ridge")
def make_ridge(cfg: LayerConfig):
    """Ridge indicator (ridge_layer.cpp:155-184): the mean distance between
    the neighbours' p + n and the vertex's own p + n within `radius`; a
    vertex without neighbours reads threshold + 0.1 (ridge_layer.cpp:162,
    179). Lethal above threshold; defaults threshold=0.3, radius=0.3."""
    threshold = cfg.param("threshold", 0.3)
    radius = cfg.param("radius", 0.3)
    key = f"neigh:{radius}"

    def fn(mesh: MeshArrays, inputs, state) -> LayerOutput:
        neigh, mask = state[key]
        pn = mesh.vertices + mesh.vertex_normals
        diff = pn[neigh] - pn[:, None, :]
        d = torch.sqrt(geometry.dot3(diff, diff))
        cnt = mask.sum(dim=1)
        mean = _row_sum(torch.where(mask, d, 0.0)) / torch.clamp(cnt, min=1)
        return _output(mesh, torch.where(cnt > 0, mean, threshold + 0.1), threshold)

    fn.prepare = _neighborhood_state(radius, key)  # type: ignore[attr-defined]
    return fn


@register_layer("border")
def make_border(cfg: LayerConfig):
    """Constant `border_cost` on boundary vertices (lvr2::calcBorderCosts,
    border_layer.cpp:104-110); lethal above threshold; defaults
    border_cost=1.0, threshold=0.5."""
    border_cost = cfg.param("border_cost", 1.0)
    threshold = cfg.param("threshold", 0.5)

    def fn(mesh: MeshArrays, inputs, state) -> LayerOutput:
        return _output(mesh, torch.where(mesh.boundary_vertex, border_cost, 0.0), threshold)

    return fn


@register_layer("clearance")
def make_clearance(cfg: LayerConfig):
    """Free headroom along the vertex normal (lvr2::calcNormalClearance,
    clearance_layer.cpp:161) by a batched raycast. Cost mapping
    (clearance_layer.cpp:67-99): below robot_height 1.0 and lethal; below
    robot_height + height_inflation the cosine fade
    (cos((c - robot_height)·π / height_inflation) + 1) / 2; else 0.
    `prepare` builds the 3-D face grid (`clearance:grid3d`); without it in
    the state the cast is the brute force. Defaults robot_height=0.5,
    height_inflation=0.3."""
    robot_height = cfg.param("robot_height", 0.5)
    height_inflation = cfg.param("height_inflation", 0.3)
    max_dist = robot_height + height_inflation + 0.1

    def prepare(m: MeshArrays) -> dict:
        return {"clearance:grid3d": raycast.build_face_grid3d(m)}

    def fn(mesh: MeshArrays, inputs, state) -> LayerOutput:
        g = state.get("clearance:grid3d")
        if g is not None:
            clearance = raycast.vertex_clearance_grid(mesh, g, max_dist)
        else:
            clearance = raycast.vertex_clearance(mesh, max_dist=max_dist)
        diff = clearance - robot_height
        fade = (torch.cos(diff * math.pi / max(height_inflation, 1e-6)) + 1.0) * 0.5
        lethal = clearance < robot_height
        costs = torch.where(lethal, 1.0,
                            torch.where(clearance < robot_height + height_inflation, fade, 0.0))
        return LayerOutput(costs=costs.to(torch.float32), lethal=lethal,
                           vectors=zero_vectors(mesh))

    fn.prepare = prepare  # type: ignore[attr-defined]
    return fn
