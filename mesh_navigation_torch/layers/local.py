"""Local geometry cost layers (port of mesh_navigation_tpu/layers/local.py).

Only steepness is ported; height_diff, roughness, ridge, border and
clearance wait for a later slice.
"""

from __future__ import annotations

import torch

from mesh_navigation_torch.config import LayerConfig
from mesh_navigation_torch.layers.base import LayerOutput, register_layer, zero_vectors
from mesh_navigation_torch.mesh.arrays import MeshArrays


@register_layer("steepness")
def make_steepness(cfg: LayerConfig):
    """Per-vertex steepness = acos(normal.z) (steepness_layer.cpp:157-166);
    lethal iff > threshold (steepness_layer.cpp:82-93); default 0.3."""
    threshold = cfg.param("threshold", 0.3)

    def fn(mesh: MeshArrays, inputs, state) -> LayerOutput:
        nz = torch.clamp(mesh.vertex_normals[:, 2], -1.0, 1.0)
        costs = torch.arccos(nz).to(torch.float32)
        return LayerOutput(costs=costs, lethal=costs > threshold, vectors=zero_vectors(mesh))

    return fn
