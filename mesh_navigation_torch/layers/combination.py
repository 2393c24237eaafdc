"""Max / weighted-average combination layers (port of
mesh_navigation_tpu/layers/combination.py:20-51).

MaxCombination takes the per-vertex max over its inputs with the union of
their lethal sets (combination_layer.cpp:44-85); AvgCombination the weighted
sum of the inputs' costs by each input layer's `combination_weight`
(combination_layer.cpp:185-247). Neither normalizes.
"""

from __future__ import annotations

import torch

from mesh_navigation_torch.config import LayerConfig
from mesh_navigation_torch.layers.base import LayerOutput, register_layer, zero_vectors
from mesh_navigation_torch.mesh.arrays import MeshArrays


def _empty(mesh: MeshArrays) -> LayerOutput:
    z = torch.zeros(mesh.num_vertices, dtype=torch.float32, device=mesh.device)
    return LayerOutput(z, torch.zeros_like(z, dtype=torch.bool), zero_vectors(mesh))


@register_layer("max_combination")
def make_max_combination(cfg: LayerConfig):
    def fn(mesh: MeshArrays, inputs: dict, state) -> LayerOutput:
        if not inputs:
            return _empty(mesh)
        costs = torch.stack([o.costs for o in inputs.values()]).amax(dim=0)
        lethal = torch.stack([o.lethal for o in inputs.values()]).any(dim=0)
        return LayerOutput(costs=costs, lethal=lethal, vectors=zero_vectors(mesh))

    return fn


@register_layer("avg_combination")
def make_avg_combination(cfg: LayerConfig):
    # per-input weights: each input layer's `combination_weight`
    # (LayerConfig.factor); a "weight:<input>" param on this layer overrides
    def fn(mesh: MeshArrays, inputs: dict, state) -> LayerOutput:
        if not inputs:
            return _empty(mesh)
        factors = state.get("__factors__", {})
        total = torch.zeros(mesh.num_vertices, dtype=torch.float32, device=mesh.device)
        for name, out in inputs.items():
            w = cfg.param(f"weight:{name}", factors.get(name, 1.0))
            total = total + w * out.costs
        lethal = torch.stack([o.lethal for o in inputs.values()]).any(dim=0)
        return LayerOutput(costs=total, lethal=lethal, vectors=zero_vectors(mesh))

    return fn
