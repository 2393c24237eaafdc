"""Cost layers over an explicit dependency DAG (port of
mesh_navigation_tpu/layers). Importing the package registers every ported
layer kind: steepness, obstacle, inflation, max_combination and
avg_combination."""

from mesh_navigation_torch.layers import combination, inflation, local, obstacle  # noqa: F401
from mesh_navigation_torch.layers.base import (
    LAYER_REGISTRY, LayerOutput, LayerStack, register_layer, zero_vectors,
)

__all__ = ["LAYER_REGISTRY", "LayerOutput", "LayerStack", "register_layer", "zero_vectors"]
