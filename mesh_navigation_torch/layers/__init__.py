"""Cost layers over an explicit dependency DAG (port of
mesh_navigation_tpu/layers). Importing the package registers the ten layer
kinds of the reference: height_diff, roughness, steepness, ridge, border,
clearance, obstacle, inflation, max_combination and avg_combination."""

from mesh_navigation_torch.layers import combination, inflation, local, obstacle  # noqa: F401
from mesh_navigation_torch.layers.base import (
    LAYER_REGISTRY, SKIP_VECTORS, LayerOutput, LayerStack, register_layer, zero_vectors,
)

__all__ = ["LAYER_REGISTRY", "SKIP_VECTORS", "LayerOutput", "LayerStack", "register_layer",
           "zero_vectors"]
