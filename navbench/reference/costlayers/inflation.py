"""The inflation layer (inflation_layer.cpp): the geodesic distance from
its input's lethal vertices, faded to a cost."""

import numpy as np

from navbench.reference import layers


def compute(ref, layer, done, ctx):
    p = layer["params"]
    lethal = np.isinf(done[layer["inputs"][0]])
    dist = layers.inflation_distance(ref.mesh, lethal, p["inflation_radius"])
    return layers.fading(dist, p["inscribed_radius"], p["inflation_radius"],
                         p["lethal_value"], p["inscribed_value"], p["cost_scaling_factor"])
