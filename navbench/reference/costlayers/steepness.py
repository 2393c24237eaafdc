"""The steepness layer (steepness_layer.cpp:157-166): acos(normal.z) of
each vertex; with ctx["bf16"] the normals and costs rounded to bfloat16
(the comparison's control for the costs)."""

import numpy as np

from navbench.reference import layers


def compute(ref, layer, done, ctx):
    if not ctx.get("bf16"):
        return ref.cached("steepness", lambda: layers.steepness(ref.mesh))
    nz = layers.to_bf16(ref.mesh.vertex_normals()[:, 2])
    return layers.to_bf16(np.arccos(np.clip(nz, -1.0, 1.0)).astype(np.float32))
