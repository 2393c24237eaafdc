"""The obstacle layer (obstacle_layer.cpp): lethal (inf) at the vertices
of ctx["lethal"], 0 elsewhere; with no sensed points nothing is lethal."""

import numpy as np


def compute(ref, layer, done, ctx):
    lethal = ctx.get("lethal")
    if lethal is None:
        return np.zeros(ref.mesh.V, np.float32)
    return np.where(lethal, np.float32(np.inf), np.float32(0.0))
