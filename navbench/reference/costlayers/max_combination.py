"""The max combination layer (combination_layer.cpp): the largest of its
inputs' costs at each vertex."""

import numpy as np


def compute(ref, layer, done, ctx):
    return np.max(np.stack([done[name] for name in layer["inputs"]]), axis=0)
