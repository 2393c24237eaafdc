"""Carry a mesh or a banded plan across from numpy arrays.

The system has no model weights; what two implementations must share to be
compared is the mesh and the plan. Both functions take plain numpy arrays
(for instance read off the reference package's MeshArrays and
BandedKernelPlan), so either side can be fed the other's exact inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from mesh_navigation_torch.device import resolve_device
from mesh_navigation_torch.mesh.arrays import FIELDS, MeshArrays, from_host_tables
from mesh_navigation_torch.ops.banded_gpu import PLAN_ARRAYS, PLAN_META, BandedKernelPlan


def mesh_from_numpy(arrays: dict, *, device=None) -> MeshArrays:
    """MeshArrays from a dict of numpy arrays holding every field of FIELDS."""
    missing = [k for k in FIELDS if k not in arrays]
    if missing:
        raise ValueError(f"mesh_from_numpy: missing fields {missing}")
    return from_host_tables({k: np.array(arrays[k]) for k in FIELDS}, device)


def plan_from_numpy(arrays: dict, meta: dict, *, device=None) -> BandedKernelPlan:
    """BandedKernelPlan from a dict of numpy arrays (fields of PLAN_ARRAYS;
    absent or None ones stay None) and a dict of its scalar fields
    (PLAN_META)."""
    dev = resolve_device(device)
    fields = {}
    for k in PLAN_ARRAYS:
        a = arrays.get(k)
        fields[k] = None if a is None else torch.from_numpy(np.array(a)).to(dev)
    for k in PLAN_META:
        if k in meta:
            fields[k] = tuple(meta[k]) if k.startswith("xlanes") else meta[k]
    return BandedKernelPlan(**fields)
