"""Carry a mesh or a kernel plan across from numpy arrays.

The system has no model weights; what two implementations must share to be
compared is the mesh and the plan. These functions take plain numpy arrays
(for instance read off the reference package's MeshArrays,
BandedKernelPlan, EikonalKernelPlan, OffsetPlan and SweepPlan), so either
side can be fed the other's exact inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from mesh_navigation_torch.device import resolve_device
from mesh_navigation_torch.mesh.arrays import FIELDS, MeshArrays, from_host_tables
from mesh_navigation_torch.ops.banded_gpu import (
    PLAN_ARRAYS, PLAN_META, BandedKernelPlan, with_xlane_lists,
)
from mesh_navigation_torch.ops.eikonal_gpu import (
    EIK_PLAN_ARRAYS, EIK_PLAN_META, EikonalKernelPlan,
)
from mesh_navigation_torch.ops.ordered import SweepPlan
from mesh_navigation_torch.ops.structured import (
    OFFSET_PLAN_ARRAYS, OFFSET_PLAN_META, OffsetPlan,
)


def mesh_from_numpy(arrays: dict, *, device=None) -> MeshArrays:
    """MeshArrays from a dict of numpy arrays holding every field of FIELDS."""
    missing = [k for k in FIELDS if k not in arrays]
    if missing:
        raise ValueError(f"mesh_from_numpy: missing fields {missing}")
    return from_host_tables({k: np.array(arrays[k]) for k in FIELDS}, device)


def plan_from_numpy(arrays: dict, meta: dict, *, device=None) -> BandedKernelPlan:
    """BandedKernelPlan from a dict of numpy arrays (fields of PLAN_ARRAYS;
    absent or None ones stay None) and a dict of its scalar fields
    (PLAN_META), with the lists of its extended lanes."""
    dev = resolve_device(device)
    fields = {}
    for k in PLAN_ARRAYS:
        a = arrays.get(k)
        fields[k] = None if a is None else torch.from_numpy(np.array(a)).to(dev)
    for k in PLAN_META:
        if k in meta:
            fields[k] = tuple(meta[k]) if k.startswith("xlanes") else meta[k]
    return with_xlane_lists(BandedKernelPlan(**fields))


def eikonal_plan_from_numpy(arrays: dict, meta: dict, *, device=None) -> EikonalKernelPlan:
    """EikonalKernelPlan from a dict of numpy arrays (every field of
    EIK_PLAN_ARRAYS) and a dict of its scalar fields (EIK_PLAN_META)."""
    dev = resolve_device(device)
    missing = [k for k in (*EIK_PLAN_ARRAYS, *EIK_PLAN_META) if k not in arrays and k not in meta]
    if missing:
        raise ValueError(f"eikonal_plan_from_numpy: missing fields {missing}")
    fields = {k: torch.from_numpy(np.array(arrays[k])).to(dev) for k in EIK_PLAN_ARRAYS}
    for k in EIK_PLAN_META:
        v = meta[k]
        fields[k] = tuple(tuple(int(x) for x in c) for c in v) if k.startswith("classes") else v
    return EikonalKernelPlan(**fields)


def offset_plan_from_numpy(arrays: dict, meta: dict, *, device=None) -> OffsetPlan:
    """OffsetPlan from a dict of numpy arrays (every field of
    OFFSET_PLAN_ARRAYS) and its static `offsets` and `coverage`."""
    dev = resolve_device(device)
    missing = [k for k in OFFSET_PLAN_ARRAYS if k not in arrays]
    missing += [k for k in OFFSET_PLAN_META if k not in meta]
    if missing:
        raise ValueError(f"offset_plan_from_numpy: missing fields {missing}")
    fields = {k: torch.from_numpy(np.array(arrays[k])).to(dev) for k in OFFSET_PLAN_ARRAYS}
    return OffsetPlan(offsets=tuple(int(o) for o in meta["offsets"]),
                      coverage=float(meta["coverage"]), **fields)


def sweep_plan_from_numpy(chunks, num_vertices: int, *, device=None) -> SweepPlan:
    """SweepPlan from its [n_dir, n_chunks, C] chunk table (padding: the
    dummy vertex num_vertices)."""
    chunks = np.asarray(chunks)
    if chunks.ndim != 3:
        raise ValueError(f"sweep_plan_from_numpy: chunks must be 3-D, got {chunks.shape}")
    return SweepPlan(chunks=torch.from_numpy(chunks.astype(np.int32)).to(resolve_device(device)),
                     num_vertices=int(num_vertices))
