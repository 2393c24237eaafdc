"""Structured (offset-classed) relaxation (port of mesh_navigation_tpu/ops/structured.py).

On a band-ordered mesh most adjacency slots share a few constant index
offsets δ = neighbour − vertex. Each such class relaxes as a shift of the
[V, B] label matrix plus a weight plane, which the fused sweep
(ops/sweep_gpu.py, csrc/fused_sweep.cu) applies tile by tile; edges outside
the top-K classes form a sparse residual relaxed by a scatter-min after each
sweep. The loop reaches the exact Dijkstra fixed point: every relaxation is
one f32 add and a min, so the least fixed point does not depend on the
schedule.

`build_offset_plan` classifies on the host from the mesh adjacency alone;
`refresh_offset_planes` re-derives the weights on the device after a cost
change.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mesh_navigation_torch.device import resolve_device
from mesh_navigation_torch.mesh.arrays import MeshArrays, host_array
from mesh_navigation_torch.ops import sweep_gpu
from mesh_navigation_torch.utils.timing import stage as _stage

INF = float("inf")
OFFSET_PLAN_ARRAYS = ("planes", "res_dst", "res_src", "res_w", "slot_map", "res_slot")
OFFSET_PLAN_META = ("offsets", "coverage")


@dataclasses.dataclass(frozen=True)
class OffsetPlan:
    """Offset classification of a slot-weight table (structured.py:39-60).
    The classes, slot maps and residual indices depend only on the mesh
    adjacency; lethal edges are +inf plane entries, so a cost change needs
    only refresh_offset_planes."""
    offsets: tuple[int, ...]      # offset classes, most frequent first
    planes: torch.Tensor          # [K, V] f32 weight of the edge into v from v + off_k
    res_dst: torch.Tensor         # [R] i32 residual edge destinations
    res_src: torch.Tensor         # [R] i32 residual edge sources
    res_w: torch.Tensor           # [R] f32
    slot_map: torch.Tensor        # [K, V] i32 adjacency slot per class (-1 = none)
    res_slot: torch.Tensor        # [R] i32 adjacency slot per residual (-1 = pad)
    coverage: float               # fraction of edges in offset classes

    @property
    def device(self) -> torch.device:
        return self.planes.device

    @property
    def has_residual(self) -> bool:
        """True when some residual entry is a real edge (not padding)."""
        return bool((self.res_slot >= 0).any())

    def to(self, device) -> "OffsetPlan":
        dev = resolve_device(device)
        return dataclasses.replace(
            self, **{k: getattr(self, k).to(dev) for k in OFFSET_PLAN_ARRAYS}
        )


def build_offset_plan(
    mesh: MeshArrays,
    weights_vd,
    *,
    max_offsets: int = 12,
    device=None,
) -> OffsetPlan:
    """Host-side offset classification of the [V, D] slot-weight table
    (structured.py:63-115), on the mesh's device unless `device` says
    otherwise. The classes and slot maps come from the adjacency alone, so
    every structural edge stays addressable by refresh_offset_planes."""
    dev = mesh.device if device is None else resolve_device(device)
    adj = host_array(mesh, "adj_vertex")
    mask = host_array(mesh, "adj_mask")
    W = weights_vd.cpu().numpy() if isinstance(weights_vd, torch.Tensor) else np.asarray(weights_vd)
    V, D = adj.shape
    delta = adj - np.arange(V)[:, None]
    vals, cnts = np.unique(delta[mask], return_counts=True)
    order = np.argsort(-cnts)
    top = [int(v) for v in vals[order][:max_offsets] if v != 0]
    covered = np.zeros_like(mask)
    planes = np.full((len(top), V), np.inf, np.float32)
    slot_map = np.full((len(top), V), -1, np.int32)
    for k, d in enumerate(top):
        hit = (delta == d) & mask
        rows, slots = np.nonzero(hit)
        planes[k, rows] = W[rows, slots]
        slot_map[k, rows] = slots
        covered |= hit
    residual = mask & ~covered
    rows, slots = np.nonzero(residual)
    coverage = 1.0 - len(rows) / max(mask.sum(), 1)
    # the residual is padded to a multiple of 8 with self-loops at +inf
    R = len(rows)
    Rp = max(8, -(-R // 8) * 8)
    res_dst = np.zeros(Rp, np.int32)
    res_src = np.zeros(Rp, np.int32)
    res_slot = np.full(Rp, -1, np.int32)
    res_w = np.full(Rp, np.inf, np.float32)
    res_dst[:R] = rows
    res_src[:R] = adj[rows, slots]
    res_slot[:R] = slots
    res_w[:R] = W[rows, slots]
    t = lambda a: torch.from_numpy(a).to(dev)   # noqa: E731
    return OffsetPlan(
        offsets=tuple(top), planes=t(planes), res_dst=t(res_dst), res_src=t(res_src),
        res_w=t(res_w), slot_map=t(slot_map), res_slot=t(res_slot), coverage=float(coverage),
    )


def refresh_offset_planes(plan: OffsetPlan, weights_vd: torch.Tensor) -> OffsetPlan:
    """Re-derive the weight planes and residual weights from a new [V, D]
    slot-weight table, on the device (structured.py:118-135). The
    classification is kept."""
    W = weights_vd.to(plan.device, torch.float32)
    slot = plan.slot_map.long()
    planes = torch.where(slot >= 0, W.gather(1, slot.clamp(min=0).T).T, INF)
    rslot = plan.res_slot.long()
    res_w = torch.where(rslot >= 0, W[plan.res_dst.long(), rslot.clamp(min=0)], INF)
    return dataclasses.replace(plan, planes=planes.contiguous(), res_w=res_w)


def default_tile(plan: OffsetPlan) -> int:
    """The port's tile: the smallest multiple of 256 that holds the largest
    offset. The reference sizes its tile by a TPU VMEM budget instead
    (structured.py:174-177: at most 1024 rows), which leaves the 1M-vertex
    terrain's offsets of ±1025 outside the tile and its Pallas kernel
    unused; a CUDA block needs only its window to fit in shared memory."""
    max_off = max((abs(o) for o in plan.offsets), default=1)
    return 256 * max(1, -(-max_off // 256))


def default_n_inner(plan: OffsetPlan, tile: int) -> int:
    """Relaxations per tile and sweep, enough for a label to cross the tile
    (structured.py:178-181)."""
    max_off = max((abs(o) for o in plan.offsets), default=1)
    return int(np.clip(-(-tile // max(max_off, 1)), 2, 12))


def seeded_padded(V: int, seeds: torch.Tensor, tile: int, dtype=torch.float32) -> torch.Tensor:
    """The [T + Vp + T, B] start matrix of `dtype`: 0 at each lane's seed
    vertex, +inf elsewhere, Vp the vertex count rounded up to the tile."""
    B = seeds.shape[0]
    Vp = -(-V // tile) * tile
    dp = torch.full((tile + Vp + tile, B), INF, dtype=dtype, device=seeds.device)
    dp[seeds.long() + tile, torch.arange(B, device=seeds.device)] = 0.0
    return dp


@dataclasses.dataclass(frozen=True)
class StructuredFieldResult:
    dist: torch.Tensor      # [B, V] f32 (a transposed view of the [V, B] field)
    pred: torch.Tensor      # [B, V] i32 (a transposed view)
    sweeps: int
    converged: bool


def batched_field_structured(
    mesh: MeshArrays,
    weights_vd: torch.Tensor,    # [V, D]
    plan: OffsetPlan,
    seeds: torch.Tensor,         # [B]
    *,
    block_sweeps: int = 16,
    max_sweeps: int = 0,
    tile: int = 0,
    n_inner: int = 0,
    dtype=torch.float32,
    timer=None,
) -> StructuredFieldResult:
    """Batched SSSP by fused offset-shift sweeps + the residual scatter-min,
    [V, B] layout (structured.py:145-259, its fused-kernel branch): one
    sweep, then blocks of `block_sweeps` sweeps while the block changed a
    label (one host read per block) and fewer than `max_sweeps` (0: 4V)
    were run. `tile` / `n_inner` (0: default_tile / default_n_inner) set the
    schedule. Three [T + Vp + T, B] buffers live during the loop: the
    block's input and two that the sweeps alternate between. `timer`
    records the solve, solve_check and pred stages.

    dtype=torch.bfloat16 is the approximate mode (structured.py:156-162,
    :200-245): the matrix, the weight planes and the residual weights are
    all bfloat16 and every add is a bfloat16 add; the field comes out as
    f32 and its predecessors are recovered in f32 at tol 1e-2. A monotone
    rounded min-plus operator iterated from +inf stops at the greatest
    fixed point below the start under any schedule, so the field equals
    the reference's roll path bit for bit."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the structured solve stores f32 or bfloat16 fields, not {dtype}")
    V, _ = weights_vd.shape
    B = seeds.shape[0]
    if max_sweeps <= 0:
        max_sweeps = 4 * V
    cap = -(-max_sweeps // block_sweeps) * block_sweeps
    if tile <= 0:
        tile = default_tile(plan)
    if n_inner <= 0:
        n_inner = default_n_inner(plan, tile)
    T = tile
    Vp = -(-V // T) * T
    dev = weights_vd.device
    planes_p = torch.full((len(plan.offsets), Vp), INF, dtype=dtype, device=dev)
    planes_p[:, :V] = plan.planes.to(dtype)
    has_residual = plan.has_residual
    if has_residual:
        res_src = plan.res_src.long() + T
        res_idx = (plan.res_dst.long() + T)[:, None].expand(-1, B)
        res_w = plan.res_w.to(dtype)[:, None]

    def sweep(d, out):
        d = sweep_gpu.fused_sweep(d, planes_p, plan.offsets, tile=T, n_inner=n_inner, out=out)
        if has_residual:
            d.scatter_reduce_(0, res_idx, d[res_src] + res_w, "amin")
        return d

    with _stage(timer, "solve"):
        d0 = seeded_padded(V, seeds.to(dev), T, dtype)
        d = sweep(d0, None)
        bufs = [d0, torch.empty_like(d)]
    sweeps, changed = 1, True
    while changed and sweeps < cap:
        with _stage(timer, "solve"):
            new = d
            for j in range(block_sweeps):
                new = sweep(new, bufs[j % 2])
            sweeps += block_sweeps
        with _stage(timer, "solve_check"):
            changed = bool((new < d).any())
        # the next block's first sweep must not write over its own input
        bufs = [d, bufs[block_sweeps % 2]]
        d = new
    dist = d[T:T + V].to(torch.float32)
    with _stage(timer, "pred"):
        pred = predecessors_from_field(mesh, weights_vd, dist,
                                       tol=1e-6 if dtype == torch.float32 else 1e-2)
    return StructuredFieldResult(dist=dist.T, pred=pred.T, sweeps=sweeps, converged=not changed)


def predecessors_from_field(
    mesh: MeshArrays,
    weights_vd: torch.Tensor,   # [V, D]
    dist_vb: torch.Tensor,      # [V, B] converged field
    *,
    tol: float = 1e-6,
) -> torch.Tensor:
    """Predecessor ids [V, B] i32 of a converged field (structured.py:262-284):
    pred[v] = the neighbour u minimising dist[u] + w(u, v), the first slot
    on ties (strict < in slot order), kept where it explains dist[v] within
    tol; v itself at seeds, unreached vertices and unexplained labels. Slot
    by slot, so no [V, D, B] buffer is built."""
    V, D = weights_vd.shape
    adj = mesh.adj_vertex.long()
    best = torch.full_like(dist_vb, INF)
    arg = torch.zeros(dist_vb.shape, dtype=torch.int64, device=dist_vb.device)
    for j in range(D):
        cand = dist_vb[adj[:, j]] + weights_vd[:, j, None]
        better = cand < best
        best = torch.where(better, cand, best)
        arg = torch.where(better, j, arg)
    has = (best <= dist_vb * (1 + tol) + tol) & (dist_vb > 0) & torch.isfinite(dist_vb)
    vidx = torch.arange(V, device=dist_vb.device)[:, None]
    return torch.where(has, adj.gather(1, arg), vidx).to(torch.int32)
