"""Spatial mesh partition with explicit halo (ghost) tables (port of
mesh_navigation_tpu/parallel/partition.py:38-256).

sharded.py gathers the whole field every sweep: O(V) of traffic. Here

1. vertices are sorted x-major (ties y) and cut into contiguous blocks, one
   a shard, so almost every edge stays inside a shard;
2. each shard precomputes its DIRECTED export lists: the local vertices its
   left / right neighbour's adjacency reads (the halo ring);
3. each shard's adjacency is remapped so that a remote neighbour indexes
   the concatenation [local block | ghosts from the left | ghosts from the
   right];
4. each sweep only the rings travel: on a neighbour-only cut one
   batch_isend_irecv with each neighbour, else an all_gather of every
   shard's exports.

The relaxation inside a shard is the unrolled slot pull of
ops/ordered.batched_field_hybrid; convergence is one all-reduce a block of
sweeps. The host tables are built in numpy, bit for bit the reference's;
the solve is plain torch (the reference's is XLA code), its tensors
travelling by parallel/comm.py's rule.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mesh_navigation_torch.mesh.arrays import MeshArrays, host_array
from mesh_navigation_torch.parallel import distributed
from mesh_navigation_torch.parallel.comm import Comm
from mesh_navigation_torch.parallel.sharded import any_changed, gather_grid_blocks

INF = float("inf")


class MeshPartition(NamedTuple):
    """Host partition tables (leading axes: one entry a shard).

    Ghost slots of a shard: [0, Vl) local, [Vl, Vl+XR) ghosts received from
    the LEFT neighbour (its exp_right), [Vl+XR, Vl+XR+XL) ghosts from the
    RIGHT neighbour (its exp_left). `neighbor_only` records whether every
    remote reference crosses exactly one cut (true for spatial block cuts of
    planar meshes); where it is False the solve gathers every shard's
    export_idx list instead."""
    adj: torch.Tensor          # [n, Vl, D] i32 remapped (layout above)
    weights: torch.Tensor      # [n, Vl, D] f32 (inf = unusable or padding)
    export_idx: torch.Tensor   # [n, X] i32 all_gather-mode exports (pad 0)
    exp_right: torch.Tensor    # [n, XR] i32 local ids exported to s+1 (pad 0)
    exp_left: torch.Tensor     # [n, XL] i32 local ids exported to s-1 (pad 0)
    perm: torch.Tensor         # [V] i32 new order -> original vertex id
    inv_perm: torch.Tensor     # [V] i32 original -> new order
    num_vertices: int
    block: int                 # Vl
    neighbor_only: bool

    @property
    def n_shards(self) -> int:
        return self.adj.shape[0]


def build_partition(mesh: MeshArrays, weights_vd, n_shards: int) -> MeshPartition:
    """Host side: sort by x (ties y), cut into blocks, build the halo
    tables."""
    pos = host_array(mesh, "vertices")
    adj = host_array(mesh, "adj_vertex")
    W = (weights_vd.detach().cpu().numpy() if isinstance(weights_vd, torch.Tensor)
         else np.asarray(weights_vd))
    V, D = adj.shape

    order = np.lexsort((pos[:, 1], pos[:, 0])).astype(np.int32)   # new -> old
    inv = np.empty(V, np.int32)
    inv[order] = np.arange(V, dtype=np.int32)

    Vl = -(-V // n_shards)
    Vp = Vl * n_shards

    # renumbered adjacency (padded tail rows point at 0 with inf weight)
    adj_new = np.full((Vp, D), 0, np.int32)
    w_new = np.full((Vp, D), np.inf, np.float32)
    adj_new[:V] = inv[adj[order]]
    w_new[:V] = W[order]

    shard_of = np.arange(Vp) // Vl

    # usable remote references of each shard, by owner
    neighbor_only = True
    refs_by_pair: dict[tuple[int, int], np.ndarray] = {}
    for s in range(n_shards):
        rows = adj_new[s * Vl:(s + 1) * Vl]
        usable = np.isfinite(w_new[s * Vl:(s + 1) * Vl])
        remote = (shard_of[rows] != s) & usable
        ext = rows[remote]
        owners = shard_of[ext]
        if np.any(np.abs(owners - s) > 1):
            neighbor_only = False
        for o in np.unique(owners):
            key = (int(o), s)   # owner o exports to shard s
            prev = refs_by_pair.get(key)
            cur = np.unique(ext[owners == o])
            refs_by_pair[key] = cur if prev is None else np.union1d(prev, cur)

    # all_gather exports: the union of everything each owner exports
    per_owner: list[np.ndarray] = []
    for s in range(n_shards):
        outs = [v for (o, _), v in refs_by_pair.items() if o == s]
        per_owner.append(np.unique(np.concatenate(outs)) if outs else np.zeros(0, np.int64))
    X = max(1, max((len(p) for p in per_owner), default=1))
    export_idx = np.zeros((n_shards, X), np.int32)
    ghost_slot = np.full(Vp, -1, np.int64)
    for s, p in enumerate(per_owner):
        export_idx[s, :len(p)] = (p - s * Vl).astype(np.int32)
        ghost_slot[p] = s * X + np.arange(len(p))

    # ring exports: owner -> owner+1 and owner -> owner-1
    er = [refs_by_pair.get((s, s + 1), np.zeros(0, np.int64)) for s in range(n_shards)]
    el = [refs_by_pair.get((s, s - 1), np.zeros(0, np.int64)) for s in range(n_shards)]
    XR = max(1, max(len(p) for p in er))
    XL = max(1, max(len(p) for p in el))
    exp_right = np.zeros((n_shards, XR), np.int32)
    exp_left = np.zeros((n_shards, XL), np.int32)
    # ring ghost slot of a global new id, per RECEIVING shard
    ring_slot = np.full((n_shards, Vp), -1, np.int64)
    for s in range(n_shards):
        exp_right[s, :len(er[s])] = (er[s] - s * Vl).astype(np.int32)
        exp_left[s, :len(el[s])] = (el[s] - s * Vl).astype(np.int32)
        if s + 1 < n_shards:
            ring_slot[s + 1, er[s]] = Vl + np.arange(len(er[s]))
        if s - 1 >= 0:
            ring_slot[s - 1, el[s]] = Vl + XR + np.arange(len(el[s]))

    # remap each shard's adjacency
    adj_shard = np.zeros((n_shards, Vl, D), np.int32)
    w_shard = np.zeros((n_shards, Vl, D), np.float32)
    for s in range(n_shards):
        rows = adj_new[s * Vl:(s + 1) * Vl].copy()
        w_rows = w_new[s * Vl:(s + 1) * Vl].copy()
        local = shard_of[rows] == s
        usable_remote = ~local & np.isfinite(w_rows)
        slot = ring_slot[s, rows] if neighbor_only else Vl + ghost_slot[rows]
        out = np.where(local, rows - s * Vl, 0)
        ok = usable_remote & (slot >= 0)
        out = np.where(ok, slot, out)
        w_rows = np.where(~local & ~ok, np.inf, w_rows)
        adj_shard[s] = out
        w_shard[s] = w_rows
    t = torch.from_numpy
    return MeshPartition(
        adj=t(adj_shard), weights=t(w_shard), export_idx=t(export_idx),
        exp_right=t(exp_right), exp_left=t(exp_left), perm=t(order), inv_perm=t(inv),
        num_vertices=V, block=Vl, neighbor_only=bool(neighbor_only),
    )


def partitioned_field_solve(
    part: MeshPartition,
    seeds,                       # [B] ORIGINAL vertex ids
    grid: distributed.DeviceGrid,
    *,
    max_sweeps: int = 0,
    block_sweeps: int = 8,
    device=None,
) -> torch.Tensor:
    """Batched SSSP over the partition: the mesh axis holds the spatial
    shards and exchanges boundary rings only (one batch_isend_irecv with
    each neighbour a sweep on a neighbour-only cut, else an all_gather of
    the exports); the batch axis holds blocks of lanes. Returns dist [B, V]
    in ORIGINAL vertex order on every rank, on its device."""
    n, Vl, D = part.adj.shape
    if grid.shape["mesh"] != n:
        raise ValueError(f"the partition has {n} shards, the grid's mesh axis {grid.shape['mesh']}")
    dev = distributed.local_device(device)
    comm = Comm(dev)
    n_batch = grid.shape["batch"]
    seeds = torch.as_tensor(seeds).cpu().long()
    B = seeds.shape[0]
    if B % n_batch:
        raise ValueError(f"{B} lanes do not divide the batch axis of {n_batch}")
    if max_sweeps <= 0:
        max_sweeps = 4 * n * Vl
    n_blocks = -(-max_sweeps // block_sweeps)
    ring = part.neighbor_only and n > 1
    m = grid.mesh_index
    b_loc = B // n_batch

    seeds_new = part.inv_perm.long()[seeds]
    seeds_loc = seeds_new[grid.batch_index * b_loc:(grid.batch_index + 1) * b_loc].to(dev)
    adj = part.adj[m].to(dev, torch.int64)
    w = part.weights[m].to(dev)
    exp_loc = part.export_idx[m].to(dev, torch.int64)
    er_idx = part.exp_right[m].to(dev, torch.int64)
    el_idx = part.exp_left[m].to(dev, torch.int64)
    gidx = m * Vl + torch.arange(Vl, device=dev)
    dist0 = torch.where(gidx[:, None] == seeds_loc[None, :], 0.0, INF).to(torch.float32)

    # ring ghosts: an end shard receives nothing on its open side, and every
    # slot that would read there carries +inf weight (no such edge exists)
    gl = torch.full((er_idx.shape[0], b_loc), INF, device=dev)
    gr = torch.full((el_idx.shape[0], b_loc), INF, device=dev)
    left = grid.mesh_ranks[m - 1] if m > 0 else None
    right = grid.mesh_ranks[m + 1] if m + 1 < n else None
    adj_cols = [adj[:, j] for j in range(D)]
    w_cols = [w[:, j][:, None] for j in range(D)]

    def one_sweep(d: torch.Tensor) -> torch.Tensor:
        if ring:
            sends, recvs = [], []
            if right is not None:
                sends.append((d[er_idx], right))
                recvs.append((gr, right))
            if left is not None:
                sends.append((d[el_idx], left))
                recvs.append((gl, left))
            comm.exchange(sends, recvs)
            full = torch.cat([d, gl, gr])
        else:
            ghosts = comm.all_gather(d[exp_loc], grid.mesh_group, n)
            full = torch.cat([d, *ghosts])
        best = d
        for j in range(D):
            best = torch.minimum(best, full[adj_cols[j]] + w_cols[j])
        return best

    d = one_sweep(dist0)
    it, changed = 0, True
    while changed and it < n_blocks * block_sweeps:
        new = d
        for _ in range(block_sweeps):
            new = one_sweep(new)
        changed = any_changed(comm, (new < d).any(), None, n * n_batch)
        d, it = new, it + block_sweeps
    dist_new = gather_grid_blocks(comm, grid, d, row_axis="mesh")    # [n * Vl, B] new order
    return dist_new.T[:, part.inv_perm.long().to(dev)]
