"""SPMD scale-out over ranks: the mesh sharded by vertex block, scenarios by
lane block (port of mesh_navigation_tpu/parallel/sharded.py:36-138).

- **"mesh" axis**: the [V, D] slot-weight and adjacency tables are cut into
  vertex blocks, one a rank of the axis; each sweep a rank updates only
  its block after an all_gather of the field over the axis.
- **"batch" axis**: the lanes are cut into blocks, one a rank of the axis.
- Convergence: every `block_sweeps` sweeps one all-reduce (SUM) of the
  changed flag over every rank, so all ranks sweep in lockstep.

Plain torch, as the reference's is XLA code: no kernel runs here. Tensors
travel by parallel/comm.py's rule.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from mesh_navigation_torch.mesh.arrays import MeshArrays, host_array
from mesh_navigation_torch.parallel import distributed
from mesh_navigation_torch.parallel.comm import Comm

INF = float("inf")


def make_device_mesh(n_mesh: int, n_batch: int) -> distributed.DeviceGrid:
    """The ('mesh', 'batch') grid of n_mesh x n_batch ranks: the process
    group must hold exactly that many (one process for a 1 x 1 grid)."""
    return distributed.make_grid(n_mesh, n_batch)


class ShardedMeshWeights(NamedTuple):
    """Vertex-sharded relaxation tables on the host, padded to a multiple of
    the mesh axis. Global vertex ids are kept (adjacency points into the
    gathered global field)."""
    adj_vertex: torch.Tensor   # [Vp, D] i32 global neighbour ids (pad rows: 0)
    weights: torch.Tensor      # [Vp, D] f32 slot weights (inf = unusable)
    num_vertices: int          # true V (before padding)


def _host_f32(x) -> torch.Tensor:
    """A float32 table (numpy or a tensor on any device) as a host tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32).contiguous()
    return torch.from_numpy(np.array(x, dtype=np.float32))


def shard_weights(mesh: MeshArrays, weights_vd, n_mesh: int) -> ShardedMeshWeights:
    """Pad the [V, D] tables so the vertex axis divides the mesh axis."""
    w = _host_f32(weights_vd)
    V, D = w.shape
    Vp = -(-V // n_mesh) * n_mesh
    adj = torch.zeros((Vp, D), dtype=torch.int32)
    adj[:V] = torch.from_numpy(host_array(mesh, "adj_vertex"))
    wp = torch.full((Vp, D), INF, dtype=torch.float32)
    wp[:V] = w
    return ShardedMeshWeights(adj_vertex=adj, weights=wp, num_vertices=V)


def gather_grid_blocks(comm: Comm, grid: distributed.DeviceGrid, block: torch.Tensor,
                       row_axis: str) -> torch.Tensor:
    """Every rank's block of a field, assembled on every rank: `block` is
    [rows, cols] with rows along `row_axis` ("mesh" or "batch") of the grid
    and cols along the other axis; returns the [n_rows * rows, n_cols *
    cols] whole, by each rank's coordinates."""
    n_mesh, n_batch = grid.shape["mesh"], grid.shape["batch"]
    world = n_mesh * n_batch
    blocks = comm.all_gather(block.contiguous(), None, world)
    r, c = block.shape
    n_r, n_c = (n_mesh, n_batch) if row_axis == "mesh" else (n_batch, n_mesh)
    out = block.new_empty((n_r * r, n_c * c))
    for rank, blk in enumerate(blocks):
        b, m = divmod(rank, n_mesh)
        i, j = (m, b) if row_axis == "mesh" else (b, m)
        out[i * r:(i + 1) * r, j * c:(j + 1) * c] = blk
    return out


def any_changed(comm: Comm, changed: torch.Tensor, group, n: int) -> bool:
    """One all-reduce (SUM) of a rank's changed flag over `group` (None:
    every rank), an axis of `n` ranks; True where any rank changed. One
    host read."""
    flag = changed.reshape(1).to(torch.int32)
    return int(comm.all_reduce_(flag, dist.ReduceOp.SUM, group, n).item()) > 0


def sharded_field_solve(
    sharded: ShardedMeshWeights,
    seeds,                       # [B] goal vertices (the batch axis)
    grid: distributed.DeviceGrid,
    *,
    max_sweeps: int = 0,
    block_sweeps: int = 8,
    device=None,
) -> torch.Tensor:
    """Batched SSSP fields with the mesh sharded over 'mesh' and the lanes
    over 'batch'. Returns dist [B, Vp] on every rank, on its device (row b
    seeded at seeds[b]). Per rank: its field block [b_loc, V_loc] ->
    all_gather over 'mesh' -> pull relaxation of its block; every
    `block_sweeps` sweeps the changed flag is all-reduced over all ranks."""
    dev = distributed.local_device(device)
    comm = Comm(dev)
    n_mesh, n_batch = grid.shape["mesh"], grid.shape["batch"]
    Vp, D = sharded.weights.shape
    seeds = torch.as_tensor(seeds).cpu().long()
    B = seeds.shape[0]
    if Vp % n_mesh or B % n_batch:
        raise ValueError(f"{Vp} vertices or {B} lanes do not divide the ({n_mesh}, {n_batch}) grid")
    if max_sweeps <= 0:
        max_sweeps = 4 * Vp
    n_blocks = -(-max_sweeps // block_sweeps)
    V_loc, b_loc = Vp // n_mesh, B // n_batch
    lo = grid.mesh_index * V_loc
    adj = sharded.adj_vertex[lo:lo + V_loc].to(dev, torch.int64)
    w = sharded.weights[lo:lo + V_loc].to(dev)
    seeds_loc = seeds[grid.batch_index * b_loc:(grid.batch_index + 1) * b_loc].to(dev)
    gidx = lo + torch.arange(V_loc, device=dev)
    d = torch.where(gidx[None, :] == seeds_loc[:, None], 0.0, INF).to(torch.float32)

    def one_sweep(d_loc: torch.Tensor) -> torch.Tensor:
        # halo exchange: the whole field over the mesh axis
        full = torch.cat(comm.all_gather(d_loc, grid.mesh_group, n_mesh), dim=1)   # [b_loc, Vp]
        best = (full[:, adj] + w[None, :, :]).amin(dim=-1)                          # [b_loc, V_loc]
        return torch.minimum(d_loc, best)

    it, changed = 0, True
    while changed and it < n_blocks * block_sweeps:
        new = d
        for _ in range(block_sweeps):
            new = one_sweep(new)
        changed = any_changed(comm, (new < d).any(), None, n_mesh * n_batch)
        d, it = new, it + block_sweeps
    return gather_grid_blocks(comm, grid, d, row_axis="batch")
