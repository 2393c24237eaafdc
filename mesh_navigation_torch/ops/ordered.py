"""Ordered (fast-sweeping-style) Gauss-Seidel relaxation passes and the
hybrid batch solve (port of mesh_navigation_tpu/ops/ordered.py).

Plain Jacobi sweeps propagate labels one hop per sweep. Relaxing vertices in
a monotone spatial order lets a label cross the mesh in one pass, so a few
rounds over signed coordinate orderings carry the bulk of the labels. The
vertices are sorted along each signed key on the host and cut into chunks of
about one geometric row; a round relaxes the chunks in order, Gauss-Seidel
across chunks and Jacobi inside one. The field lives in [V + 1, B] layout
(row V a dummy that padded chunk entries read and write harmlessly), so a
gather moves whole rows of B lanes.

The hybrid solve (the batch planner's) runs `ordered_rounds` such rounds,
then blocks of Jacobi sweeps, one relaxation per adjacency slot, until a
block changes nothing; the predecessors come from one arg-min pass against
the converged field. No TPU kernel is behind any of it: plain torch, with
buffers reused where the reference's pure functions allocate (a sweep and
the arg-min pass keep [V, B] buffers and update them in place).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mesh_navigation_torch.mesh.arrays import MeshArrays, host_array

# signed coordinate keys of the fast-sweeping orderings, in the reference's order
_SIGNS = ((1, 1, 1), (-1, -1, -1), (1, -1, 1), (-1, 1, -1),
          (1, 1, -1), (-1, -1, 1), (1, -1, -1), (-1, 1, 1))


class SweepPlan(NamedTuple):
    """Static ordering data: chunks[d] rows are the level chunks of
    direction d, in monotone key order; padding entries point at the dummy
    vertex V."""
    chunks: torch.Tensor     # [n_dir, n_chunks, C] i32
    num_vertices: int

    @property
    def n_dir(self) -> int:
        return self.chunks.shape[0]


def build_sweep_plan(mesh: MeshArrays, *, chunk: int = 0, directions: int = 4,
                     device=None) -> SweepPlan:
    """Host-side: sort the vertices along signed coordinate keys (stable
    argsort). `chunk` defaults to ~sqrt(V) rounded to a multiple of 8, at
    least 64: about one geometric row a chunk. The plan goes to `device`
    (default: the mesh's)."""
    pos = host_array(mesh, "vertices")
    V = len(pos)
    if chunk <= 0:
        chunk = max(64, int(8 * round(np.sqrt(V) / 8)))
    signs = _SIGNS[:directions]
    n_chunks = -(-V // chunk)
    out = np.full((len(signs), n_chunks, chunk), V, dtype=np.int32)
    for d, s in enumerate(signs):
        key = pos[:, 0] * s[0] + pos[:, 1] * s[1] + pos[:, 2] * s[2]
        out[d].reshape(-1)[:V] = np.argsort(key, kind="stable").astype(np.int32)
    dev = mesh.device if device is None else torch.device(device)
    return SweepPlan(chunks=torch.from_numpy(out).to(dev), num_vertices=V)


class OrderedFieldResult(NamedTuple):
    dist: torch.Tensor    # [B, V] f32
    pred: torch.Tensor    # [B, V] i32
    rounds: int
    converged: bool


def _seeded(V: int, seeds: torch.Tensor, device) -> torch.Tensor:
    """[V + 1, B] f32: 0 at each lane's seed, +inf elsewhere."""
    rows = torch.arange(V + 1, dtype=torch.int64, device=device)
    return torch.where(rows[:, None] == seeds.to(device, torch.int64)[None, :], 0.0,
                       torch.inf).to(torch.float32)


def _one_round(d: torch.Tensor, plan: SweepPlan, adj_x: torch.Tensor, w_x: torch.Tensor,
               n_inner: int = 1) -> None:
    """One ordered round in place on d [V + 1, B]: every chunk of every
    direction in order, each relaxed n_inner times against the live field."""
    chunks = plan.chunks.to(torch.int64)
    for rows_d in chunks:
        for rows in rows_d:
            a = adj_x[rows]                                   # [C, D]
            w = w_x[rows][..., None]                          # [C, D, 1]
            for _ in range(n_inner):
                cand = torch.amin(d[a] + w, dim=1)            # [C, B]
                d[rows] = torch.minimum(d[rows], cand)


def _extended(mesh: MeshArrays, weights_vd: torch.Tensor):
    """The adjacency and slot weights with the dummy row V (neighbour V - 1,
    weight +inf) appended."""
    V, D = weights_vd.shape
    adj = mesh.adj_vertex.to(weights_vd.device, torch.int64)
    adj_x = torch.cat([adj, torch.full((1, D), V - 1, dtype=torch.int64, device=adj.device)])
    w_x = torch.cat([weights_vd, torch.full((1, D), torch.inf, dtype=weights_vd.dtype,
                                            device=weights_vd.device)])
    return adj_x, w_x


def batched_field_ordered(
    mesh: MeshArrays,
    weights_vd: torch.Tensor,    # [V, D] effective slot weights (sweeps.slot_weights)
    plan: SweepPlan,
    seeds: torch.Tensor,         # [B] vertex ids
    *,
    max_rounds: int = 64,
    n_inner: int = 1,
) -> OrderedFieldResult:
    """Batched single-source fields by ordered rounds until a round changes
    nothing (one host read a round) or `max_rounds`: the fixed point of the
    Jacobi solve (= heap Dijkstra). Predecessors by one arg-min pass against
    the converged field (_finish)."""
    V = weights_vd.shape[0]
    adj_x, w_x = _extended(mesh, weights_vd)
    d = _seeded(V, seeds, weights_vd.device)
    _one_round(d, plan, adj_x, w_x, n_inner)
    rounds, changed = 1, True
    while changed and rounds < max_rounds:
        before = d.clone()
        _one_round(d, plan, adj_x, w_x, n_inner)
        rounds += 1
        changed = bool((d < before).any())
        del before
    return _finish(mesh, weights_vd, d[:V], rounds, changed)


def _finish(mesh: MeshArrays, weights_vd: torch.Tensor, dist_v: torch.Tensor, rounds: int,
            changed: bool) -> OrderedFieldResult:
    """pred[v] = the neighbour u minimising dist[u] + w(u, v), the first
    slot of the minimum (the reference's argmin over a [V, D, B] candidate,
    kept here as a running minimum over the slots with strict <), where
    that minimum is within 1e-6 of dist[v] and 0 < dist[v] < inf; else v."""
    V, D = weights_vd.shape
    adj = mesh.adj_vertex.to(dist_v.device, torch.int32)
    best = torch.index_select(dist_v, 0, adj[:, 0])
    best.add_(weights_vd[:, :1])
    pid = adj[:, :1].expand(V, dist_v.shape[1]).clone()
    buf = torch.empty_like(best)
    for j in range(1, D):
        torch.index_select(dist_v, 0, adj[:, j], out=buf)
        buf.add_(weights_vd[:, j:j + 1])
        lt = buf < best
        torch.where(lt, buf, best, out=best)
        torch.where(lt, adj[:, j:j + 1], pid, out=pid)
        del lt
    del buf
    has = (best <= dist_v + 1e-6) & (dist_v > 0) & torch.isfinite(dist_v)
    del best
    vidx = torch.arange(V, dtype=torch.int32, device=dist_v.device)[:, None]
    torch.where(has, pid, vidx, out=pid)
    del has
    return OrderedFieldResult(dist=dist_v.T.contiguous(), pred=pid.T.contiguous(),
                              rounds=int(rounds), converged=not changed)


def batched_field_hybrid(
    mesh: MeshArrays,
    weights_vd: torch.Tensor,
    plan: SweepPlan | None,
    seeds: torch.Tensor,
    *,
    ordered_rounds: int = 2,
    block_sweeps: int = 16,
    max_sweeps: int = 0,
    init_vb: torch.Tensor | None = None,
) -> OrderedFieldResult:
    """`ordered_rounds` ordered rounds for the bulk of the label transport
    (`plan` may be None where there are none), then Jacobi sweeps to the
    exact fixed point: one sweep, then blocks of `block_sweeps` until a
    block changes nothing (one host read a block) or the sweeps reach
    max_sweeps rounded up to whole blocks (0: 4 V). A sweep takes
    min(d[v], d[adj[v, j]] + w[v, j]) slot by slot into a second buffer,
    over the finite slots only.
    `init_vb` [V + 1, B], an upper bound of the fixed point (a prior solve
    of nearby costs), starts the field, clamped to 0 at the seeds.
    `rounds` counts ordered_rounds + sweeps, as the reference does."""
    V, D = weights_vd.shape
    dev = weights_vd.device
    if max_sweeps <= 0:
        max_sweeps = 4 * V
    cap = -(-max_sweeps // block_sweeps) * block_sweeps
    d = _seeded(V, seeds, dev)
    if init_vb is not None:
        torch.minimum(init_vb.to(dev, torch.float32), d, out=d)
    if ordered_rounds > 0:
        adj_x, w_x = _extended(mesh, weights_vd)
        for _ in range(ordered_rounds):
            _one_round(d, plan, adj_x, w_x)
        del adj_x, w_x
    # Jacobi sweeps on the rows relabelled by their count of finite slots
    # (descending) with each row's finite slots packed first: slot j is
    # then in use on a prefix of n_j rows, and a sweep gathers only those.
    # A row's candidates are the reference's minus +inf ones, which change
    # no minimum, so the field is the same bit for bit.
    fin = torch.isfinite(weights_vd)
    packed = torch.sort((~fin).to(torch.uint8), dim=1, stable=True).indices
    deg = fin.sum(dim=1)
    rows = torch.argsort(deg, descending=True, stable=True)          # new -> old
    rank = torch.empty_like(rows)
    rank[rows] = torch.arange(V, device=dev)
    adj = rank[mesh.adj_vertex.to(dev, torch.int64).gather(1, packed)[rows]].to(torch.int32)
    w = weights_vd.gather(1, packed)[rows]
    counts = (deg[:, None] > torch.arange(D, device=dev)[None, :]).sum(dim=0).tolist()
    cols = [(n, adj[:n, j].contiguous(), w[:n, j:j + 1].contiguous())
            for j, n in enumerate(counts) if n > 0]
    del fin, packed, deg, adj, w
    cur = d[:V].index_select(0, rows)
    del d
    buf = torch.empty_like(cur)

    def jacobi(src: torch.Tensor, dst: torch.Tensor) -> None:
        dst.copy_(src)
        for n, a_j, w_j in cols:
            b = buf[:n]
            torch.index_select(src, 0, a_j, out=b)
            b.add_(w_j)
            torch.minimum(dst[:n], b, out=dst[:n])

    nxt, before = torch.empty_like(cur), torch.empty_like(cur)
    jacobi(cur, nxt)
    cur, nxt = nxt, cur
    sweeps, changed = 1, True
    while changed and sweeps < cap:
        before.copy_(cur)
        for _ in range(block_sweeps):
            jacobi(cur, nxt)
            cur, nxt = nxt, cur
        sweeps += block_sweeps
        changed = bool((cur < before).any())
    del nxt, before, buf
    dist_v = cur.index_select(0, rank)
    del cur
    return _finish(mesh, weights_vd, dist_v, ordered_rounds + sweeps, changed)
