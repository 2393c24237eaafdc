"""Band-width inference and the row-scan banded solver (port of
mesh_navigation_tpu/ops/banded.py).

Vertices form rows of `n_cols`; a [V, B] field reshapes to [R, C, B]. A
down pass walks the rows in order: row r relaxes from row r-1 as just
written through the three down-edge planes, then its lateral edges are
closed exactly by the 1D min-plus closure

    d'[i] = min(d[i], d'[i-1] + a[i])   forward, then backward,

so a label crosses the whole mesh in one down and one up pass. The edges
outside the six banded classes form a residual list relaxed once a round
by a scatter-min. `batched_field_banded` runs such rounds to a quiet
round and recovers the predecessors with ops/structured's
predecessors_from_field.

The reference runs each pass as a `lax.scan` over rows and each closure
as a `lax.associative_scan`. Here both are plain torch: a loop over rows,
and for the closure a doubling (Hillis-Steele) scan of the same min-plus
semiring, whose chain weights are built once for all rows. It runs on the
card when given CUDA tensors, through PyTorch's own kernels; it has no
kernel of its own (no Pallas kernel of the reference sits under it). The
two scans associate the sums differently, so the fields agree within
float rounding, not bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from mesh_navigation_torch.mesh.arrays import MeshArrays, host_array, host_array_opt

INF = float("inf")


def infer_band_width(mesh: MeshArrays) -> int:
    """Most common |offset| > 2 in the adjacency — the grid minor-axis length
    for x-major terrain meshes. A `band_hint` registered by
    mesh/reorder.build_reordered_mesh (the row width it binned with) comes
    first: on irregular reordered meshes the offset histogram jitters around
    the true width."""
    hint = host_array_opt(mesh, "band_hint")
    if hint is not None:
        return int(hint)
    adj = host_array(mesh, "adj_vertex")
    V = adj.shape[0]
    delta = np.abs(adj - np.arange(V)[:, None])
    mask = host_array(mesh, "adj_mask") & (delta > 2)
    if not mask.any():
        return 0
    vals, cnts = np.unique(delta[mask], return_counts=True)
    return int(vals[np.argmax(cnts)])


@dataclasses.dataclass(frozen=True)
class BandedPlan:
    """Banded decomposition of a slot-weight table (banded.py:57-77), on one
    device. A plane holds at vertex v the weight of the edge arriving at v
    from the class's source offset, +inf where there is none (so the row
    wrap-around needs no mask)."""
    n_rows: int
    n_cols: int
    lat_fwd: torch.Tensor   # [R, C] w((r, c-1) -> (r, c))
    lat_bwd: torch.Tensor   # [R, C] w((r, c+1) -> (r, c))
    down: torch.Tensor      # [3, R, C] w((r-1, c+s) -> (r, c)), s = -1, 0, +1
    up: torch.Tensor        # [3, R, C] w((r+1, c+s) -> (r, c))
    res_dst: torch.Tensor   # [Rz] residual destinations (vertex ids)
    res_src: torch.Tensor   # [Rz] residual sources
    res_w: torch.Tensor     # [Rz] f32 (+inf in the padding)
    coverage: float         # share of the usable slots in the six classes


def build_banded_plan(mesh: MeshArrays, weights_vd, *, n_cols: int = 0,
                      device=None) -> BandedPlan:
    """Host-side classification of the [V, D] slot-weight table into the six
    banded offset classes and the residual list (banded.py:99-160); the
    plan goes to `device` (default: the mesh's)."""
    dev = mesh.device if device is None else torch.device(device)
    adj = host_array(mesh, "adj_vertex")
    W = (weights_vd.cpu().numpy() if isinstance(weights_vd, torch.Tensor)
         else np.asarray(weights_vd))
    V, D = adj.shape
    if n_cols <= 0:
        n_cols = infer_band_width(mesh)
    if n_cols <= 0:
        raise ValueError("mesh has no band structure")
    n = n_cols
    n_rows = -(-V // n)
    delta = adj - np.arange(V)[:, None]
    usable = np.isfinite(W) & host_array(mesh, "adj_mask")

    def plane(off: int):
        p = np.full(n_rows * n, np.inf, np.float32)
        hit = (delta == off) & usable
        rows, slots = np.nonzero(hit)
        p[rows] = W[rows, slots]
        return p.reshape(n_rows, n), hit

    covered = np.zeros_like(usable)
    lat_fwd, h = plane(-1)
    covered |= h
    lat_bwd, h = plane(+1)
    covered |= h
    down = np.empty((3, n_rows, n), np.float32)
    up = np.empty((3, n_rows, n), np.float32)
    for i, s in enumerate((-1, 0, +1)):
        down[i], h = plane(-(n - s))
        covered |= h
        up[i], h = plane(n + s)
        covered |= h
    rows, slots = np.nonzero(usable & ~covered)
    coverage = 1.0 - len(rows) / max(usable.sum(), 1)
    Rz = max(8, -(-len(rows) // 8) * 8)
    res_dst = np.zeros(Rz, np.int64)
    res_src = np.zeros(Rz, np.int64)
    res_w = np.full(Rz, np.inf, np.float32)
    res_dst[:len(rows)] = rows
    res_src[:len(rows)] = adj[rows, slots]
    res_w[:len(rows)] = W[rows, slots]

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    return BandedPlan(n_rows=n_rows, n_cols=n, lat_fwd=t(lat_fwd), lat_bwd=t(lat_bwd),
                      down=t(down), up=t(up), res_dst=t(res_dst), res_src=t(res_src),
                      res_w=t(res_w), coverage=float(coverage))


def _minplus_combine(x, y):
    """The semiring combine of the lateral scan (banded.py:163-166):
    (a1, b1) * (a2, b2) = (a1 + a2, min(b2, b1 + a2))."""
    a1, b1 = x
    a2, b2 = y
    return a1 + a2, torch.minimum(b2, b1 + a2)


def _chain_levels(w: torch.Tensor, forward: bool) -> list[torch.Tensor]:
    """The doubling scan's chain weights of the lateral planes w [R, C]:
    level t holds at column i the weight of the chain of 2^t edges ending
    at i (from i - 2^t forward, from i + 2^t backward), for shifts 2^t
    below the row's width (the entries a level's step does not read keep
    the shorter chains of the level before)."""
    R, C = w.shape
    levels, a, s = [], w, 1
    while s < C:
        levels.append(a)
        nxt = a.clone()
        if forward:
            nxt[:, s:] = a[:, :-s] + a[:, s:]
        else:
            nxt[:, :-s] = a[:, :-s] + a[:, s:]
        a, s = nxt, 2 * s
    return levels


def _row_closure(row: torch.Tensor, fwd_levels, bwd_levels) -> torch.Tensor:
    """Exact 1D min-plus closure of one row [C, B], in place (banded.py:
    169-176): a forward then a backward doubling scan, each a step of
    _minplus_combine at shift 2^t per level ([C] chain weights)."""
    s = 1
    for a in fwd_levels:
        torch.minimum(row[s:], row[:-s] + a[s:, None], out=row[s:])
        s *= 2
    s = 1
    for a in bwd_levels:
        torch.minimum(row[:-s], row[s:] + a[:-s, None], out=row[:-s])
        s *= 2
    return row


def _directional_pass(d_rcb: torch.Tensor, cross_planes: torch.Tensor, fwd_levels,
                      bwd_levels, *, reverse: bool) -> torch.Tensor:
    """One Gauss-Seidel pass over the rows of d_rcb [R, C, B], in place
    (banded.py:179-207): each row relaxes from the previous row as written
    through the three cross planes [3, R, C] (source columns c-1, c, c+1;
    the wrap-around columns carry +inf weights), then closes laterally.
    `reverse` walks bottom-up."""
    R, C, B = d_rcb.shape
    prev = torch.full((C, B), INF, dtype=d_rcb.dtype, device=d_rcb.device)
    for r in (range(R - 1, -1, -1) if reverse else range(R)):
        x = cross_planes[:, r, :, None]
        cand = torch.minimum(torch.minimum(torch.roll(prev, 1, 0) + x[0], prev + x[1]),
                             torch.roll(prev, -1, 0) + x[2])
        row = torch.minimum(d_rcb[r], cand)
        prev = _row_closure(row, [a[r] for a in fwd_levels], [a[r] for a in bwd_levels])
        d_rcb[r] = prev
    return d_rcb


class BandedFieldResult(NamedTuple):
    dist: torch.Tensor    # [B, V]
    pred: torch.Tensor    # [B, V] i32
    rounds: int
    converged: bool


def batched_field_banded(
    mesh: MeshArrays,
    weights_vd: torch.Tensor,   # [V, D] slot weights
    plan: BandedPlan,
    seeds: torch.Tensor,        # [B]
    *,
    max_rounds: int = 256,
    atol: float = 1e-5,
    rtol: float = 1e-5,
) -> BandedFieldResult:
    """Batched SSSP by banded Gauss-Seidel rounds (banded.py:216-272). One
    round is a down pass, an up pass and the residual scatter-min; the
    loop ends on a round that improves no label by more than atol +
    rtol*|label| (every edge is then satisfied to that tolerance), after
    at least two rounds, as the reference's. One host read a round. The
    predecessors come from ops/structured.predecessors_from_field."""
    from mesh_navigation_torch.ops.structured import predecessors_from_field

    dev = plan.lat_fwd.device
    V = weights_vd.shape[0]
    B = seeds.shape[0]
    R, C = plan.n_rows, plan.n_cols
    seeds = seeds.to(dev).long()
    d = torch.full((R * C, B), INF, dtype=torch.float32, device=dev)
    d[seeds, torch.arange(B, device=dev)] = 0.0
    levels = (_chain_levels(plan.lat_fwd, True), _chain_levels(plan.lat_bwd, False))

    def one_round(d_flat):
        d_new = d_flat.clone()
        rcb = d_new.view(R, C, B)
        _directional_pass(rcb, plan.down, *levels, reverse=False)
        _directional_pass(rcb, plan.up, *levels, reverse=True)
        cand = d_new[plan.res_src] + plan.res_w[:, None]
        d_new.index_reduce_(0, plan.res_dst, cand, "amin")
        return d_new

    d = one_round(d)
    rounds, changed = 1, True
    while changed and rounds < max_rounds:
        new = one_round(d)
        changed = bool((new * (1.0 + rtol) + atol < d).any())
        d = new
        rounds += 1
    dist = d[:V]
    pred = predecessors_from_field(mesh, weights_vd.to(dev), dist)
    return BandedFieldResult(dist=dist.T, pred=pred.T, rounds=rounds, converged=not changed)
