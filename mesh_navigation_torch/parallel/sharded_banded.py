"""The banded Gauss-Seidel solve on row-range shards, one a rank (port of
mesh_navigation_tpu/parallel/sharded_banded.py:59-466).

Rows are cut into contiguous RANGE shards. Each rank runs the port's pass
kernel (ops/banded_gpu.directional_pass, csrc/banded_pass.cu on the card,
the plain pass on the CPU), unmodified, over its own rows plus G GHOST rows
on each side; each round the 2 G boundary rows travel to the neighbours
(one batch_isend_irecv, O(G * Cp * B) a rank a round), and one all-reduce
(SUM) of the changed flag ends it.

Round semantics: within a round each shard is Gauss-Seidel over its own
rows and block-Jacobi across its cuts (the ghosts hold the neighbour's
rows from before the round), so a wavefront crosses one cut a round:
rounds grow by the number of cuts an optimal path crosses. The fixed
point is the single-device solve's (ghost rows carry true labels only, and
every relaxation is a real path cost).

IRREGULAR (residual) plans: residual edges and extended lanes shard along
rows too. NEAR residuals (the source row within the ghost-extended range of
the destination's owner) relax inside the owner's frame. FAR residuals
ride a compact far-source table: each round every rank writes the labels
of the far sources it owns and one all-reduce (MIN) makes the table fresh
on every rank. It runs on every rank whenever the global plan has far
entries, a rank owning none included, so the collectives match. Residual
improvements mark their rows dirty for the pass's row skip, with the
port's dirty-table semantics (ops/banded_gpu.directional_pass_plain). The
exchanges, all-reduces and scatters are collectives and plain torch, as
the reference's are XLA code outside any Pallas kernel.

Departures: the shards keep no `l2_fwd`, `l2_bwd` or `wback` (the two-level
scan tables of the TPU kernel; the port's pass reads level 0 of a_fwd /
a_bwd) and no row-block padding (the port's pass has no row blocks: a
shard holds Rs + 2 G rows); the shards carry every level of a_fwd / a_bwd.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from mesh_navigation_torch.ops import banded_gpu as bg
from mesh_navigation_torch.parallel import distributed
from mesh_navigation_torch.parallel.comm import Comm
from mesh_navigation_torch.parallel.sharded import any_changed

INF = float("inf")

# ghost rows are a per-round payload (G * Cp * B each way); the cap keeps a
# pathological reorder from turning the halo into a whole-field exchange
MAX_GHOST = 4


class ShardedBandedPlan(NamedTuple):
    """Host stacks of each shard's planes (leading axis: the shard). Shard k
    owns rows [k*Rs, (k+1)*Rs) and holds G ghost rows on each side, planes
    included: a ghost row is a real destination of the pass (its writes
    are replaced at the next exchange), so its planes are real and its
    relaxations stay path costs. Rows outside [0, R) read +inf."""
    down: torch.Tensor      # [n, RpL, 3, Cp]
    up: torch.Tensor
    a_fwd: torch.Tensor     # [n, RpL, S, Cp]
    a_bwd: torch.Tensor
    xdown: torch.Tensor     # [n, RpL, L, Cp] extended-lane planes (one +inf
    xup: torch.Tensor       #   lane where the plan has none)
    xlist_down: tuple       # each shard's lists of those lanes (banded_gpu.XLaneList,
    xlist_up: tuple         #   host; () where the plan has no lane): what the kernel reads
    res_src: torch.Tensor   # [n, Rz] i32 LOCAL padded-flat ids (pad 0)
    res_dst: torch.Tensor   # [n, Rz] i32 LOCAL padded-flat ids (pad 0)
    res_w: torch.Tensor     # [n, Rz] f32 (pad +inf)
    far_src: torch.Tensor   # [n, Nf] i32 LOCAL flat id of the far sources it owns
    far_own: torch.Tensor   # [n, Nf] bool: this shard owns far source i
    far_idx: torch.Tensor   # [n, Rzf] i32 index into the far table (pad 0)
    far_dst: torch.Tensor   # [n, Rzf] i32 LOCAL padded-flat dst (pad 0)
    far_w: torch.Tensor     # [n, Rzf] f32 (pad +inf)
    xlanes_down: tuple      # (sel, dc) of each extended lane
    xlanes_up: tuple
    n_residual: int         # largest per-shard NEAR residual count, padded (0: none)
    n_far: int              # far-source table size (0: none)
    ghost: int              # G ghost rows each side
    n_shards: int
    rows_per_shard: int     # Rs (owned)
    rp_local: int           # Rs + 2 G
    n_scan: int
    n_rows: int             # global R
    n_cols: int
    n_cols_pad: int
    num_vertices: int


def build_sharded_banded_plan(plan: bg.BandedKernelPlan, n_shards: int) -> ShardedBandedPlan:
    """Host side: stack each shard's plane rows with their G-row ghost
    overlap and split the residual list by the owner of its destination
    row. The plan may live on any device; the stacks are host tensors."""
    R, C, Cp = plan.n_rows, plan.n_cols, plan.n_cols_pad
    Rs = -(-R // n_shards)

    # ghost width: the largest row reach of a relaxation source; 1 for the
    # dense classes, up to 2 for extended lanes, the measured reach of the
    # residual edges capped at MAX_GHOST (the tail goes to the far table)
    ghost = 1
    if plan.xlanes_down or plan.xlanes_up:
        ghost = max(ghost, *[abs(sel) for sel, _ in plan.xlanes_down + plan.xlanes_up])
    n_res_real = int(plan.n_residual)
    if n_res_real:
        res_src_np = plan.res_src[:n_res_real].cpu().numpy()
        res_dst_np = plan.res_dst[:n_res_real].cpu().numpy()
        res_w_np = plan.res_w[:n_res_real].cpu().numpy()
        src_rows = res_src_np // Cp
        dst_rows = res_dst_np // Cp
        reach = np.abs(src_rows - dst_rows)
        ghost = max(ghost, int(min(reach.max(initial=0), MAX_GHOST)))
    G = ghost
    rp_local = Rs + 2 * G

    def shard_rows(p: torch.Tensor, fill=INF) -> torch.Tensor:
        """[R, ...] -> [n, rp_local, ...]: rows k*Rs-G .. k*Rs+Rs+G, `fill`
        outside [0, R)."""
        pp = torch.full((n_shards * Rs + 2 * G, *p.shape[1:]), fill, dtype=p.dtype)
        pp[G:G + R] = p.cpu()
        return torch.stack([pp[k * Rs:k * Rs + rp_local] for k in range(n_shards)])

    def shard_lists(name: str) -> tuple:
        """Each shard's lists of the `name` lanes: the plan's edges on the
        shard's rows, ghost rows included."""
        lanes = getattr(plan, f"xlanes_{name}")
        if not lanes:
            return ()
        present = shard_rows(bg.xlane_present(plan, name), False)
        planes = shard_rows(getattr(plan, f"x{name}").float())
        return tuple(bg.build_xlane_list(present[k], planes[k], lanes) for k in range(n_shards))

    def empty_res():
        return (np.zeros((n_shards, 8), np.int32), np.zeros((n_shards, 8), np.int32),
                np.full((n_shards, 8), np.inf, np.float32))

    n_residual = n_far = 0
    res_src_s, res_dst_s, res_w_s = empty_res()
    far_idx_s, far_dst_s, far_w_s = empty_res()
    far_src_s = np.zeros((n_shards, 8), np.int32)
    far_own_s = np.zeros((n_shards, 8), bool)
    if n_res_real:
        dst_owner = np.minimum(dst_rows // Rs, n_shards - 1)
        # NEAR: the source row lies inside the destination owner's
        # ghost-extended range (not merely reach <= G: a destination near a
        # cut reaches across it)
        lo = dst_owner * Rs - G
        hi = dst_owner * Rs + Rs + G
        near = (src_rows >= lo) & (src_rows < hi)
        far = ~near

        per = [np.nonzero(near & (dst_owner == k))[0] for k in range(n_shards)]
        Rz = max(8, -(-max((len(ix) for ix in per), default=1) // 8) * 8)
        res_src_s = np.zeros((n_shards, Rz), np.int32)
        res_dst_s = np.zeros((n_shards, Rz), np.int32)
        res_w_s = np.full((n_shards, Rz), np.inf, np.float32)
        for k, ix in enumerate(per):
            base = k * Rs - G             # global row of local row 0
            sl = res_src_np[ix] - base * Cp
            dl = res_dst_np[ix] - base * Cp
            if not ((sl >= 0).all() and (sl < rp_local * Cp).all()
                    and (dl >= 0).all() and (dl < rp_local * Cp).all()):
                raise AssertionError(f"shard {k}: a near residual leaves the shard's rows")
            res_src_s[k, :len(ix)] = sl
            res_dst_s[k, :len(ix)] = dl
            res_w_s[k, :len(ix)] = res_w_np[ix]
        n_residual = int(Rz)

        if far.any():
            fsrc_g, finv = np.unique(res_src_np[far], return_inverse=True)
            Nf = max(8, -(-len(fsrc_g) // 8) * 8)
            fsrc_owner = np.minimum((fsrc_g // Cp) // Rs, n_shards - 1)
            far_own_s = np.zeros((n_shards, Nf), bool)
            far_src_s = np.zeros((n_shards, Nf), np.int32)
            for k in range(n_shards):
                own = fsrc_owner == k
                far_own_s[k, :len(fsrc_g)] = own
                far_src_s[k, :len(fsrc_g)] = np.where(own, fsrc_g - (k * Rs - G) * Cp, 0)
            fper = [np.nonzero(far & (dst_owner == k))[0] for k in range(n_shards)]
            far_of = np.zeros(n_res_real, np.int64)
            far_of[np.nonzero(far)[0]] = finv
            Rzf = max(8, -(-max((len(ix) for ix in fper), default=1) // 8) * 8)
            far_idx_s = np.zeros((n_shards, Rzf), np.int32)
            far_dst_s = np.zeros((n_shards, Rzf), np.int32)
            far_w_s = np.full((n_shards, Rzf), np.inf, np.float32)
            for k, ix in enumerate(fper):
                fdl = res_dst_np[ix] - (k * Rs - G) * Cp
                if not ((fdl >= 0).all() and (fdl < rp_local * Cp).all()):
                    raise AssertionError(f"shard {k}: a far residual's destination leaves its rows")
                far_idx_s[k, :len(ix)] = far_of[ix]
                far_dst_s[k, :len(ix)] = fdl
                far_w_s[k, :len(ix)] = res_w_np[ix]
            n_far = int(Nf)

    t = torch.from_numpy
    return ShardedBandedPlan(
        down=shard_rows(plan.down), up=shard_rows(plan.up),
        a_fwd=shard_rows(plan.a_fwd), a_bwd=shard_rows(plan.a_bwd),
        xdown=shard_rows(plan.xdown.float()), xup=shard_rows(plan.xup.float()),
        xlist_down=shard_lists("down"), xlist_up=shard_lists("up"),
        res_src=t(res_src_s), res_dst=t(res_dst_s), res_w=t(res_w_s),
        far_src=t(far_src_s), far_own=t(far_own_s), far_idx=t(far_idx_s),
        far_dst=t(far_dst_s), far_w=t(far_w_s),
        xlanes_down=tuple(plan.xlanes_down), xlanes_up=tuple(plan.xlanes_up),
        n_residual=n_residual, n_far=n_far, ghost=G, n_shards=n_shards,
        rows_per_shard=Rs, rp_local=rp_local, n_scan=plan.n_scan, n_rows=R,
        n_cols=C, n_cols_pad=Cp, num_vertices=plan.num_vertices,
    )


def _scatter_min(flat, dirty, dst, cand, bb: int, Cp: int, atol: float, rtol: float):
    """In place: flat[dst] = min(flat[dst], cand) (ungated, as the
    single-device residual round, ops/banded_gpu._residual_round); where a
    candidate improves by more than the tolerance its destination row is
    marked dirty for its lane block. Returns the improved flag."""
    Bp = flat.shape[1]
    imp = cand * (1.0 + rtol) + atol < flat.index_select(0, dst)
    flat.index_reduce_(0, dst, cand, "amin")
    if dirty is not None:
        impj = imp.view(-1, Bp // bb, bb).any(dim=2).T.to(torch.int32)     # [nb, n]
        dirty.index_reduce_(1, dst // Cp, impj, "amax")
    return imp.any().reshape(1)


def sharded_banded_solve(
    splan: ShardedBandedPlan,
    seeds,                       # [B] global real vertex ids
    grid: distributed.DeviceGrid,
    *,
    max_rounds: int = 256,
    atol: float = 0.0,
    rtol: float = 0.0,
    device=None,
):
    """Sharded banded GS rounds to global convergence over the grid's mesh
    axis (one shard a rank; the batch axis must be 1). Returns (dist [V, B]
    f32 in the plan's vertex order, on every rank, on its device; rounds;
    converged). Each rank moves only its own shard to its device. A round:
    the ghost exchange, the down pass (forced on the first round) and the
    up pass, on irregular plans the near scatter and the far table, then
    one all-reduce of the changed flag."""
    n, Rs, RpL, G = splan.n_shards, splan.rows_per_shard, splan.rp_local, splan.ghost
    C, Cp, R, V = splan.n_cols, splan.n_cols_pad, splan.n_rows, splan.num_vertices
    if grid.shape["mesh"] != n or grid.shape["batch"] != 1:
        raise ValueError(f"a plan of {n} shards needs an ({n}, 1) grid, got {grid.shape}")
    if splan.n_scan < max(1, int(math.ceil(math.log2(max(C, 2))))):
        raise NotImplementedError("partial scan depth")
    dev = distributed.local_device(device)
    comm = Comm(dev)
    k = grid.mesh_index
    seeds = torch.as_tensor(seeds).cpu().long()
    B = seeds.shape[0]
    bb = bg.PASS_LANES
    Bp = -(-B // bb) * bb
    has_residual = splan.n_residual > 0
    has_far = splan.n_far > 0

    def mine(t: torch.Tensor) -> torch.Tensor:
        # a fresh contiguous copy of this shard's slice (the pass kernel
        # needs 16-byte aligned, contiguous planes)
        return t[k].to(dev, copy=True).contiguous()

    down, up, a_f, a_b = mine(splan.down), mine(splan.up), mine(splan.a_fwd), mine(splan.a_bwd)
    xdn = mine(splan.xdown) if splan.xlanes_down else None
    xup = mine(splan.xup) if splan.xlanes_up else None
    # this shard's lists, their weights gathered from its planes on its device
    xl_dn = splan.xlist_down[k].to(dev).with_weights(xdn) if splan.xlanes_down else None
    xl_up = splan.xlist_up[k].to(dev).with_weights(xup) if splan.xlanes_up else None

    # this shard's seeded field: local row = global row - k*Rs + G
    local_row = seeds // C - k * Rs + G
    own = (local_row >= G) & (local_row < G + Rs)
    d = torch.full((RpL * Cp, Bp), INF, dtype=torch.float32, device=dev)
    d[(local_row * Cp + seeds % C)[own].to(dev), torch.arange(B)[own].to(dev)] = 0.0
    d = d.view(RpL, Cp, Bp)
    flat = d.view(RpL * Cp, Bp)
    # the row-skip machinery needs the dirty table where residual scatters
    # can leave a row below its lateral fixed point (full depth only)
    dirty = torch.zeros((Bp // bb, RpL), dtype=torch.int32, device=dev) if has_residual else None
    if has_residual:
        rsrc, rdst = splan.res_src[k].to(dev, torch.int64), splan.res_dst[k].to(dev, torch.int64)
        rw = splan.res_w[k].to(dev)
    if has_far:
        fsrc, fown = splan.far_src[k].to(dev, torch.int64), splan.far_own[k].to(dev)
        fidx, fdst = splan.far_idx[k].to(dev, torch.int64), splan.far_dst[k].to(dev, torch.int64)
        fw = splan.far_w[k].to(dev)

    prev = grid.mesh_ranks[k - 1] if k > 0 else None
    nxt = grid.mesh_ranks[k + 1] if k + 1 < n else None
    # where a shard owns fewer than G rows the rows it sends overlap the
    # ghost rows it receives: send copies then
    snap = (lambda t: t.clone()) if Rs < G else (lambda t: t)

    def exchange() -> None:
        # rows [G, G+Rs) are owned; ghosts at [0, G) (the previous shard's
        # last G owned rows) and [G+Rs, 2G+Rs) (the next one's first G);
        # an end shard's open side stays +inf
        sends, recvs = [], []
        if prev is not None:
            sends.append((snap(d[G:2 * G]), prev))
            recvs.append((d[0:G], prev))
        if nxt is not None:
            sends.append((snap(d[Rs:Rs + G]), nxt))
            recvs.append((d[G + Rs:2 * G + Rs], nxt))
        comm.exchange(sends, recvs)

    def one_round(force: bool = False) -> bool:
        # fresher ghosts need no dirty flag: they reach the first owned row
        # through the pass's own cross-row carry
        exchange()
        changed = bg.directional_pass(
            d, down, a_f, a_b, reverse=False, bb=bb, atol=atol, rtol=rtol, force=force,
            dirty=dirty, xcross=xdn, xlanes=splan.xlanes_down, xlist=xl_dn,
        )
        changed = changed | bg.directional_pass(
            d, up, a_f, a_b, reverse=True, bb=bb, atol=atol, rtol=rtol, dirty=dirty,
            xcross=xup, xlanes=splan.xlanes_up, xlist=xl_up,
        )
        if has_residual:
            cand = flat.index_select(0, rsrc) + rw[:, None]
            changed = changed | _scatter_min(flat, dirty, rdst, cand, bb, Cp, atol, rtol)
        if has_far:
            # the far sources this shard owns, made fresh on every rank
            table = torch.where(fown[:, None], flat.index_select(0, fsrc), INF)
            comm.all_reduce_(table, dist.ReduceOp.MIN, grid.mesh_group, n)
            cand = table.index_select(0, fidx) + fw[:, None]
            changed = changed | _scatter_min(flat, dirty, fdst, cand, bb, Cp, atol, rtol)
        return any_changed(comm, changed.bool().any(), grid.mesh_group, n)

    changed = one_round(force=True)
    rounds = 1
    while changed and rounds < max_rounds:
        changed = one_round()
        rounds += 1
    owned = torch.cat(comm.all_gather(d[G:G + Rs].contiguous(), grid.mesh_group, n))   # [n*Rs, Cp, Bp]
    dist_vb = owned[:R, :C, :B].reshape(-1, B)[:V]
    return dist_vb, rounds, not changed
