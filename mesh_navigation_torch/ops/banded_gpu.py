"""Banded Gauss-Seidel solve with hand-written Hopper kernels.

Counterpart of mesh_navigation_tpu/ops/pallas_banded.py: the host plan
builder (BandedKernelPlan / build_banded_kernel_plan, :56-511), the padded
problem (prepare_padded, :1332), the solve loop (banded_solve_padded,
:1413, converge="pred" and "round"), lane grouping (:2041), the int8 class
predecessor table (:2531), the class-decoding path walk (:2644) and the
on-the-fly predecessor lookup (:2834).

Two kernels carry the solve; each has a plain PyTorch version beside it with
the same pass semantics (row order, carry, gated writes, class order):

- `directional_pass` — csrc/banded_pass.cu, replacing `_pass_kernel`;
- `class_pred` — csrc/class_pred.cu, replacing `_pred_kernel`.

A wrapper runs the plain version only for a tensor on the CPU. On a CUDA
tensor it launches the kernel or raises; there is no fallback.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from mesh_navigation_torch.mesh.arrays import MeshArrays, host_array
from mesh_navigation_torch.ops import banded as _banded
from mesh_navigation_torch.ops import kernels
from mesh_navigation_torch.utils.timing import stage as _stage

INF = float("inf")
PASS_LANES = 8   # batch lanes per CUDA block of the pass kernel


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


# --------------------------------------------------------------------------
# host plan
# --------------------------------------------------------------------------

PLAN_ARRAYS = (
    "down", "up", "a_fwd", "a_bwd", "res_dst", "res_src", "res_w",
    "slot_map", "res_slot", "xdown", "xup", "xslot_down", "xslot_up",
    "lat_fwd", "lat_bwd", "dist_lat_fwd", "dist_lat_bwd", "dist_down",
    "dist_up", "xdist_down", "xdist_up", "res_dist",
    "l2_fwd", "l2_bwd", "wback_fwd", "wback_bwd",
    "res_row_map", "res_jump", "res_order", "res_entry_row", "res_entry_slot",
)
PLAN_META = (
    "n_rows", "n_cols", "n_cols_pad", "n_scan", "coverage", "num_vertices",
    "n_residual", "xlanes_down", "xlanes_up", "n_scan2", "n_res_dst",
)


@dataclasses.dataclass(frozen=True)
class BandedKernelPlan:
    """2D-padded banded decomposition + precomputed scan chain weights, on
    one device. All planes live on the [R, Cp] grid (+inf in padding);
    residual ids are padded flat ids r * Cp + c. Field meanings are those of
    the reference's BandedKernelPlan (pallas_banded.py:73-165)."""
    n_rows: int
    n_cols: int
    n_cols_pad: int
    n_scan: int
    coverage: float
    num_vertices: int
    n_residual: int
    down: torch.Tensor      # [R, 3, Cp] w((r-1, c+s) -> (r, c)), s = -1, 0, +1
    up: torch.Tensor        # [R, 3, Cp] w((r+1, c+s) -> (r, c))
    a_fwd: torch.Tensor     # [R, S, Cp] chain weight of (r, c-2^s) -> (r, c)
    a_bwd: torch.Tensor     # [R, S, Cp] chain weight of (r, c+2^s) -> (r, c)
    res_dst: torch.Tensor
    res_src: torch.Tensor
    res_w: torch.Tensor
    slot_map: torch.Tensor  # [8, V] adjacency slot of each class edge (-1 none)
    res_slot: torch.Tensor
    xlanes_down: tuple = ()
    xlanes_up: tuple = ()
    xdown: torch.Tensor = None
    xup: torch.Tensor = None
    xslot_down: torch.Tensor = None
    xslot_up: torch.Tensor = None
    lat_fwd: torch.Tensor = None   # [R, Cp] direct +-1 lateral planes
    lat_bwd: torch.Tensor = None
    dist_lat_fwd: torch.Tensor = None
    dist_lat_bwd: torch.Tensor = None
    dist_down: torch.Tensor = None
    dist_up: torch.Tensor = None
    xdist_down: torch.Tensor = None
    xdist_up: torch.Tensor = None
    res_dist: torch.Tensor = None
    n_scan2: int = 0
    l2_fwd: torch.Tensor = None
    n_res_dst: int = 0
    res_row_map: torch.Tensor = None
    res_jump: torch.Tensor = None
    res_order: torch.Tensor = None
    res_entry_row: torch.Tensor = None
    res_entry_slot: torch.Tensor = None
    l2_bwd: torch.Tensor = None
    wback_fwd: torch.Tensor = None
    wback_bwd: torch.Tensor = None

    @property
    def device(self) -> torch.device:
        return self.down.device


def _class_offsets(n: int) -> list[int]:
    """Banded class order: lat -1, lat +1, down s=-1,0,+1, up s=-1,0,+1."""
    return [-1, +1, -(n + 1), -n, -(n - 1), n - 1, n, n + 1]


def _shift2(x: np.ndarray, dr: int, dc: int) -> np.ndarray:
    """result[r, c] = x[r+dr, c+dc] over [R, Cp], +inf outside."""
    R, C = x.shape
    out = np.full_like(x, np.inf)
    rs = slice(max(dr, 0), R + min(dr, 0))
    rd = slice(max(-dr, 0), R + min(-dr, 0))
    cs = slice(max(dc, 0), C + min(dc, 0))
    cd = slice(max(-dc, 0), C + min(-dc, 0))
    out[rd, cd] = x[rs, cs]
    return out


def _effective_laterals(lat_fwd, lat_bwd, down, up):
    """min(direct, 2-hop detours through rows r-1 / r+1) for the +-1 lateral
    chain links — exact path costs, so the scan chains stay valid."""
    dn = [down[:, i, :] for i in range(3)]
    u = [up[:, i, :] for i in range(3)]
    S = _shift2
    lat_f = lat_fwd
    for cand in (
        S(u[1], -1, -1) + dn[0],
        S(u[0], -1, 0) + dn[1],
        S(dn[1], 1, -1) + u[0],
        S(dn[0], 1, 0) + u[1],
    ):
        lat_f = np.minimum(lat_f, cand)
    lat_b = lat_bwd
    for cand in (
        S(u[1], -1, 1) + dn[2],
        S(u[2], -1, 0) + dn[1],
        S(dn[1], 1, 1) + u[2],
        S(dn[2], 1, 0) + u[1],
    ):
        lat_b = np.minimum(lat_b, cand)
    return lat_f, lat_b


def _chain_weights(lat_fwd, lat_bwd, n_scan):
    """A_f[s][c] = cost of the lateral chain (c - 2^s) -> c, +inf where the
    chain leaves the row. Returns two [R, S, Cp] stacks."""
    def shift_d(x, k):
        fill = np.full(x.shape[:-1] + (k,), np.inf, x.dtype)
        return np.concatenate([fill, x[..., :-k]], axis=-1)

    def shift_u(x, k):
        fill = np.full(x.shape[:-1] + (k,), np.inf, x.dtype)
        return np.concatenate([x[..., k:], fill], axis=-1)

    a_fwd = [lat_fwd]
    a_bwd = [lat_bwd]
    for s in range(1, n_scan):
        k = 1 << (s - 1)
        a_fwd.append(shift_d(a_fwd[-1], k) + a_fwd[-1])
        a_bwd.append(shift_u(a_bwd[-1], k) + a_bwd[-1])
    return np.stack(a_fwd, axis=1), np.stack(a_bwd, axis=1)


def _two_level_tables(a_fwd, a_bwd, n_scan: int, Cp: int):
    """Boundary-level chain tables of the reference's two-level scan
    (kept so the plan compares whole; the CUDA pass does not read them)."""
    full = n_scan >= max(1, int(np.ceil(np.log2(max(Cp, 2)))))
    if Cp % 8 or Cp < 64 or not full or n_scan <= 3:
        return 0, None, None, None, None
    NB = Cp // 8
    S2 = n_scan - 3
    l2f = a_fwd[:, 3:, 7::8]
    l2b = a_bwd[:, 3:, 0::8]
    R = a_fwd.shape[0]
    wf = np.cumsum(a_fwd[:, 0, :].reshape(R, NB, 8), axis=-1).reshape(R, Cp)
    ab0 = a_bwd[:, 0, :].reshape(R, NB, 8)
    wb = np.flip(np.cumsum(np.flip(ab0, axis=-1), axis=-1), axis=-1).reshape(R, Cp)
    return S2, l2f, l2b, wf, wb


def build_banded_kernel_plan(
    mesh: MeshArrays,
    weights_vd,
    *,
    n_cols: int = 0,
    n_scan: int = 0,
    extended: bool | None = None,
    device=None,
) -> BandedKernelPlan:
    """Host side: classify the adjacency into the eight banded offset classes
    (slot_map), derive the weight planes and min-plus chain weights, and remap
    residual edges to the padded grid. `weights_vd` is the [V, D] slot-weight
    table (numpy preferred). The plan goes to `device` (default: the mesh's)."""
    dev = mesh.device if device is None else torch.device(device)
    adj = host_array(mesh, "adj_vertex")
    mask = host_array(mesh, "adj_mask")
    W = (weights_vd.cpu().numpy() if isinstance(weights_vd, torch.Tensor)
         else np.asarray(weights_vd))
    V, D = adj.shape
    if n_cols <= 0:
        n_cols = _banded.infer_band_width(mesh)
    if n_cols <= 0:
        raise ValueError("mesh has no band structure")
    n = n_cols
    R = -(-V // n)
    Cp = _round_up(n, 8)
    if n_scan <= 0:
        n_scan = max(1, int(np.ceil(np.log2(n))))

    delta = adj - np.arange(V, dtype=np.int64)[:, None]
    offsets = _class_offsets(n)
    # an id-delta hit whose source column would cross a row boundary is not
    # relaxable by the shift-based sweep: it goes to the residual list
    class_dc = [-1, +1, -1, 0, +1, -1, 0, +1]
    col = np.arange(V, dtype=np.int64) % n
    slot_map = np.full((8, V), -1, np.int32)
    covered = np.zeros((V, D), bool)
    for k, (off, dc) in enumerate(zip(offsets, class_dc)):
        hit = (delta == off) & mask & ((col + dc >= 0) & (col + dc < n))[:, None]
        rows, slots = np.nonzero(hit)
        slot_map[k, rows] = slots
        covered |= hit

    def to_plane(w):
        p = np.full(R * n, np.inf, np.float32)
        p[:V] = w
        return np.pad(p.reshape(R, n), ((0, 0), (0, Cp - n)), constant_values=np.inf)

    def plane(sm, table):
        return to_plane(np.where(sm >= 0, table[np.arange(V), np.maximum(sm, 0)], np.inf))

    lat_fwd, lat_bwd = plane(slot_map[0], W), plane(slot_map[1], W)
    down = np.stack([plane(slot_map[2 + i], W) for i in range(3)], axis=1)
    up = np.stack([plane(slot_map[5 + i], W) for i in range(3)], axis=1)
    lat_f_eff, lat_b_eff = _effective_laterals(lat_fwd, lat_bwd, down, up)
    a_fwd, a_bwd = _chain_weights(lat_f_eff, lat_b_eff, n_scan)
    n_scan2, l2f, l2b, wbf, wbb = _two_level_tables(a_fwd, a_bwd, n_scan, Cp)

    rows, slots = np.nonzero(mask & ~covered)
    coverage = 1.0 - len(rows) / max(mask.sum(), 1)

    # extended lanes: leftover offsets at |dr| <= 2, |dc| <= 4 (irregular
    # meshes); classified here so the plan compares whole with the reference
    if extended is None:
        extended = coverage < 0.995
    xlanes_down, xlanes_up = [], []
    xslots_down, xslots_up = [], []
    if extended and len(rows):
        leftover = mask & ~covered
        min_hits = max(16, int(2e-4 * mask.sum()))
        core = {(0, -1), (0, 1), (-1, -1), (-1, 0), (-1, 1),
                (1, -1), (1, 0), (1, 1), (0, 0)}
        for dr in (-2, -1, 0, 1, 2):
            for dc in range(-4, 5):
                if (dr, dc) in core:
                    continue
                off = dr * n + dc
                hit = (
                    (delta == off) & leftover
                    & ((col + dc >= 0) & (col + dc < n))[:, None]
                )
                if int(hit.sum()) < min_hits:
                    continue
                vrows, vslots = np.nonzero(hit)
                xsm = np.full(V, -1, np.int32)
                xsm[vrows] = vslots
                sel = abs(dr)
                if dr <= 0:
                    xlanes_down.append((sel, dc))
                    xslots_down.append(xsm)
                if dr >= 0:
                    xlanes_up.append((sel, dc))
                    xslots_up.append(xsm)
    Rz = max(8, -(-len(rows) // 8) * 8)
    res_dst = np.zeros(Rz, np.int32)
    res_src = np.zeros(Rz, np.int32)
    res_slot = np.full(Rz, -1, np.int32)
    res_w = np.full(Rz, np.inf, np.float32)
    srcs = adj[rows, slots]
    res_dst[: len(rows)] = (rows // n) * Cp + rows % n
    res_src[: len(rows)] = (srcs // n) * Cp + srcs % n
    res_slot[: len(rows)] = slots
    res_w[: len(rows)] = W[rows, slots]

    def xstack(slot_list, table):
        if slot_list:
            return np.stack([plane(s, table) for s in slot_list], axis=1)
        return np.full((R, 1, Cp), np.inf, np.float32)

    def xslot(slot_list):
        if slot_list:
            return np.stack(slot_list, axis=0)
        return np.full((1, V), -1, np.int32)

    # static geometry planes: Euclidean edge lengths, invalid endpoints = inf
    adj_e = host_array(mesh, "adj_edge")
    invalid = host_array(mesh, "invalid")
    edist = host_array(mesh, "edge_dist")
    D_slots = np.where(
        mask & ~invalid[adj] & ~invalid[:, None], edist[adj_e], np.inf
    ).astype(np.float32)
    res_dist = np.where(
        res_slot >= 0,
        D_slots[(res_dst // Cp) * n + res_dst % Cp, np.maximum(res_slot, 0)],
        np.inf,
    ).astype(np.float32)

    # residual-dst CSR + jump table (class-9 decode on residual meshes)
    n_real = len(rows)
    res_order = np.argsort(res_dst[:n_real], kind="stable")
    res_order = np.concatenate([res_order, np.arange(n_real, Rz)]).astype(np.int32)
    sorted_dst = res_dst[res_order[:n_real]]
    uniq_dst, start_idx = np.unique(sorted_dst, return_index=True)
    n_res_dst = len(uniq_dst)
    NDp = max(8, n_res_dst)
    row_map = np.full(V, -1, np.int32)
    row_map[(uniq_dst // Cp) * n + uniq_dst % Cp] = np.arange(n_res_dst, dtype=np.int32)
    entry_row = np.full(Rz, -1, np.int32)
    entry_slot = np.zeros(Rz, np.int32)
    jump = np.zeros((NDp, 8), np.int32)
    if n_real:
        rows_of_sorted = np.searchsorted(uniq_dst, sorted_dst).astype(np.int32)
        slots_of_sorted = (np.arange(n_real) - start_idx[rows_of_sorted]).astype(np.int32)
        ok_slot = slots_of_sorted < 8
        entry_row[:n_real] = np.where(ok_slot, rows_of_sorted, -1)
        entry_slot[:n_real] = np.where(ok_slot, slots_of_sorted, 0)
        srcs_sorted = res_src[res_order[:n_real]]
        src_real_sorted = (srcs_sorted // Cp) * n + srcs_sorted % Cp
        ok = entry_row[:n_real] >= 0
        jump[entry_row[:n_real][ok], entry_slot[:n_real][ok]] = src_real_sorted[ok]

    def t(x, dtype=None):
        if x is None:
            return None
        a = np.ascontiguousarray(x if dtype is None else x.astype(dtype))
        return torch.from_numpy(a).to(dev)

    f32 = np.float32
    return BandedKernelPlan(
        n_rows=R, n_cols=n, n_cols_pad=Cp, n_scan=n_scan,
        coverage=float(coverage), num_vertices=V, n_residual=int(len(rows)),
        down=t(down, f32), up=t(up, f32), a_fwd=t(a_fwd, f32), a_bwd=t(a_bwd, f32),
        res_dst=t(res_dst), res_src=t(res_src), res_w=t(res_w),
        slot_map=t(slot_map), res_slot=t(res_slot),
        lat_fwd=t(lat_fwd, f32), lat_bwd=t(lat_bwd, f32),
        xlanes_down=tuple(xlanes_down), xlanes_up=tuple(xlanes_up),
        xdown=t(xstack(xslots_down, W), f32), xup=t(xstack(xslots_up, W), f32),
        xslot_down=t(xslot(xslots_down)), xslot_up=t(xslot(xslots_up)),
        dist_lat_fwd=t(plane(slot_map[0], D_slots), f32),
        dist_lat_bwd=t(plane(slot_map[1], D_slots), f32),
        dist_down=t(np.stack([plane(slot_map[2 + i], D_slots) for i in range(3)], axis=1), f32),
        dist_up=t(np.stack([plane(slot_map[5 + i], D_slots) for i in range(3)], axis=1), f32),
        xdist_down=t(xstack(xslots_down, D_slots), f32),
        xdist_up=t(xstack(xslots_up, D_slots), f32),
        res_dist=t(res_dist),
        n_scan2=n_scan2,
        l2_fwd=t(l2f, f32), l2_bwd=t(l2b, f32),
        wback_fwd=t(wbf, f32), wback_bwd=t(wbb, f32),
        n_res_dst=int(n_res_dst),
        res_row_map=t(row_map), res_jump=t(jump), res_order=t(res_order),
        res_entry_row=t(entry_row), res_entry_slot=t(entry_slot),
    )


# --------------------------------------------------------------------------
# padded problem
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PaddedProblem:
    """Seeded [Rp, Cp, Bp] field + row-padded planes for the directional
    pass (padding rows and lanes stay all +inf)."""
    d0: torch.Tensor      # [Rp, Cp, Bp] f32
    down: torch.Tensor    # [Rp, 3, Cp]
    up: torch.Tensor      # [Rp, 3, Cp]
    a_fwd: torch.Tensor   # [Rp, S, Cp]
    a_bwd: torch.Tensor   # [Rp, S, Cp]
    rb: int
    bb: int


def _pad_rows(p: torch.Tensor, Rp: int) -> torch.Tensor:
    if p.shape[0] == Rp:
        return p
    fill = torch.full((Rp - p.shape[0],) + tuple(p.shape[1:]), INF,
                      dtype=p.dtype, device=p.device)
    return torch.cat([p, fill], dim=0)


def prepare_padded(
    plan: BandedKernelPlan, seeds: torch.Tensor, *, rb: int = 1, bb: int = PASS_LANES
) -> PaddedProblem:
    """Pad the planes to a multiple of `rb` rows and seed the padded field
    (lanes padded to a multiple of `bb`). The CUDA pass has no row blocks
    (rb=1) and runs 8-lane blocks; the reference's interpreter runs rb=2."""
    B = seeds.shape[0]
    R, C, Cp = plan.n_rows, plan.n_cols, plan.n_cols_pad
    Rp = _round_up(R, rb)
    Bp = _round_up(B, bb)
    seeds = seeds.long()
    flat_pad = (seeds // C) * Cp + seeds % C
    d0 = torch.full((Rp * Cp, Bp), INF, dtype=torch.float32, device=plan.device)
    d0[flat_pad, torch.arange(B, device=plan.device)] = 0.0
    return PaddedProblem(
        d0=d0.view(Rp, Cp, Bp),
        down=_pad_rows(plan.down, Rp),
        up=_pad_rows(plan.up, Rp),
        a_fwd=_pad_rows(plan.a_fwd, Rp),
        a_bwd=_pad_rows(plan.a_bwd, Rp),
        rb=rb,
        bb=bb,
    )


# --------------------------------------------------------------------------
# kernel 1: the directional pass
# --------------------------------------------------------------------------

def _shift_cols(x: torch.Tensor, k: int) -> torch.Tensor:
    """result[c] = x[c-k] along dim 0 (k > 0) or x[c+|k|] (k < 0), +inf fill."""
    out = torch.full_like(x, INF)
    if k > 0:
        out[k:] = x[:-k]
    else:
        out[:k] = x[-k:]
    return out


def _scan_row(row: torch.Tensor, af: torch.Tensor, ab: torch.Tensor) -> torch.Tensor:
    """Flat Hillis-Steele min-plus scans over the chain-weight stacks
    (af/ab [S, Cp]): forward then backward (pallas_banded.py:958-966)."""
    for s in range(af.shape[0]):
        row = torch.minimum(row, _shift_cols(row, 1 << s) + af[s][:, None])
    for s in range(ab.shape[0]):
        row = torch.minimum(row, _shift_cols(row, -(1 << s)) + ab[s][:, None])
    return row


def directional_pass_plain(
    d: torch.Tensor, cross: torch.Tensor, a_fwd: torch.Tensor, a_bwd: torch.Tensor,
    *, reverse: bool, bb: int, atol: float, rtol: float, force: bool = False,
) -> torch.Tensor:
    """Plain PyTorch version of the pass, in place on d [Rp, Cp, Bp]: the
    main-path configuration of _pass_kernel (skip=True, use_dirty=False,
    full depth). Rows run in order, the carried row is the row as written,
    `imp` is an any over each block of `bb` lanes and writes gate on
    need = imp | (force & any finite). Returns the changed flag, int32 [1]."""
    Rp, Cp, Bp = d.shape
    nb = Bp // bb
    k = 1.0 + rtol
    prev = torch.full((Cp, Bp), INF, dtype=d.dtype, device=d.device)
    changed = torch.zeros((), dtype=torch.bool, device=d.device)

    def block_any(x):
        return x.view(Cp, nb, bb).any(dim=2).any(dim=0).repeat_interleave(bb)

    for r in (range(Rp - 1, -1, -1) if reverse else range(Rp)):
        cur = d[r]
        x = cross[r]
        cand = torch.minimum(
            torch.minimum(
                _shift_cols(prev, 1) + x[0][:, None], prev + x[1][:, None]
            ),
            _shift_cols(prev, -1) + x[2][:, None],
        )
        row0 = torch.minimum(cur, cand)
        imp = block_any(cand * k + atol < cur)
        need = imp | block_any(row0 < INF) if force else imp
        changed |= imp.any()
        if bool(need.any()):
            new = torch.where(need[None, :], _scan_row(row0, a_fwd[r], a_bwd[r]), cur)
            d[r] = new
            prev = new
        else:
            prev = cur
    return changed.to(torch.int32).reshape(1)


def directional_pass(
    d: torch.Tensor, cross: torch.Tensor, a_fwd: torch.Tensor, a_bwd: torch.Tensor,
    *, reverse: bool, bb: int = PASS_LANES, atol: float, rtol: float,
    force: bool = False,
) -> torch.Tensor:
    """One directional Gauss-Seidel pass over every row of d, in place.
    CPU tensors run directional_pass_plain; CUDA tensors launch the
    csrc/banded_pass.cu kernel (8-lane blocks) or raise. Returns the changed
    flag as an int32 [1] tensor on d's device."""
    if d.device.type == "cpu":
        return directional_pass_plain(
            d, cross, a_fwd, a_bwd, reverse=reverse, bb=bb, atol=atol,
            rtol=rtol, force=force,
        )
    if d.device.type != "cuda":
        raise ValueError(f"directional_pass: unsupported device {d.device}")
    Rp, Cp, Bp = d.shape
    if bb != PASS_LANES or Bp % PASS_LANES:
        raise ValueError(f"the CUDA pass runs {PASS_LANES}-lane blocks (bb={bb}, Bp={Bp})")
    if Cp > 1024:
        raise ValueError(f"the CUDA pass takes at most 1024 columns, got {Cp}")
    for name, t, shape in (
        ("d", d, (Rp, Cp, Bp)), ("cross", cross, (Rp, 3, Cp)),
        ("a_fwd", a_fwd, (Rp, a_fwd.shape[1], Cp)),
        ("a_bwd", a_bwd, (Rp, a_bwd.shape[1], Cp)),
    ):
        if t.device != d.device or t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"directional_pass: bad {name} {tuple(t.shape)} {t.dtype} {t.device}")
    if not (d.is_contiguous() and cross.is_contiguous()
            and a_fwd.stride(2) == 1 and a_bwd.stride(2) == 1):
        raise ValueError("directional_pass: d and cross must be contiguous")
    chg = torch.zeros(1, dtype=torch.int32, device=d.device)
    stream = torch.cuda.current_stream(d.device).cuda_stream
    err = kernels.launcher("banded_pass")(
        d.data_ptr(), cross.data_ptr(), a_fwd.data_ptr(), a_fwd.stride(0),
        a_bwd.data_ptr(), a_bwd.stride(0), chg.data_ptr(), Rp, Cp, Bp,
        int(reverse), int(force), 1.0 + rtol, atol, stream,
    )
    kernels.check("banded_pass", err)
    kernels.LAUNCHES["banded_pass"] += 1
    return chg


# --------------------------------------------------------------------------
# kernel 2: int8 class predecessors + fixed-point certificate
# --------------------------------------------------------------------------

def _w8_planes(plan: BandedKernelPlan, Rp: int) -> torch.Tensor:
    """In-edge weight planes in class order, [Rp, 8, Cp]."""
    planes = [plan.lat_fwd, plan.lat_bwd] + [plan.down[:, i] for i in range(3)] + [
        plan.up[:, i] for i in range(3)
    ]
    return torch.stack([_pad_rows(p, Rp) for p in planes], dim=1).contiguous()


def class_pred_plain(
    d: torch.Tensor, w8: torch.Tensor, *, R: int, C: int, V: int,
    tol: float, atol: float, rtol: float, row_chunk: int = 64,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the class-pred pass over d [Rp, Cp, Bp]:
    argmin over the 8 classes with strict < in class order, halo rows
    clamped at the field's edges, class 8 = self. Rows go in chunks so the
    temporaries stay small. Returns (cls [V, Bp] int8, violation bool [])."""
    Rp, Cp, Bp = d.shape
    dev = d.device
    out = torch.empty((R * C, Bp), dtype=torch.int8, device=dev)
    viol = torch.zeros((), dtype=torch.bool, device=dev)
    kt, kr = 1.0 + tol, 1.0 + rtol
    for r0 in range(0, Rp, row_chunk):
        r1 = min(r0 + row_chunk, Rp)
        idx = torch.arange(r0 - 1, r1 + 1, device=dev).clamp(0, Rp - 1)
        blk = d[idx]                                   # [n+2, Cp, Bp]
        cur, upr, dnr = blk[1:-1], blk[:-2], blk[2:]
        sh = lambda x, k: _shift_cols(x.transpose(0, 1), k).transpose(0, 1)
        srcs = (sh(cur, 1), sh(cur, -1), sh(upr, 1), upr, sh(upr, -1),
                sh(dnr, 1), dnr, sh(dnr, -1))
        w = w8[r0:r1]                                  # [n, 8, Cp]
        best = torch.full_like(cur, INF)
        rel = torch.zeros(cur.shape, dtype=torch.int8, device=dev)
        for k in range(8):
            cand = srcs[k] + w[:, k, :, None]
            take = cand < best
            best = torch.where(take, cand, best)
            rel = torch.where(take, torch.tensor(k, dtype=torch.int8, device=dev), rel)
        has = (best <= cur * kt + tol) & (cur > 0) & torch.isfinite(cur)
        viol |= (best * kr + atol < cur).any()
        cls = torch.where(has, rel, torch.tensor(8, dtype=torch.int8, device=dev))
        rr = min(r1, R) - r0
        if rr > 0:
            out[r0 * C:(r0 + rr) * C] = cls[:rr, :C].reshape(rr * C, Bp)
    return out[:V], viol


def class_pred(
    d: torch.Tensor, w8: torch.Tensor, *, R: int, C: int, V: int,
    tol: float, atol: float, rtol: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """int8 class-predecessor table [V, Bp] and the fixed-point violation
    flag of a padded field. CPU tensors run class_pred_plain; CUDA tensors
    launch csrc/class_pred.cu or raise. The flag is a [1] int32 (CUDA) or
    [] bool (CPU) tensor; test it with bool()."""
    if d.device.type == "cpu":
        return class_pred_plain(d, w8, R=R, C=C, V=V, tol=tol, atol=atol, rtol=rtol)
    if d.device.type != "cuda":
        raise ValueError(f"class_pred: unsupported device {d.device}")
    Rp, Cp, Bp = d.shape
    if Bp % 4:
        raise ValueError(f"class_pred: lanes must be a multiple of 4, got {Bp}")
    if not (d.is_contiguous() and d.dtype == torch.float32):
        raise ValueError("class_pred: d must be contiguous f32")
    if (tuple(w8.shape) != (Rp, 8, Cp) or w8.dtype != torch.float32
            or not w8.is_contiguous() or w8.device != d.device):
        raise ValueError(f"class_pred: bad w8 {tuple(w8.shape)}")
    if R > Rp or C > Cp or V > R * C:
        raise ValueError("class_pred: R, C, V exceed the padded field")
    if Rp > 65535:
        raise ValueError(f"class_pred: at most 65535 rows, got {Rp}")
    out = torch.empty((V, Bp), dtype=torch.int8, device=d.device)
    viol = torch.zeros(1, dtype=torch.int32, device=d.device)
    stream = torch.cuda.current_stream(d.device).cuda_stream
    err = kernels.launcher("class_pred")(
        d.data_ptr(), w8.data_ptr(), out.data_ptr(), viol.data_ptr(),
        R, C, Rp, Cp, Bp, V, 1.0 + tol, tol, 1.0 + rtol, atol, stream,
    )
    kernels.check("class_pred", err)
    kernels.LAUNCHES["class_pred"] += 1
    return out, viol


def predecessors_banded_classes(
    plan: BandedKernelPlan, d_pad: torch.Tensor, *, tol: float = 1e-5,
    check: tuple | None = None,
):
    """int8 class table [V, Bp] (0..7 in class order, 8 = self) of a padded
    field; with check=(atol, rtol) also the converged flag (True when no
    edge violates the fixed point by more than the tolerance)."""
    if plan.n_residual:
        raise ValueError("class pred table requires n_residual == 0")
    Rp = d_pad.shape[0]
    atol, rtol = check if check is not None else (0.0, 0.0)
    cls, viol = class_pred(
        d_pad, _w8_planes(plan, Rp), R=plan.n_rows, C=plan.n_cols,
        V=plan.num_vertices, tol=tol, atol=atol, rtol=rtol,
    )
    if check is None:
        return cls
    return cls, not bool(viol.any())


# --------------------------------------------------------------------------
# solve loop
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BandedPaddedResult:
    """Converged field on the padded [Rp, Cp, Bp] grid; with
    converge="pred" also the int8 class table [V, Bp] of its certificate."""
    d_pad: torch.Tensor
    rounds: int
    converged: bool
    cls: torch.Tensor | None = None


def banded_solve_padded(
    plan: BandedKernelPlan,
    seeds: torch.Tensor,
    *,
    max_rounds: int = 256,
    atol: float = 1e-5,
    rtol: float = 1e-5,
    converge: str = "round",
    timer=None,
) -> BandedPaddedResult:
    """Banded GS rounds (one pass down, the first forced, one pass up) to
    convergence on the padded field. converge="pred": after every round the
    class-pred pass runs and its violation flag ends the loop, so the last
    certificate's table comes out of the solve. converge="round": the loop
    ends on a round with no supra-tolerance improvement. One host read of a
    flag per round. Only full-depth, residual-free plans (the main path);
    other configurations of the reference raise NotImplementedError."""
    if converge not in ("pred", "round"):
        raise NotImplementedError(f"converge={converge!r}")
    if plan.n_residual:
        raise NotImplementedError("residual (irregular) plans")
    full = max(1, int(math.ceil(math.log2(max(plan.n_cols, 2)))))
    if plan.n_scan < full:
        raise NotImplementedError("partial scan depth")
    prob = prepare_padded(plan, seeds)
    d = prob.d0
    Rp = d.shape[0]

    def one_round(force: bool) -> torch.Tensor:
        with _stage(timer, "solve"):
            c_dn = directional_pass(
                d, prob.down, prob.a_fwd, prob.a_bwd, reverse=False,
                atol=atol, rtol=rtol, force=force,
            )
            c_up = directional_pass(
                d, prob.up, prob.a_fwd, prob.a_bwd, reverse=True,
                atol=atol, rtol=rtol,
            )
        return c_dn | c_up

    if converge == "pred":
        # at zero tolerance a 1-ulp difference between a chain-weight write
        # and the certificate's single-edge recomputation can live-lock the
        # loop (pallas_banded.py:1962-1964)
        assert plan.n_residual == 0, "converge='pred' needs n_residual == 0"
        assert atol > 0 or rtol > 0, "converge='pred' needs tolerance > 0"
        pred_tol = max(atol, 3.0 * rtol)
        w8 = _w8_planes(plan, Rp)

        def certificate():
            with _stage(timer, "pred"):
                cls, viol = class_pred(
                    d, w8, R=plan.n_rows, C=plan.n_cols, V=plan.num_vertices,
                    tol=pred_tol, atol=atol, rtol=rtol,
                )
                return cls, bool(viol.any())

        one_round(True)
        cls, violated = certificate()
        rounds = 1
        while violated and rounds < max_rounds:
            cls = None   # free the previous table before the next is made
            one_round(False)
            cls, violated = certificate()
            rounds += 1
        return BandedPaddedResult(d_pad=d, rounds=rounds, converged=not violated, cls=cls)

    changed = bool(one_round(True).any())
    rounds = 1
    while changed and rounds < max_rounds:
        changed = bool(one_round(False).any())
        rounds += 1
    return BandedPaddedResult(d_pad=d, rounds=rounds, converged=not changed)


# --------------------------------------------------------------------------
# lanes, path walk, predecessor lookup
# --------------------------------------------------------------------------

def group_lanes(goal_v: torch.Tensor, num_vertices: int, n_buckets: int = 128):
    """Stable grouping of lanes by quantized goal id, so the pass's batch
    blocks hold neighbouring wavefronts. Same permutation as the reference's
    one-hot/cumsum bucket grouping (a stable sort by bucket).
    Returns (order, inv): x[order] groups lanes; y[inv] restores them."""
    B = goal_v.shape[0]
    bucket_w = max(1, -(-num_vertices // n_buckets))
    q = torch.clamp(goal_v.long() // bucket_w, 0, n_buckets - 1)
    order = torch.sort(q, stable=True).indices
    inv = torch.empty_like(order)
    inv[order] = torch.arange(B, device=goal_v.device)
    return order, inv


def extract_paths_cls(
    cls_vb: torch.Tensor,      # [V, >= B] int8 class table (lane-minor)
    start_v: torch.Tensor,     # [B]
    goal_v: torch.Tensor,      # [B]
    max_len: int,
    C: int,
    *,
    chunk: int = 256,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Walk each lane's predecessor chain from start to goal, decoding
    next = v + delta[class] (class 8 = self ends the walk). Chunks of
    `chunk` steps, with one host check of any(alive) before each chunk.
    Returns (path [B, max_len] i64, valid [B, max_len] bool); dead steps
    repeat the terminal vertex with valid False."""
    dev = start_v.device
    B = start_v.shape[0]
    lane = torch.arange(B, device=dev)
    delta = torch.tensor([-1, 1, -C - 1, -C, -C + 1, C - 1, C, C + 1, 0, 0],
                         dtype=torch.int64, device=dev)
    n_chunks = -(-max_len // chunk)
    L1 = n_chunks * chunk
    v = start_v.long().clone()
    goal = goal_v.long()
    alive = torch.ones(B, dtype=torch.bool, device=dev)
    path = v[None, :].repeat(L1, 1)
    valid = torch.zeros((L1, B), dtype=torch.bool, device=dev)
    for j in range(n_chunks):
        if not bool(alive.any()):
            break
        for i in range(j * chunk, (j + 1) * chunk):
            path[i] = v
            valid[i] = alive
            k = cls_vb[v, lane].long()
            nxt = v + delta[k]
            alive = alive & (v != goal) & (k != 8)
            v = torch.where(alive, nxt, v)
    fill = torch.where(valid, path, v[None, :])
    return fill[:max_len].T, valid[:max_len].T


def _to_padded_flat(plan: BandedKernelPlan, v: torch.Tensor) -> torch.Tensor:
    return (v // plan.n_cols) * plan.n_cols_pad + v % plan.n_cols


def _inbound_tables(plan: BandedKernelPlan):
    """(W8 [8, R*Cp] padded-flat in-edge weights, offs [8] real id offsets)."""
    C = plan.n_cols
    offs = torch.tensor([-1, 1, -C - 1, -C, -C + 1, C - 1, C, C + 1],
                        dtype=torch.int64, device=plan.device)
    W8 = torch.stack(
        [plan.lat_fwd.reshape(-1), plan.lat_bwd.reshape(-1)]
        + [plan.down[:, i].reshape(-1) for i in range(3)]
        + [plan.up[:, i].reshape(-1) for i in range(3)]
    )
    return W8, offs


def pred_at_vertices(
    plan: BandedKernelPlan,
    d_flat: torch.Tensor,      # [Rp*Cp, Bp] raw padded field (d_pad reshaped)
    vids: torch.Tensor,        # [B, K] real vertex ids
    *,
    tol: float = 1e-5,
    lane_map: torch.Tensor | None = None,   # [B] solver lane of each robot
) -> torch.Tensor:
    """Predecessor of a few vertices per lane straight from the padded
    field: argmin over the eight class in-edges of d[u] + w(u, v), self when
    no neighbour explains the label. Returns real vertex ids [B, K]."""
    B = vids.shape[0]
    V = plan.num_vertices
    W8, offs = _inbound_tables(plan)
    vids = vids.long()
    lane = (torch.arange(B, device=vids.device) if lane_map is None
            else lane_map.long())[:, None]
    u_cl = torch.clamp(vids[None] + offs[:, None, None], 0, V - 1)   # [8, B, K]
    du = d_flat[_to_padded_flat(plan, u_cl), lane[None]]
    dv = d_flat[_to_padded_flat(plan, vids), lane]
    cand = du + W8[:, _to_padded_flat(plan, vids)]
    best, arg = torch.min(cand, dim=0)
    u_best = torch.gather(u_cl, 0, arg[None])[0]
    has = (best <= dv * (1.0 + tol) + tol) & (dv > 0) & torch.isfinite(dv)
    return torch.where(has, u_best, vids)
