"""Banded Gauss-Seidel solve with hand-written Hopper kernels.

Counterpart of mesh_navigation_tpu/ops/pallas_banded.py: the host plan
builder (BandedKernelPlan / build_banded_kernel_plan, :56-511), the padded
problem (prepare_padded, :1332), the solve loop (banded_solve_padded,
:1413, converge="pred", "round" and "check", the warm incremental
resolve with its row-slab window, and the init_pad propagation mode; on
irregular plans the extended lanes and the residual scatter-min,
:1530-1678; the options: bfloat16 fields, skip_rows, partial scan depth,
the deferring pass and four_dir's column passes on the transposed plan,
transpose_banded_plan, :3014), lane grouping (:2041), the int8 class predecessor table
(:2531) with its residual reconcile (:2588) and the int32 real-id table
with its residual post-pass (predecessors_banded_pallas, :2463), the
roll-based predecessors (predecessors_banded, :1235) and the full-result
solve (batched_field_banded_pallas, :2969), the class-decoding path walk
with the class-9 decode (:2644), the walk over a lane-minor id table
(:2785), the on-the-fly predecessor lookup with the
residual probe (:2834), the greedy descent (:2923), and the live-replan
plane refreshes (from a slot-weight table or from costs), residual weights
and changed-region planes (:512-807, :2069-2143). The extended lanes'
edges that exist are also kept as per-row lists (XLaneList), which the
pass kernel reads in place of the dense lane planes.

Three kernels carry the solve; each has a plain PyTorch version beside it
with the same semantics (row order, carry, gated writes, class order):

- `directional_pass` — csrc/banded_pass.cu, replacing `_pass_kernel`, with
  its dirty-table, warm-cut, extended-lane, partial-depth, deferring and
  unskipped modes, on f32 or bfloat16 fields;
- `class_pred` — csrc/class_pred.cu, replacing `_pred_kernel` in both of its
  modes (int8 classes with the certificate; int32 real ids);
- `check` — csrc/check.cu, replacing `_check_kernel`;
the last two read f32 or bfloat16 fields and compute in f32.

A wrapper runs the plain version only for a tensor on the CPU. On a CUDA
tensor it launches the kernel or raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from mesh_navigation_torch.mesh.arrays import MeshArrays, host_array
from mesh_navigation_torch.ops import banded as _banded
from mesh_navigation_torch.ops import kernels
from mesh_navigation_torch.ops import sweeps as _sweeps
from mesh_navigation_torch.utils.timing import span as _span
from mesh_navigation_torch.utils.timing import stage as _stage

INF = float("inf")
PASS_LANES = 8   # batch lanes per CUDA block of the pass kernel
# the pass kernel's widest row (csrc/banded_pass.cu MAX_COLS): 512 threads of
# PASS_WIDE_COLS columns, each column's 8 lanes in registers; the carried row
# (Cp * 8 lanes * 4 B, 128 KB at 4,096 columns) fits a block's shared memory.
# Wider banded plans take the structured tier.
PASS_WIDE_COLS = 8
PASS_MAX_COLS = 512 * PASS_WIDE_COLS
# with a second carried row (a plan with extended lanes two rows away, sel 2)
# two rows of Cp * 8 lanes * 4 B must fit beside the block's scan scratch:
# the widest such row by the launcher's reckoning (csrc/banded_pass.cu
# MAX_COLS_X2, 14 x 256 columns). Wider plans with such lanes take the
# structured tier.
PASS_MAX_COLS_X2 = 3584
# with a third row (the partial-depth scan's exchange row beside two carried
# rows): csrc/banded_pass.cu MAX_COLS_X3, 9 x 256 columns. Without a sel-2
# lane the partial-depth pass takes PASS_MAX_COLS_X2 columns.
PASS_MAX_COLS_X3 = 2304
# the widest column shift of an extended lane (the prescan's halo)
PASS_MAX_XDC = 4
# the extended-lane lists (csrc/banded_pass.cu XG, XL_HEAD): columns of a
# group (a thread's four columns), ints of a row's header before its offsets
XLIST_GROUP = 4
XLIST_HEAD = 5


def pass_cols_per_thread(Cp: int) -> int:
    """Columns one thread of the pass kernel holds (csrc/banded_pass.cu
    cols_per_thread): 1 for rows of one warp (the reference's flat scan, bit
    for bit), 4 up to 1,024 columns, else PASS_WIDE_COLS."""
    return 1 if Cp <= 32 else (4 if Cp <= 1024 else PASS_WIDE_COLS)


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


def xlist_width(Cp: int) -> int:
    """Ints a row's header of an extended-lane list takes (XLaneList.goff):
    XLIST_HEAD ints, then a 16-bit offset for each XLIST_GROUP-column group
    and the row's end, two to an int; rounded up to 4 (16 bytes)."""
    return _round_up(XLIST_HEAD + -(-(-(-Cp // XLIST_GROUP) + 1) // 2), 4)


def _list_heads(start: torch.Tensor, count: torch.Tensor, sub: torch.Tensor, N: int,
                Cp: int) -> torch.Tensor:
    """Row headers [R, xlist_width(Cp)] int32 of a list whose row r starts
    at entry start[r] with count[r] entries, sub [R, G + 1] the entries
    before each XLIST_GROUP-column group and the row's end (N: the entries
    in all, the first entry of the rows past the last)."""
    R = start.shape[0]
    if R and int(count.max()) > 0xffff:
        raise ValueError("an extended-lane list row holds more than 65,535 entries")
    heads = torch.zeros((R, xlist_width(Cp)), dtype=torch.int64, device=start.device)
    heads[:, 0] = start
    heads[:, 1] = torch.cat([start[1:], start.new_full((1,), N)])
    heads[:, 2] = torch.cat([count[1:], count.new_zeros(1)])
    heads[1:, 3], heads[1:, 4] = start[:-1], count[:-1]
    half = torch.zeros((R, 2 * (heads.shape[1] - XLIST_HEAD)), dtype=torch.int64,
                       device=start.device)
    half[:, :sub.shape[1]] = sub
    words = half[:, 0::2] | half[:, 1::2] << 16
    heads[:, XLIST_HEAD:] = torch.where(words >= 1 << 31, words - (1 << 32), words)
    return heads.to(torch.int32).contiguous()


@dataclasses.dataclass(frozen=True)
class XLaneList:
    """The extended-lane edges of one pass direction that exist, row by row:
    what the pass kernel reads in place of the dense [R, L, Cp] planes.

    Entries are sorted by (row, column, lane), and each row's first entry
    sits at a multiple of 4 (the rows are padded apart with entries of +inf
    weight that no row holds). goff [R, xlist_width(Cp)] int32 holds a
    header per row: its first entry; the first entry and the count of the
    row after it and of the row before it (the kernel stages a row's
    neighbour from these); then 16-bit offsets from the row's first entry
    of each XLIST_GROUP-column group's first entry and of the row's end.
    meta [N] int32 packs column | sel << 12 | (dc + 4) << 14 | lane << 18.
    w [N] f32 is a gather of the dense planes through src [N] int64 (flat
    index into [R, L, Cp]; -1 for padding). max_row: the most entries of
    one row (at most 65,535). Which edges exist comes from the plan's
    static tables, not from the weights: an edge whose weight turns +inf
    stays and relaxes nothing. An edge whose source column lies off the
    row is left out (the pass relaxes nothing from there)."""
    goff: torch.Tensor
    meta: torch.Tensor
    w: torch.Tensor
    src: torch.Tensor
    max_row: int

    @property
    def n_rows(self) -> int:
        return self.goff.shape[0]

    def offsets(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(first entry [R], offsets [R, G + 1] of each group's first entry
        and of the row's end from it), decoded from the headers."""
        words = self.goff[:, XLIST_HEAD:].long() & 0xffffffff
        half = torch.stack([words & 0xffff, words >> 16], dim=2).flatten(1)
        return self.goff[:, 0].long(), half

    def row_counts(self, Cp: int) -> torch.Tensor:
        """The entries of each row, [R]."""
        return self.offsets()[1][:, -(-Cp // XLIST_GROUP)]

    def with_weights(self, planes: torch.Tensor) -> "XLaneList":
        """The same edges with their weights gathered from `planes` (the
        dense [R, L, Cp] planes the list was built for), on the planes'
        device, with no host read."""
        flat = planes.reshape(-1)
        w = torch.where(self.src >= 0, flat[self.src.clamp(min=0)], INF).to(torch.float32)
        return dataclasses.replace(self, w=w)

    def rows(self, r0: int, r1: int) -> "XLaneList":
        """Rows r0 .. r1 - 1 (a slab of the field): a view of the headers
        over the same entries."""
        return dataclasses.replace(self, goff=self.goff[r0:r1])

    def pad_rows(self, Rp: int, Cp: int) -> "XLaneList":
        """Rows past the list's up to Rp, with no entries."""
        R = self.n_rows
        if Rp == R:
            return self
        start, sub = self.offsets()
        G = -(-Cp // XLIST_GROUP)
        N = self.meta.shape[0]
        start = torch.cat([start, start.new_full((Rp - R,), N)])
        sub = torch.cat([sub[:, :G + 1], sub.new_zeros((Rp - R, G + 1))])
        return dataclasses.replace(self, goff=_list_heads(start, sub[:, G], sub, N, Cp))

    def to(self, device) -> "XLaneList":
        dev = torch.device(device)
        return dataclasses.replace(self, goff=self.goff.to(dev), meta=self.meta.to(dev),
                                   w=self.w.to(dev), src=self.src.to(dev))

    def dense(self, n_lanes: int, Cp: int) -> torch.Tensor:
        """The [R, n_lanes, Cp] planes the entries stand for (+inf where none)."""
        out = torch.full((self.n_rows * n_lanes * Cp,), INF, dtype=torch.float32,
                         device=self.w.device)
        keep = self.src >= 0
        out[self.src[keep]] = self.w[keep]
        return out.view(self.n_rows, n_lanes, Cp)


def build_xlane_list(present: torch.Tensor, planes: torch.Tensor, xlanes) -> XLaneList:
    """The lists of the lanes `xlanes` ((sel, dc) each) over the edges that
    `present` ([R, L, Cp] bool) marks, weights gathered from `planes`
    ([R, L, Cp] f32), on their device. Built once per plan (one host read);
    a refresh regathers the weights (XLaneList.with_weights)."""
    R, L, Cp = present.shape
    dev = present.device
    if L != len(xlanes) or tuple(planes.shape) != (R, L, Cp):
        raise ValueError(f"build_xlane_list: {L} planes of {tuple(planes.shape)} for "
                         f"{len(xlanes)} lanes")
    sel = torch.tensor([s for s, _ in xlanes], dtype=torch.int64, device=dev)
    dc = torch.tensor([c for _, c in xlanes], dtype=torch.int64, device=dev)
    src_col = torch.arange(Cp, device=dev)[None, :] + dc[:, None]                 # [L, Cp]
    on_row = (src_col >= 0) & (src_col < Cp)
    r, c, li = torch.nonzero((present & on_row[None]).permute(0, 2, 1), as_tuple=True)
    n_row = torch.bincount(r, minlength=R)
    padded = (n_row + 3) // 4 * 4
    start = torch.cumsum(padded, 0) - padded
    first = torch.cumsum(n_row, 0) - n_row
    n_pad, max_row = (torch.stack([padded.sum(), n_row.max()]).tolist() if R else (0, 0))
    N = max(4, n_pad)
    pos = start[r] + torch.arange(r.shape[0], device=dev) - first[r]
    meta = torch.zeros(N, dtype=torch.int64, device=dev)
    meta[pos] = c | sel[li] << 12 | (dc[li] + 4) << 14 | li << 18
    src = torch.full((N,), -1, dtype=torch.int64, device=dev)
    src[pos] = (r * L + li) * Cp + c
    G = -(-Cp // XLIST_GROUP)
    per_group = torch.zeros(R * G, dtype=torch.int64, device=dev)
    per_group.index_add_(0, r * G + c // XLIST_GROUP, torch.ones_like(r))
    sub = torch.cat([per_group.new_zeros((R, 1)), torch.cumsum(per_group.view(R, G), dim=1)],
                    dim=1)
    out = XLaneList(goff=_list_heads(start, n_row, sub, N, Cp), meta=meta.to(torch.int32),
                    w=meta.new_zeros(0, dtype=torch.float32), src=src, max_row=int(max_row))
    return out.with_weights(planes)


def xlane_list_from_dense(xcross: torch.Tensor, xlanes) -> XLaneList:
    """Lists of the finite weights of dense [Rp, L, Cp] lane planes: for
    inputs that hold only dense planes (tests, stress scripts). A plan's
    solve takes the lists its plan holds, from its static tables."""
    return build_xlane_list(torch.isfinite(xcross), xcross, tuple(xlanes))


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
    # transpose_banded_plan only: the transposed lanes (dr_t, dc_t) left out
    # (|dr_t| > 2); their edges stay on the residual list
    xlanes_dropped: tuple = ()
    # the extended lanes' edges that exist, row by row (XLaneList; None
    # without lanes): what the pass kernel reads in place of xdown / xup
    xlist_down: XLaneList | None = None
    xlist_up: XLaneList | None = None
    # the [Rp, 8, Cp] class-order weight stacks of _w8_planes, by Rp; a
    # refreshed plan (dataclasses.replace) starts with none
    w8_cache: dict = dataclasses.field(default_factory=dict, init=False, repr=False,
                                       compare=False)

    @property
    def device(self) -> torch.device:
        return self.down.device


def _class_offsets(n: int) -> list[int]:
    """Banded class order: lat -1, lat +1, down s=-1,0,+1, up s=-1,0,+1."""
    return [-1, +1, -(n + 1), -n, -(n - 1), n - 1, n, n + 1]


def _xp(x):
    """numpy or torch, whichever `x` belongs to: the host plan builder runs
    these helpers on numpy arrays, the plane refresh on device tensors."""
    return torch if isinstance(x, torch.Tensor) else np


def _shift2(x, dr: int, dc: int, fill=INF):
    """result[r, c] = x[r+dr, c+dc] over [R, Cp], `fill` outside."""
    R, C = x.shape
    out = _xp(x).full_like(x, fill)
    rs = slice(max(dr, 0), R + min(dr, 0))
    rd = slice(max(-dr, 0), R + min(-dr, 0))
    cs = slice(max(dc, 0), C + min(dc, 0))
    cd = slice(max(-dc, 0), C + min(-dc, 0))
    out[rd, cd] = x[rs, cs]
    return out


def _effective_laterals(lat_fwd, lat_bwd, down, up):
    """min(direct, 2-hop detours through rows r-1 / r+1) for the +-1 lateral
    chain links — exact path costs, so the scan chains stay valid."""
    xp = _xp(lat_fwd)
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
        lat_f = xp.minimum(lat_f, cand)
    lat_b = lat_bwd
    for cand in (
        S(u[1], -1, 1) + dn[2],
        S(u[2], -1, 0) + dn[1],
        S(dn[1], 1, 1) + u[2],
        S(dn[2], 1, 0) + u[1],
    ):
        lat_b = xp.minimum(lat_b, cand)
    return lat_f, lat_b


def _chain_weights(lat_fwd, lat_bwd, n_scan):
    """A_f[s][c] = cost of the lateral chain (c - 2^s) -> c, +inf where the
    chain leaves the row. Returns two [R, S, Cp] stacks."""
    xp = _xp(lat_fwd)

    def shift_d(x, k):
        return xp.concatenate([xp.full_like(x[..., :k], INF), x[..., :-k]], axis=-1)

    def shift_u(x, k):
        return xp.concatenate([x[..., k:], xp.full_like(x[..., :k], INF)], axis=-1)

    a_fwd = [lat_fwd]
    a_bwd = [lat_bwd]
    for s in range(1, n_scan):
        k = 1 << (s - 1)
        a_fwd.append(shift_d(a_fwd[-1], k) + a_fwd[-1])
        a_bwd.append(shift_u(a_bwd[-1], k) + a_bwd[-1])
    return xp.stack(a_fwd, axis=1), xp.stack(a_bwd, axis=1)


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
    af0 = a_fwd[:, 0, :].reshape(R, NB, 8)
    ab0 = a_bwd[:, 0, :].reshape(R, NB, 8)
    if isinstance(a_fwd, torch.Tensor):
        wf = torch.cumsum(af0, dim=-1).reshape(R, Cp)
        wb = torch.flip(torch.cumsum(torch.flip(ab0, [-1]), dim=-1), [-1]).reshape(R, Cp)
        return S2, l2f.contiguous(), l2b.contiguous(), wf, wb
    wf = np.cumsum(af0, axis=-1).reshape(R, Cp)
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
    plan = BandedKernelPlan(
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
    return with_xlane_lists(plan)


def xlane_present(plan: BandedKernelPlan, name: str) -> torch.Tensor:
    """[R, L, Cp] bool: the edges of the `name` ("down" / "up") extended
    lanes that exist, from the plan's slot maps (xslot_*)."""
    slots = getattr(plan, f"xslot_{name}")
    return torch.stack([_grid_plane(plan, slots[i] >= 0, False)
                        for i in range(len(getattr(plan, f"xlanes_{name}")))], dim=1)


def with_xlane_lists(plan: BandedKernelPlan, present_down=None,
                     present_up=None) -> BandedKernelPlan:
    """`plan` with the lists of its extended lanes (XLaneList): the edges
    that exist from `present_*` ([R, L, Cp] bool; default: the plan's slot
    maps), the weights from xdown / xup. None where a direction has no lane."""
    lists = {}
    for name, present in (("down", present_down), ("up", present_up)):
        lanes = getattr(plan, f"xlanes_{name}")
        if not lanes:
            lists[f"xlist_{name}"] = None
            continue
        if present is None:
            present = xlane_present(plan, name)
        lists[f"xlist_{name}"] = build_xlane_list(present, getattr(plan, f"x{name}"), lanes)
    return dataclasses.replace(plan, **lists)


def with_planes(plan: BandedKernelPlan, **planes) -> BandedKernelPlan:
    """`plan` with its weight planes replaced by `planes` and its lanes'
    lists' weights gathered again from the new xdown / xup: on the plan's
    device, no host read. Every refresh changes a plan's planes through it,
    so the lists the kernel reads keep the dense planes' weights."""
    plan = dataclasses.replace(plan, **planes)
    return dataclasses.replace(
        plan, **{f"xlist_{name}": (None if getattr(plan, f"xlist_{name}") is None else
                                   getattr(plan, f"xlist_{name}").with_weights(
                                       getattr(plan, f"x{name}")))
                 for name in ("down", "up")})


def transpose_banded_plan(plan: BandedKernelPlan) -> BandedKernelPlan:
    """The same relaxation system on the transposed [C, R] grid
    (pallas_banded.py:3014-3104): the column-direction passes of four_dir.
    A source offset (dr, dc) maps to (dc, dr): the transposed lateral planes
    are the original down / up planes of s = 0, T-down = [down s=-1,
    lat_fwd, up s=-1], T-up = [down s=+1, lat_bwd, up s=+1]; each plane
    [R, Cp] becomes [C, Rt] (Rt = R rounded up to 8, +inf past R). Chain
    weights come from the transposed planes at depth ceil(log2 R), with no
    two-level tables. Extended lanes transpose by the same rule, except
    that a transposed lane two rows or more away, |dr_t| = |dc| > 2, is
    left out and listed in xlanes_dropped: the pass carries two rows and
    relaxes no lane farther, and every extended-lane edge stays on the
    plan's residual list, which the round's scatter-min relaxes (the
    reference keeps such a lane and its kernel reads it as an own-row lane
    at the transposed column offset, pallas_banded.py:890-896: a lane
    (|dr_t| > 2, 0) relaxes nothing, another relaxes from the wrong
    source). Residual ids are remapped to the transposed padded grid.
    Solve-only: slot tables are the original plan's; the lanes' lists come
    from the original's edges, transposed by the same rule."""
    R, C, Cp = plan.n_rows, plan.n_cols, plan.n_cols_pad
    Rt = _round_up(R, 8)

    def T(p, fill=INF):  # [R, Cp] -> [C, Rt]
        out = torch.full((C, Rt), fill, dtype=p.dtype, device=p.device)
        out[:, :R] = p[:, :C].T
        return out

    lat_fwd_t = T(plan.down[:, 1])
    lat_bwd_t = T(plan.up[:, 1])
    down_t = torch.stack([T(plan.down[:, 0]), T(plan.lat_fwd), T(plan.up[:, 0])], dim=1)
    up_t = torch.stack([T(plan.down[:, 2]), T(plan.lat_bwd), T(plan.up[:, 2])], dim=1)
    n_scan_t = max(1, int(np.ceil(np.log2(max(R, 2)))))
    lf_eff, lb_eff = _effective_laterals(lat_fwd_t, lat_bwd_t, down_t, up_t)
    a_fwd_t, a_bwd_t = _chain_weights(lf_eff, lb_eff, n_scan_t)

    pres_down = xlane_present(plan, "down") if plan.xlanes_down else None
    pres_up = xlane_present(plan, "up") if plan.xlanes_up else None
    lanes = [(-sel, dc, plan.xdown[:, i], pres_down[:, i])
             for i, (sel, dc) in enumerate(plan.xlanes_down)]
    lanes += [(sel, dc, plan.xup[:, i], pres_up[:, i])
              for i, (sel, dc) in enumerate(plan.xlanes_up) if sel]
    xl_down, xp_down, xe_down, xl_up, xp_up, xe_up, dropped = [], [], [], [], [], [], []
    for dr, dc, p, e in lanes:
        dr_t, dc_t = dc, dr
        if abs(dr_t) > 2:
            dropped.append((dr_t, dc_t))
            continue
        pt, et = T(p), T(e, False)
        if dr_t <= 0:
            xl_down.append((abs(dr_t), dc_t))
            xp_down.append(pt)
            xe_down.append(et)
        if dr_t >= 0:
            xl_up.append((abs(dr_t), dc_t))
            xp_up.append(pt)
            xe_up.append(et)

    def xstack(ps):
        if ps:
            return torch.stack(ps, dim=1)
        return torch.full((C, 1, Rt), INF, dtype=torch.float32, device=plan.device)

    def remap(ids):
        return ((ids % Cp) * Rt + ids // Cp).to(ids.dtype)

    plan_t = BandedKernelPlan(
        n_rows=C, n_cols=R, n_cols_pad=Rt, n_scan=n_scan_t, coverage=plan.coverage,
        num_vertices=plan.num_vertices, n_residual=plan.n_residual,
        down=down_t, up=up_t, a_fwd=a_fwd_t.contiguous(), a_bwd=a_bwd_t.contiguous(),
        res_dst=remap(plan.res_dst), res_src=remap(plan.res_src), res_w=plan.res_w,
        slot_map=plan.slot_map, res_slot=plan.res_slot,
        lat_fwd=lat_fwd_t, lat_bwd=lat_bwd_t,
        xlanes_down=tuple(xl_down), xlanes_up=tuple(xl_up),
        xdown=xstack(xp_down), xup=xstack(xp_up),
        xslot_down=plan.xslot_down, xslot_up=plan.xslot_up,
        xlanes_dropped=tuple(dropped),
    )
    return with_xlane_lists(plan_t, torch.stack(xe_down, dim=1) if xe_down else None,
                            torch.stack(xe_up, dim=1) if xe_up else None)


# --------------------------------------------------------------------------
# padded problem
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PaddedProblem:
    """Seeded [Rp, Cp, Bp] field + row-padded planes for the directional
    pass (padding rows and lanes stay all +inf)."""
    d0: torch.Tensor | None   # [Rp, Cp, Bp] f32 or bfloat16
    down: torch.Tensor    # [Rp, 3, Cp]
    up: torch.Tensor      # [Rp, 3, Cp]
    a_fwd: torch.Tensor   # [Rp, S, Cp]
    a_bwd: torch.Tensor   # [Rp, S, Cp]
    rb: int
    bb: int
    xdown: torch.Tensor | None = None   # [Rp, L, Cp] extended lanes of the down pass
    xup: torch.Tensor | None = None     # [Rp, L, Cp] of the up pass (None: no lanes)
    xlist_down: XLaneList | None = None   # their lists, Rp rows (what the kernel reads)
    xlist_up: XLaneList | None = None


def _pad_rows(p: torch.Tensor, Rp: int, fill=INF) -> torch.Tensor:
    if p.shape[0] == Rp:
        return p
    pad = torch.full((Rp - p.shape[0],) + tuple(p.shape[1:]), fill,
                     dtype=p.dtype, device=p.device)
    return torch.cat([p, pad], dim=0)


def prepare_padded(
    plan: BandedKernelPlan, seeds: torch.Tensor, *, rb: int = 1, bb: int = PASS_LANES,
    seeded: bool = True, dtype=torch.float32,
) -> PaddedProblem:
    """Pad the planes to a multiple of `rb` rows and seed the padded field
    (lanes padded to a multiple of `bb`). The CUDA pass has no row blocks
    (rb=1) and runs 8-lane blocks; the reference's interpreter runs rb=2.
    The field takes the storage `dtype` (f32 or bfloat16); every plane
    stays f32 (pallas_banded.py:1355-1358).
    seeded=False leaves d0 None (a warm resolve starts from its own field).
    The extended-lane planes are padded where the plan has lanes
    (pallas_banded.py:1385-1386), and their lists with them, else left
    None."""
    B = seeds.shape[0]
    R, C, Cp = plan.n_rows, plan.n_cols, plan.n_cols_pad
    Rp = _round_up(R, rb)
    Bp = _round_up(B, bb)
    d0 = None
    if seeded:
        seeds = seeds.long()
        flat_pad = (seeds // C) * Cp + seeds % C
        d0 = torch.full((Rp * Cp, Bp), INF, dtype=dtype, device=plan.device)
        d0[flat_pad, torch.arange(B, device=plan.device)] = 0.0
        d0 = d0.view(Rp, Cp, Bp)
    return PaddedProblem(
        d0=d0,
        down=_pad_rows(plan.down, Rp),
        up=_pad_rows(plan.up, Rp),
        a_fwd=_pad_rows(plan.a_fwd, Rp),
        a_bwd=_pad_rows(plan.a_bwd, Rp),
        rb=rb,
        bb=bb,
        xdown=_pad_rows(plan.xdown, Rp).contiguous() if plan.xlanes_down else None,
        xup=_pad_rows(plan.xup, Rp).contiguous() if plan.xlanes_up else None,
        xlist_down=plan.xlist_down.pad_rows(Rp, Cp) if plan.xlanes_down else None,
        xlist_up=plan.xlist_up.pad_rows(Rp, Cp) if plan.xlanes_up else None,
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


_WARP = 32
# the pass kernel's row modes (csrc/banded_pass.cu MODE_*)
PASS_MODE_SKIP, PASS_MODE_DEFER, PASS_MODE_NOSKIP = 0, 1, 2


def _warp_pair_scan(a: torch.Tensor, b: torch.Tensor, fwd: bool):
    """Kogge-Stone scan of (a, b) pairs within each 32-lane warp, one
    shuffle step at a time as in csrc/banded_pass.cu: a [W, 32], b [W, 32,
    B]. Combining an earlier pair (ao, bo) into (a, b) gives
    (ao + a, min(b, bo + a))."""
    lane = torch.arange(_WARP, device=a.device)
    for off in (1, 2, 4, 8, 16):
        ok = lane >= off if fwd else lane + off < _WARP
        sh = off if fwd else -off
        ao, bo = torch.roll(a, sh, dims=1), torch.roll(b, sh, dims=1)
        b = torch.where(ok[None, :, None], torch.minimum(b, bo + a[:, :, None]), b)
        a = torch.where(ok[None, :], ao + a, a)
    return a, b


def _block_scan(b: torch.Tensor, a: torch.Tensor, fwd: bool, cpt: int) -> torch.Tensor:
    """Min-plus closure of one row in one direction, b [N*cpt, B] with
    level-0 chain weights a [N*cpt] (N threads, a multiple of 32), in the
    association of the pass kernel: each thread's cpt columns in order, a
    Kogge-Stone scan of the thread totals in each warp, the same scan of
    the warp totals, then each thread's last column takes its prefix over
    the block and the others fold the exclusive prefix (the thread before's
    result; at a warp's edge the warps before) into their in-thread values."""
    n = b.shape[0] // cpt
    nw = n // _WARP
    B = b.shape[1]
    bv = b.view(n, cpt, B).clone()
    av = a.view(n, cpt).clone()
    order = range(1, cpt) if fwd else range(cpt - 2, -1, -1)
    for i in order:
        k = i - 1 if fwd else i + 1
        bv[:, i] = torch.minimum(bv[:, i], bv[:, k] + av[:, i, None])
        av[:, i] = av[:, k] + av[:, i]
    last = cpt - 1 if fwd else 0
    ta, tb = _warp_pair_scan(av[:, last].reshape(nw, _WARP), bv[:, last].reshape(nw, _WARP, B), fwd)
    tail = _WARP - 1 if fwd else 0
    wa = torch.zeros(_WARP, dtype=a.dtype, device=a.device)
    wb = torch.full((_WARP, B), INF, dtype=b.dtype, device=b.device)
    wa[:nw], wb[:nw] = ta[:, tail], tb[:, tail]
    _, wb = _warp_pair_scan(wa[None], wb[None], fwd)
    wb = wb[0, :nw]                                        # [nw, B] inclusive over warps
    inf_row = wb.new_full((1, B), INF)
    P = torch.cat([inf_row, wb[:-1]]) if fwd else torch.cat([wb[1:], inf_row])
    has = torch.arange(nw, device=b.device) > 0 if fwd else torch.arange(nw, device=b.device) < nw - 1
    bh = torch.where(has[:, None, None], torch.minimum(tb, P[:, None, :] + ta[:, :, None]), tb)
    if fwd:
        E = torch.cat([P[:, None, :], bh[:, :-1]], dim=1)  # the previous thread's result
    else:
        E = torch.cat([bh[:, 1:], P[:, None, :]], dim=1)
    E = E.reshape(n, 1, B)
    out = torch.minimum(bv, E + av[:, :, None])
    out[:, last] = bh.reshape(n, B)
    return out.reshape(n * cpt, B)


def _scan_row(row: torch.Tensor, af: torch.Tensor, ab: torch.Tensor) -> torch.Tensor:
    """Lateral min-plus closure of row [Cp, B], forward then backward, from
    level 0 of the chain-weight stacks (af/ab [S, Cp]), summed in the same
    order as the kernel's scan, so the two agree bit for bit. Within one
    warp of one column a thread (Cp <= 32) this is the reference's flat
    Hillis-Steele scan over the chain tables (pallas_banded.py:958-966)
    exactly; wider rows associate the sums differently from it. Columns past
    Cp, up to the kernel's threads times pass_cols_per_thread(Cp), hold the
    scan identity."""
    Cp, B = row.shape
    cpt = pass_cols_per_thread(Cp)
    pad = -Cp % (_WARP * cpt)
    b = torch.cat([row, row.new_full((pad, B), INF)])
    a_f = torch.cat([af[0], af.new_zeros(pad)])
    a_b = torch.cat([ab[0], ab.new_zeros(pad)])
    b = _block_scan(b, a_f, True, cpt)
    b = _block_scan(b, a_b, False, cpt)
    return b[:Cp]


def _doubling_scan(row: torch.Tensor, af: torch.Tensor, ab: torch.Tensor) -> torch.Tensor:
    """Partial-depth lateral scan of row [Cp, B] (pallas_banded.py:979-989):
    for each level s of af [S, Cp] in order, row[c] = min(row[c],
    row[c - 2^s] + af[s, c]) on the row as the step before left it, then the
    same backward with ab on the forward-updated row. A chain longer than
    2^S - 1 columns is not closed: the dirty table rescans the row."""
    for s in range(af.shape[0]):
        row = torch.minimum(row, _shift_cols(row, 1 << s) + af[s][:, None])
    for s in range(ab.shape[0]):
        row = torch.minimum(row, _shift_cols(row, -(1 << s)) + ab[s][:, None])
    return row


def pass_scan_depth(n_cols: int, n_scan: int, scan_steps: int = 0) -> int:
    """Doubling steps a direction of the pass's lateral scan: 0 (the exact
    block scan) at full depth, else the plan's n_scan cut to scan_steps
    (pallas_banded.py:1519-1528, :1544)."""
    full = max(1, int(math.ceil(math.log2(max(n_cols, 2)))))
    depth = min(n_scan, scan_steps) if scan_steps > 0 else n_scan
    return 0 if depth >= full else depth


def _require_dirty_for_cut(dirty, warm_cut, skip: bool = True) -> None:
    """The warm cut is the first pass of a warm resolve, which keeps the
    dirty table (pallas_banded.py:1545-1547) unless its rows are not
    skipped (skip_rows=False: every row is walked, no table)."""
    if warm_cut is not None and dirty is None and skip:
        raise ValueError("directional_pass: warm_cut needs the dirty table")


def _check_modes(dirty, skip: bool, defer: bool) -> None:
    """The unskipped pass keeps no dirty table (use_dirty needs skip,
    pallas_banded.py:1545); the deferring pass needs it (:1089)."""
    if not skip and (dirty is not None or defer):
        raise ValueError("directional_pass: skip=False takes no dirty table and no defer")
    if defer and dirty is None:
        raise ValueError("directional_pass: defer needs the dirty table")


def _check_xlanes(xlanes) -> None:
    """Extended lanes: (sel, dc) pairs, sel 0 the row's own loaded values,
    1 the carried row, 2 the second carried row, |dc| <= PASS_MAX_XDC."""
    for sel, dc in xlanes:
        if sel not in (0, 1, 2) or abs(dc) > PASS_MAX_XDC or (sel == 0 and dc == 0):
            raise ValueError(f"directional_pass: bad extended lane {(sel, dc)}")


def pass_needs_two_rows(xlanes) -> bool:
    """A lane two rows away (sel 2) makes the pass carry a second row, and
    makes a dirty-table walk go on for two rows after a needed row."""
    return any(sel == 2 for sel, _ in xlanes)


def pass_max_cols(two_rows: bool, partial: bool) -> int:
    """The widest row the CUDA pass takes: the rows it keeps in shared
    memory are the carried row, a second one with a sel-2 lane, and the
    exchange row of the partial-depth scan."""
    return (PASS_MAX_COLS, PASS_MAX_COLS_X2, PASS_MAX_COLS_X3)[int(two_rows) + int(partial)]


def directional_pass_plain(
    d: torch.Tensor, cross: torch.Tensor, a_fwd: torch.Tensor, a_bwd: torch.Tensor,
    *, reverse: bool, bb: int, atol: float, rtol: float, force: bool = False,
    dirty: torch.Tensor | None = None, warm_cut: tuple | None = None,
    rows_walked: torch.Tensor | None = None, xcross: torch.Tensor | None = None,
    xlanes: tuple = (), skip: bool = True, scan_steps: int = 0, defer: bool = False,
    xlist: XLaneList | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of the pass, in place on d [Rp, Cp, Bp] (f32
    or bfloat16 storage): the configurations of _pass_kernel.
    Rows run in order, the carried row is the row as written, `imp` is an
    any over each block of `bb` lanes and writes gate on
    need = imp | (force & any finite).
    With `xlanes` ((sel, dc) pairs) and `xcross` ([Rp, L, Cp]), the
    extended lanes of irregular plans (pallas_banded.py:887-896) add to the
    cross candidate, before row0 and imp: lane i relaxes
    src[c + dc] + xcross[r, i, c] (+inf off the row), src the carried row
    (sel 1), the row before it as written (sel 2) or the row's own values
    as loaded (sel 0). It reads the dense planes: `xlist`, the lists the
    kernel reads in their place, is not read here.
    With `dirty` ([Bp // bb, Rp] int32, updated in place; use_dirty,
    pallas_banded.py:1003-1036) need |= dirty[j, row], a needed row scans
    base = row0 and writes the scan, simp flags a scan that still improved
    by more than the tolerance, and dirty[j, row] = need & simp. The
    reference scans base = imp ? row0 : cur and writes simp ? scan : base,
    dropping the sub-tolerance cross-row gains of rows needed only because
    they are dirty and the sub-tolerance lateral gains of every needed row;
    both compound along the chains a warm resolve re-solves (ROADMAP queue
    C), so the port keeps them. A full-depth scan leaves the row at its
    lateral fixed point, so no row is left off it unflagged.
    `scan_steps` > 0 scans by that many doubling steps a direction on the
    chain-weight levels a_fwd[r, :scan_steps] / a_bwd[r, :scan_steps] in
    the reference's order (_doubling_scan; partial depth, :979-989); 0 is
    the exact block scan from level 0. A partial scan that still improved
    leaves its row dirty, so it is scanned again.
    `defer` (scan_dirs="up", :969-996; needs `dirty`): the cross relaxation
    only, no scan; need = imp | (force & any finite) (the dirty entry is
    not read), the row writes need ? row0 : cur and dirty[j, row] =
    max(dirty[j, row], need).
    skip=False (:1041-1048; no dirty table, no defer): every row is scanned
    from row0 and written, and `changed` flags scanned*(1+rtol)+atol < cur.
    A bfloat16 field is widened to f32 at load, computed in f32 and rounded
    to nearest-even at store; the carry is the row as stored in the skip
    branches (:994, :1040), the unrounded scanned row without skip (:1048).
    With `warm_cut` = (cutlb [Rp, Cp], cutth [Bp], seedrc [2, Bp] int32)
    (:864-878), which needs `dirty` unless skip=False, each row is cut at
    load: labels >= cutlb[row, c] + cutth[lane] become +inf and each lane's
    seed (row, col) becomes 0.
    `rows_walked` (int [1], optional) gains the rows the kernel's blocks
    walk, summed over the blocks: every row without `dirty`; with it the
    rows that are needed or follow a needed row, or one of the two rows
    after it where a lane has sel 2 (the kernel jumps over the others, whose
    need its prescan reads from memory).
    Returns the changed flag (any imp, and with `dirty` any simp), int32 [1]."""
    _require_dirty_for_cut(dirty, warm_cut, skip)
    _check_modes(dirty, skip, defer)
    Rp, Cp, Bp = d.shape
    _check_xlanes(xlanes)
    if xlanes and (xcross is None or tuple(xcross.shape) != (Rp, len(xlanes), Cp)):
        raise ValueError(f"directional_pass: xcross must be [{Rp}, {len(xlanes)}, {Cp}]")
    two = pass_needs_two_rows(xlanes)
    nb = Bp // bb
    k = 1.0 + rtol
    f32 = torch.float32
    prev = prev2 = torch.full((Cp, Bp), INF, dtype=f32, device=d.device)
    changed = torch.zeros((), dtype=torch.bool, device=d.device)
    if scan_steps > 0:
        scan = lambda row, r: _doubling_scan(row, a_fwd[r, :scan_steps], a_bwd[r, :scan_steps])  # noqa: E731
    else:
        scan = lambda row, r: _scan_row(row, a_fwd[r], a_bwd[r])  # noqa: E731

    def block_any(x):      # [Cp, Bp] -> [nb]
        return x.view(Cp, nb, bb).any(dim=2).any(dim=0)

    def lanes(blk):        # [nb] -> [1, Bp]
        return blk.repeat_interleave(bb)[None, :]

    if warm_cut is not None:
        cutlb, cutth, seedrc = warm_cut
        cols = torch.arange(Cp, device=d.device)[:, None]
    walked = torch.zeros((), dtype=torch.int64, device=d.device)
    prev_need = prev2_need = torch.zeros(nb, dtype=torch.bool, device=d.device)
    for r in (range(Rp - 1, -1, -1) if reverse else range(Rp)):
        orig = d[r]
        cur = orig.to(f32)
        if warm_cut is not None:
            cur = torch.where(cur >= cutlb[r][:, None] + cutth[None, :], INF, cur)
            hit = (seedrc[0][None, :] == r) & (seedrc[1][None, :] == cols)
            cur = torch.where(hit, 0.0, cur)
        x = cross[r]
        cand = torch.minimum(
            torch.minimum(
                _shift_cols(prev, 1) + x[0][:, None], prev + x[1][:, None]
            ),
            _shift_cols(prev, -1) + x[2][:, None],
        )
        for li, (sel, dc) in enumerate(xlanes):
            src = prev if sel == 1 else (prev2 if sel == 2 else cur)
            if dc:
                src = _shift_cols(src, -dc)
            cand = torch.minimum(cand, src + xcross[r, li][:, None])
        row0 = torch.minimum(cur, cand)
        imp = block_any(cand * k + atol < cur)
        need = imp
        if not skip:
            scanned = scan(row0, r)
            changed |= (scanned * k + atol < cur).any()
            d[r] = scanned.to(d.dtype)
            prev2, prev = prev, scanned
            walked += int(nb)
            continue
        if dirty is not None and not defer:
            need = need | (dirty[:, r] > 0)
        if force:
            need = need | block_any(row0 < INF)
        changed |= imp.any()
        new = cur
        if defer:
            if bool(need.any()):
                new = torch.where(lanes(need), row0, cur)
            dirty[:, r] = torch.maximum(dirty[:, r], need.to(torch.int32))
        elif dirty is not None:
            simp = torch.zeros_like(need)
            if bool(need.any()):
                scanned = scan(row0, r)
                simp = block_any(scanned * k + atol < row0) & need
                new = torch.where(lanes(need), scanned, cur)
            dirty[:, r] = simp.to(torch.int32)
            changed |= simp.any()
        elif bool(need.any()):
            new = torch.where(lanes(need), scan(row0, r), cur)
        if new is not cur or warm_cut is not None:
            d[r] = new.to(d.dtype)
        stored = d[r].to(f32)
        prev2, prev = prev, stored
        if dirty is None:
            walked += int(nb)
        else:
            walked += (need | prev_need | (prev2_need & two)).sum()
        prev2_need, prev_need = prev_need, need
    if rows_walked is not None:
        rows_walked += walked.to(rows_walked.dtype)
    return changed.to(torch.int32).reshape(1)


def directional_pass(
    d: torch.Tensor, cross: torch.Tensor, a_fwd: torch.Tensor, a_bwd: torch.Tensor,
    *, reverse: bool, bb: int = PASS_LANES, atol: float, rtol: float,
    force: bool = False, dirty: torch.Tensor | None = None,
    warm_cut: tuple | None = None, rows_walked: torch.Tensor | None = None,
    xcross: torch.Tensor | None = None, xlanes: tuple = (), skip: bool = True,
    scan_steps: int = 0, defer: bool = False, xlist: XLaneList | None = None,
) -> torch.Tensor:
    """One directional Gauss-Seidel pass over every row of d, in place, with
    the optional dirty table, warm cut, extended lanes, partial scan depth,
    deferring and unskipped modes of directional_pass_plain. d is f32 or
    bfloat16 (the storage type; every plane stays f32). CPU tensors run
    directional_pass_plain; CUDA tensors launch the csrc/banded_pass.cu
    kernel (8-lane blocks, with the dirty table after its prescan) or
    raise. Rows take at most pass_max_cols(...) columns.
    With extended lanes the kernel reads only `xlist` (XLaneList of Rp
    rows: the plan's, PaddedProblem.xlist_*, or xlane_list_from_dense(
    xcross)); the dense `xcross` is read only by the plain version, and the
    card path neither needs nor checks it.
    `rows_walked` (int32 [1] on d's device, optional) gains the rows the
    kernel's blocks walked. Returns the changed flag as an int32 [1] tensor
    on d's device."""
    xlanes = tuple((int(sel), int(dc)) for sel, dc in xlanes)
    if d.device.type == "cpu":
        return directional_pass_plain(
            d, cross, a_fwd, a_bwd, reverse=reverse, bb=bb, atol=atol,
            rtol=rtol, force=force, dirty=dirty, warm_cut=warm_cut, rows_walked=rows_walked,
            xcross=xcross, xlanes=xlanes, skip=skip, scan_steps=scan_steps, defer=defer,
        )
    if d.device.type != "cuda":
        raise ValueError(f"directional_pass: unsupported device {d.device}")
    _require_dirty_for_cut(dirty, warm_cut, skip)
    _check_modes(dirty, skip, defer)
    Rp, Cp, Bp = d.shape
    _check_xlanes(xlanes)
    if bb != PASS_LANES or Bp % PASS_LANES:
        raise ValueError(f"the CUDA pass runs {PASS_LANES}-lane blocks (bb={bb}, Bp={Bp})")
    if d.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"directional_pass: the field must be f32 or bfloat16, got {d.dtype}")
    if scan_steps < 0 or scan_steps > min(a_fwd.shape[1], a_bwd.shape[1]):
        raise ValueError(f"directional_pass: scan_steps={scan_steps} exceeds the chain weights' "
                         f"{a_fwd.shape[1]} levels")
    max_cols = pass_max_cols(pass_needs_two_rows(xlanes), scan_steps > 0 and not defer)
    if Cp > max_cols or Cp % pass_cols_per_thread(Cp):
        raise ValueError(f"the CUDA pass takes rows of at most {max_cols} columns, a "
                         f"multiple of pass_cols_per_thread past 32; got {Cp}")
    checks = [
        ("d", d, (Rp, Cp, Bp), d.dtype), ("cross", cross, (Rp, 3, Cp), torch.float32),
        ("a_fwd", a_fwd, (Rp, a_fwd.shape[1], Cp), torch.float32),
        ("a_bwd", a_bwd, (Rp, a_bwd.shape[1], Cp), torch.float32),
    ]
    if dirty is not None:
        checks.append(("dirty", dirty, (Bp // PASS_LANES, Rp), torch.int32))
    if warm_cut is not None:
        cutlb, cutth, seedrc = warm_cut
        checks += [("cutlb", cutlb, (Rp, Cp), torch.float32),
                   ("cutth", cutth, (Bp,), torch.float32),
                   ("seedrc", seedrc, (2, Bp), torch.int32)]
    if xlanes:
        if xlist is None:
            raise ValueError("directional_pass: extended lanes on the card need their lists "
                             "(xlist)")
        N = xlist.meta.shape[0]
        checks += [("xlist.goff", xlist.goff, (Rp, xlist_width(Cp)), torch.int32),
                   ("xlist.meta", xlist.meta, (N,), torch.int32),
                   ("xlist.w", xlist.w, (N,), torch.float32)]
    for name, t, shape, dtype in checks:
        if t.device != d.device or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"directional_pass: bad {name} {tuple(t.shape)} {t.dtype} {t.device}")
    if not (all(t.is_contiguous() for name, t, _, _ in checks if name not in ("a_fwd", "a_bwd"))
            and a_fwd.stride(2) == 1 and a_bwd.stride(2) == 1
            and a_fwd.stride(1) == Cp and a_bwd.stride(1) == Cp):
        raise ValueError("directional_pass: d, cross and the mode tables must be contiguous")
    aligned = [d, cross, a_fwd, a_bwd] + ([xlist.goff, xlist.meta, xlist.w] if xlanes else [])
    if any(t.data_ptr() % 16 for t in aligned) or a_fwd.stride(0) % 4 or a_bwd.stride(0) % 4:
        raise ValueError("directional_pass: d, cross, a_fwd, a_bwd and the lists' rows must be "
                         "16-byte aligned")
    if rows_walked is not None and (rows_walked.device != d.device or rows_walked.numel() != 1
                                    or rows_walked.dtype != torch.int32):
        raise ValueError("directional_pass: rows_walked must be one int32 on d's device")
    ptr = lambda t: None if t is None else t.data_ptr()   # noqa: E731
    cutlb, cutth, seedrc = warm_cut if warm_cut is not None else (None, None, None)
    chg = torch.zeros(1, dtype=torch.int32, device=d.device)
    # an unskipped pass with the warm cut runs the prescan for the cut alone,
    # on a scratch table of clean rows
    table = dirty
    if table is None and warm_cut is not None:
        table = torch.zeros((Bp // PASS_LANES, Rp), dtype=torch.int32, device=d.device)
    need_bits = (None if table is None else
                 torch.zeros((Bp // PASS_LANES, -(-Rp // 32)), dtype=torch.int32, device=d.device))
    xl = (ctypes.c_int * max(1, 2 * len(xlanes)))(*(v for lane in xlanes for v in lane))
    mode = PASS_MODE_DEFER if defer else (PASS_MODE_SKIP if skip else PASS_MODE_NOSKIP)
    stream = torch.cuda.current_stream(d.device).cuda_stream
    err = kernels.launcher("banded_pass")(
        d.data_ptr(), int(d.dtype == torch.bfloat16), cross.data_ptr(), a_fwd.data_ptr(),
        a_fwd.stride(0), a_bwd.data_ptr(), a_bwd.stride(0), chg.data_ptr(), ptr(table),
        ptr(need_bits), ptr(rows_walked), ptr(cutlb), ptr(cutth), ptr(seedrc),
        ptr(xlist.goff) if xlanes else None, ptr(xlist.meta) if xlanes else None,
        ptr(xlist.w) if xlanes else None, xlist_width(Cp), xlist.max_row if xlanes else 0,
        len(xlanes), xl, Rp, Cp, Bp,
        int(reverse), int(force), mode, 0 if defer else scan_steps, 1.0 + rtol, atol, stream,
    )
    kernels.check("banded_pass", err)
    kernels.LAUNCHES["banded_pass"] += 1
    for key, on in (("banded_pass_dirty", dirty is not None),
                    ("banded_pass_bf16", d.dtype == torch.bfloat16),
                    ("banded_pass_partial", scan_steps > 0 and not defer),
                    ("banded_pass_defer", defer), ("banded_pass_noskip", not skip)):
        if on:
            kernels.LAUNCHES[key] += 1
    return chg


# --------------------------------------------------------------------------
# kernel 2: class / real-id predecessors + fixed-point certificate
# --------------------------------------------------------------------------

def _w8_planes(plan: BandedKernelPlan, Rp: int) -> torch.Tensor:
    """In-edge weight planes in class order, [Rp, 8, Cp], built once per plan
    and Rp and kept in plan.w8_cache for its later pred, ids and check
    calls."""
    w8 = plan.w8_cache.get(Rp)
    if w8 is None:
        planes = [plan.lat_fwd, plan.lat_bwd] + [plan.down[:, i] for i in range(3)] + [
            plan.up[:, i] for i in range(3)
        ]
        w8 = torch.stack([_pad_rows(p, Rp) for p in planes], dim=1).contiguous()
        plan.w8_cache[Rp] = w8
    return w8


def _class_sources(d: torch.Tensor, r0: int, r1: int):
    """Rows r0..r1-1 of d [Rp, Cp, Bp] and their 8 in-edge sources in class
    order (row above / below clamped at the field's edges, +inf columns
    outside the row): (cur [n, Cp, Bp], (src_0, ..., src_7))."""
    Rp = d.shape[0]
    idx = torch.arange(r0 - 1, r1 + 1, device=d.device).clamp(0, Rp - 1)
    blk = d[idx].to(torch.float32)                     # [n+2, Cp, Bp]
    cur, upr, dnr = blk[1:-1], blk[:-2], blk[2:]
    sh = lambda x, k: _shift_cols(x.transpose(0, 1), k).transpose(0, 1)
    return cur, (sh(cur, 1), sh(cur, -1), sh(upr, 1), upr, sh(upr, -1),
                 sh(dnr, 1), dnr, sh(dnr, -1))


def class_pred_plain(
    d: torch.Tensor, w8: torch.Tensor, *, R: int, C: int, V: int, tol: float,
    check: tuple | None = None, as_class: bool = True, row_chunk: int = 64,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Plain PyTorch version of the class-pred pass over d [Rp, Cp, Bp] (f32,
    or bfloat16 widened to f32): argmin over the 8 classes with strict < in
    class order, halo rows clamped at the field's edges. as_class: the int8 class, 8 = self;
    else the int32 real id r*C + c + off_real[class], r*C + c for self
    (_pred_kernel's two modes). Rows go in chunks so the temporaries stay
    small. Returns (table [V, Bp], violation bool [] with check=(atol,
    rtol), else None)."""
    Rp, Cp, Bp = d.shape
    dev = d.device
    out = torch.empty((R * C, Bp), dtype=torch.int8 if as_class else torch.int32, device=dev)
    viol = None if check is None else torch.zeros((), dtype=torch.bool, device=dev)
    kt = 1.0 + tol
    off = torch.tensor(_class_offsets(C), dtype=torch.int32, device=dev)
    cols = torch.arange(Cp, dtype=torch.int64, device=dev)
    for r0 in range(0, Rp, row_chunk):
        r1 = min(r0 + row_chunk, Rp)
        cur, srcs = _class_sources(d, r0, r1)
        w = w8[r0:r1]                                  # [n, 8, Cp]
        best = torch.full_like(cur, INF)
        rel = torch.zeros(cur.shape, dtype=torch.int8, device=dev)
        for k in range(8):
            cand = srcs[k] + w[:, k, :, None]
            take = cand < best
            best = torch.where(take, cand, best)
            rel = torch.where(take, torch.tensor(k, dtype=torch.int8, device=dev), rel)
        has = (best <= cur * kt + tol) & (cur > 0) & torch.isfinite(cur)
        if check is not None:
            atol, rtol = check
            viol |= (best * (1.0 + rtol) + atol < cur).any()
        if as_class:
            res = torch.where(has, rel, torch.tensor(8, dtype=torch.int8, device=dev))
        else:
            rows = torch.arange(r0, r1, dtype=torch.int64, device=dev)
            self_id = (rows[:, None] * C + cols[None, :]).to(torch.int32)[:, :, None]
            res = self_id + torch.where(has, off[rel.long()], 0)
        rr = min(r1, R) - r0
        if rr > 0:
            out[r0 * C:(r0 + rr) * C] = res[:rr, :C].reshape(rr * C, Bp)
    return out[:V], viol


def class_pred(
    d: torch.Tensor, w8: torch.Tensor, *, R: int, C: int, V: int, tol: float,
    check: tuple | None = None, as_class: bool = True,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Predecessor table [V, Bp] of a padded field (f32 or bfloat16, computed
    in f32; int8 classes, or int32 real ids with as_class=False) and, with
    check=(atol, rtol), the fixed-point violation flag. CPU tensors run
    class_pred_plain; CUDA tensors launch csrc/class_pred.cu or raise. The
    flag is a [1] int32 (CUDA) or [] bool (CPU) tensor; test it with
    bool()."""
    if d.device.type == "cpu":
        return class_pred_plain(d, w8, R=R, C=C, V=V, tol=tol, check=check, as_class=as_class)
    if d.device.type != "cuda":
        raise ValueError(f"class_pred: unsupported device {d.device}")
    Rp, Cp, Bp = d.shape
    if Bp % 4:
        raise ValueError(f"class_pred: lanes must be a multiple of 4, got {Bp}")
    if (not d.is_contiguous() or d.dtype not in (torch.float32, torch.bfloat16)
            or d.data_ptr() % 16):
        raise ValueError("class_pred: d must be contiguous 16-byte aligned f32 or bfloat16")
    if (tuple(w8.shape) != (Rp, 8, Cp) or w8.dtype != torch.float32
            or not w8.is_contiguous() or w8.device != d.device):
        raise ValueError(f"class_pred: bad w8 {tuple(w8.shape)}")
    if R > Rp or C > Cp or V > R * C:
        raise ValueError("class_pred: R, C, V exceed the padded field")
    out = torch.empty((V, Bp), dtype=torch.int8 if as_class else torch.int32, device=d.device)
    viol = None if check is None else torch.zeros(1, dtype=torch.int32, device=d.device)
    atol, rtol = check if check is not None else (0.0, 0.0)
    stream = torch.cuda.current_stream(d.device).cuda_stream
    bf16 = d.dtype == torch.bfloat16
    err = kernels.launcher("class_pred")(
        d.data_ptr(), int(bf16), w8.data_ptr(), out.data_ptr(),
        None if viol is None else viol.data_ptr(),
        R, C, Rp, Cp, Bp, V, int(as_class), 1.0 + tol, tol, 1.0 + rtol, atol, stream,
    )
    kernels.check("class_pred", err)
    kernels.LAUNCHES["class_pred" if as_class else "class_pred_ids"] += 1
    if bf16:
        kernels.LAUNCHES["class_pred_bf16"] += 1
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
    cls, viol = class_pred(
        d_pad, _w8_planes(plan, d_pad.shape[0]), R=plan.n_rows, C=plan.n_cols,
        V=plan.num_vertices, tol=tol, check=check,
    )
    if check is None:
        return cls
    return cls, not bool(viol.any())


def _residual_edges(plan: BandedKernelPlan):
    """The real residual edges (the padding dropped): (dst, src) padded-flat
    ids as int64, and their weights."""
    n = plan.n_residual
    return plan.res_dst[:n].long(), plan.res_src[:n].long(), plan.res_w[:n]


def _residual_explains(plan: BandedKernelPlan, d_pad: torch.Tensor, tol: float):
    """[n_residual, Bp] bool: the residual in-edge explains its destination's
    label within tol (pallas_banded.py:2509-2514), and its candidate."""
    Rp, Cp, Bp = d_pad.shape
    dst, src, w = _residual_edges(plan)
    flat = d_pad.view(Rp * Cp, Bp)
    cand = flat.index_select(0, src) + w[:, None]
    dv = flat.index_select(0, dst)
    return (cand <= dv * (1.0 + tol) + tol) & (dv > 0) & torch.isfinite(cand)


def _residual_dst_vertices(plan: BandedKernelPlan) -> torch.Tensor:
    """Real ids of the residual destinations in res_row_map's row order."""
    return torch.nonzero(plan.res_row_map >= 0).flatten()


def predecessors_banded_classes_residual(
    plan: BandedKernelPlan, d_pad: torch.Tensor, *, tol: float = 1e-5,
) -> tuple[torch.Tensor, torch.Tensor]:
    """int8 class table of an irregular (residual) plan
    (pallas_banded.py:2588-2641): one launch of the class-pred kernel in its
    int8 mode with no certificate, then the residual reconcile. Each
    explaining residual in-edge scatter-maxes its slot in its destination's
    row of the jump table into res_choice ([NDp, Bp] int8, -1 none: the
    highest slot wins), and class 9 replaces 8 (self) where a residual edge
    explains the label. extract_paths_cls decodes 9 through plan.res_jump.
    Returns (cls [V, Bp] int8, res_choice [NDp, Bp] int8)."""
    cls, _ = class_pred(
        d_pad, _w8_planes(plan, d_pad.shape[0]), R=plan.n_rows, C=plan.n_cols,
        V=plan.num_vertices, tol=tol,
    )
    Bp = d_pad.shape[2]
    n = plan.n_residual
    choice = torch.full((plan.res_jump.shape[0], Bp), -1, dtype=torch.int8, device=d_pad.device)
    if not n:
        return cls, choice
    entry = plan.res_entry_row[:n]
    explains = _residual_explains(plan, d_pad, tol) & (entry >= 0)[:, None]
    slot = plan.res_entry_slot[:n].to(torch.int8)[:, None]
    choice.index_reduce_(0, entry.clamp(min=0).long(),
                         torch.where(explains, slot, torch.tensor(-1, dtype=torch.int8,
                                                                  device=d_pad.device)), "amax")
    dst_v = _residual_dst_vertices(plan)
    sub = cls.index_select(0, dst_v)
    rows = plan.res_row_map.index_select(0, dst_v).long()
    cls[dst_v] = torch.where((sub == 8) & (choice.index_select(0, rows) >= 0),
                             torch.tensor(9, dtype=torch.int8, device=d_pad.device), sub)
    return cls, choice


def predecessors_banded_ids(
    plan: BandedKernelPlan, d_pad: torch.Tensor, *, tol: float = 1e-5,
) -> torch.Tensor:
    """[V, Bp] int32 real-id predecessor table of a padded field, self where
    no in-edge explains the label: the counterpart of
    predecessors_banded_pallas (pallas_banded.py:2463), one launch of the
    class-pred kernel in its id mode. On an irregular plan the residual
    post-pass (:2508-2527) follows: where the kernel left self and a
    residual in-edge explains the label, its source wins (the highest real
    id of those that explain it). Lanes stay padded; callers slice [:, :B]."""
    ids, _ = class_pred(
        d_pad, _w8_planes(plan, d_pad.shape[0]), R=plan.n_rows, C=plan.n_cols,
        V=plan.num_vertices, tol=tol, as_class=False,
    )
    n = plan.n_residual
    if not n:
        return ids
    C, Cp = plan.n_cols, plan.n_cols_pad
    dst, src, _ = _residual_edges(plan)
    explains = _residual_explains(plan, d_pad, tol)
    src_real = ((src // Cp) * C + src % Cp).to(torch.int32)
    dst_row = plan.res_row_map.index_select(0, (dst // Cp) * C + dst % Cp).long()
    res_pred = torch.full((plan.res_jump.shape[0], ids.shape[1]), -1, dtype=torch.int32,
                          device=ids.device)
    res_pred.index_reduce_(0, dst_row, torch.where(explains, src_real[:, None], -1), "amax")
    dst_v = _residual_dst_vertices(plan)
    sub = ids.index_select(0, dst_v)
    rp = res_pred.index_select(0, plan.res_row_map.index_select(0, dst_v).long())
    ids[dst_v] = torch.where((sub == dst_v.to(torch.int32)[:, None]) & (rp >= 0), rp, sub)
    return ids


def predecessors_banded(
    plan: BandedKernelPlan, dist_vb: torch.Tensor, *, tol: float = 1e-5, max_lanes: int = 0,
) -> torch.Tensor:
    """[V, B] int32 real-id predecessors of a [V, B] f32 field by dense rolls
    (pallas_banded.py:1235-1312), plain torch on the field's device, as the
    reference's is XLA code: per class, in the reference's order (lat -1,
    lat +1, then for s = -1, 0, +1 down before up), the field rolled by the
    class offset plus its weight plane, kept under a strict <; wrapped reads
    meet +inf planes. On a grid plan this is the reference's f32 arithmetic
    in its order, so the table is its table, ties included.

    The residual step (:1292-1304) scatter-mins each residual candidate
    d[src] + w into the best cost; an entry takes where its candidate is
    finite and at most that best. Unlike the reference, which scatter-sets
    every entry (one that does not take writes the class pick back, so it
    can overwrite one that did), only taking entries are written: where
    several take for one vertex, the highest real source id wins, and a
    taking entry wins over a class pick of equal cost, as the reference's
    does. A vertex whose best cost does not explain its label within tol
    (best <= d (1 + tol) + tol), or whose label is 0 or +inf, is its own
    predecessor. The extended lanes' edges are on the residual list, so
    irregular plans need no lane planes here.

    Lanes go in chunks of `max_lanes` (default: the reference's, a live set
    of about 2 GB); the table does not depend on it."""
    V, B = dist_vb.shape
    if max_lanes <= 0:
        max_lanes = max(32, min(B, (2 << 30) // max(24 * V, 1) // 32 * 32))
    if B > max_lanes:
        return torch.cat([predecessors_banded(plan, dist_vb[:, i:i + max_lanes], tol=tol,
                                              max_lanes=max_lanes)
                          for i in range(0, B, max_lanes)], dim=1)
    R, C, Cp = plan.n_rows, plan.n_cols, plan.n_cols_pad
    dev = dist_vb.device
    d3 = torch.full((R, Cp, B), INF, dtype=torch.float32, device=dev)
    d3[:, :C] = torch.nn.functional.pad(dist_vb.to(torch.float32), (0, 0, 0, R * C - V),
                                        value=INF).view(R, C, B)
    r_idx = torch.arange(R, dtype=torch.int32, device=dev)[:, None]
    c_idx = torch.arange(Cp, dtype=torch.int32, device=dev)[None, :]
    classes = [(0, -1, plan.lat_fwd), (0, 1, plan.lat_bwd)]
    for i in range(3):
        classes += [(-1, i - 1, plan.down[:, i]), (1, i - 1, plan.up[:, i])]
    best = torch.full_like(d3, INF)
    pred = torch.zeros((R, Cp, B), dtype=torch.int32, device=dev)
    for dr, dc, plane in classes:
        cand = torch.roll(d3, (-dr, -dc), dims=(0, 1)).add_(plane[:, :, None])
        better = cand < best
        best = torch.where(better, cand, best)
        pred = torch.where(better, ((r_idx + dr) * C + (c_idx + dc))[:, :, None], pred)
        del cand, better
    if plan.n_residual:
        dst, src, w = _residual_edges(plan)
        src_real = ((src // Cp) * C + src % Cp).to(torch.int32)
        cand = d3.view(R * Cp, B).index_select(0, src) + w[:, None]
        bflat = best.view(R * Cp, B)
        bflat.index_reduce_(0, dst, cand, "amin")
        take = (cand <= bflat.index_select(0, dst)) & torch.isfinite(cand)
        pick = torch.full((R * Cp, B), -1, dtype=torch.int32, device=dev)
        pick.index_reduce_(0, dst, torch.where(take, src_real[:, None], -1), "amax")
        pred = torch.where(pick.view(R, Cp, B) >= 0, pick.view(R, Cp, B), pred)
        del cand, take, pick
    has = (best <= d3 * (1.0 + tol) + tol) & (d3 > 0) & torch.isfinite(d3)
    pred = torch.where(has, pred, (r_idx * C + c_idx)[:, :, None])
    return pred[:, :C].reshape(R * C, B)[:V]


# --------------------------------------------------------------------------
# kernel 3: the read-only fixed-point certificate
# --------------------------------------------------------------------------

def check_plain(
    d: torch.Tensor, w8: torch.Tensor, *, atol: float, rtol: float, row_chunk: int = 64,
) -> torch.Tensor:
    """Plain PyTorch version of the certificate over d [Rp, Cp, Bp] (f32, or
    bfloat16 widened to f32): True
    (bool []) when some element has best*(1+rtol)+atol < cur, best the min
    over the 8 class in-edges (halo rows clamped, as in class_pred_plain).
    Rows go in chunks so the temporaries stay small."""
    Rp = d.shape[0]
    viol = torch.zeros((), dtype=torch.bool, device=d.device)
    kr = 1.0 + rtol
    for r0 in range(0, Rp, row_chunk):
        r1 = min(r0 + row_chunk, Rp)
        cur, srcs = _class_sources(d, r0, r1)
        w = w8[r0:r1]
        best = torch.full_like(cur, INF)
        for k in range(8):
            best = torch.minimum(best, srcs[k] + w[:, k, :, None])
        viol |= (best * kr + atol < cur).any()
    return viol


def check(d: torch.Tensor, w8: torch.Tensor, *, atol: float, rtol: float) -> torch.Tensor:
    """Fixed-point violation flag of a padded field (f32 or bfloat16,
    computed in f32): CPU tensors run check_plain; CUDA tensors launch
    csrc/check.cu or raise. The flag is a [1] int32 (CUDA) or [] bool (CPU)
    tensor; test it with bool()."""
    if d.device.type == "cpu":
        return check_plain(d, w8, atol=atol, rtol=rtol)
    if d.device.type != "cuda":
        raise ValueError(f"check: unsupported device {d.device}")
    Rp, Cp, Bp = d.shape
    if Bp % 4:
        raise ValueError(f"check: lanes must be a multiple of 4, got {Bp}")
    if (not d.is_contiguous() or d.dtype not in (torch.float32, torch.bfloat16)
            or d.data_ptr() % 16):
        raise ValueError("check: d must be contiguous 16-byte aligned f32 or bfloat16")
    if (tuple(w8.shape) != (Rp, 8, Cp) or w8.dtype != torch.float32
            or not w8.is_contiguous() or w8.device != d.device):
        raise ValueError(f"check: bad w8 {tuple(w8.shape)}")
    viol = torch.zeros(1, dtype=torch.int32, device=d.device)
    stream = torch.cuda.current_stream(d.device).cuda_stream
    bf16 = d.dtype == torch.bfloat16
    err = kernels.launcher("check")(
        d.data_ptr(), int(bf16), w8.data_ptr(), viol.data_ptr(), Rp, Cp, Bp, 1.0 + rtol, atol,
        stream,
    )
    kernels.check("check", err)
    kernels.LAUNCHES["check"] += 1
    if bf16:
        kernels.LAUNCHES["check_bf16"] += 1
    return viol


def check_converged_banded(
    plan: BandedKernelPlan, d_pad: torch.Tensor, *, atol: float = 1e-5,
    rtol: float = 1e-5, w8: torch.Tensor | None = None,
) -> bool:
    """READ-ONLY fixed-point certificate (pallas_banded.py:2429): True iff
    every in-edge relaxation is satisfied within tolerance: the eight banded
    classes by the check kernel, the residual edges of an irregular plan
    beside it (:2454-2459). One host read of the flag. `w8` may pass the
    plan's [Rp, 8, Cp] planes in."""
    if w8 is None:
        w8 = _w8_planes(plan, d_pad.shape[0])
    viol = check(d_pad, w8, atol=atol, rtol=rtol).any()
    if plan.n_residual:
        Rp, Cp, Bp = d_pad.shape
        dst, src, w = _residual_edges(plan)
        flat = d_pad.view(Rp * Cp, Bp)
        cand = flat.index_select(0, src) + w[:, None]
        viol = viol | (cand * (1.0 + rtol) + atol < flat.index_select(0, dst)).any()
    return not bool(viol)


# --------------------------------------------------------------------------
# solve loop
# --------------------------------------------------------------------------

WINDOW_GHOST = 8          # ghost rows at each seam of the warm window's slab
WINDOW_MAX_ROUNDS = 16    # slab rounds before the full loop takes over


def check_warm_window(warm_window: int | None) -> None:
    """A warm window is None or a positive multiple of 128 rows (the
    reference's assertion, pallas_banded.py:1829-1831)."""
    if warm_window is not None and (warm_window <= 0 or warm_window % 128):
        raise ValueError(f"warm_window must be a positive multiple of 128, got {warm_window}")


@dataclasses.dataclass(frozen=True)
class WindowRecord:
    """What the windowed warm resolve did: whether the affected rows and
    their ghost rows fit the window, the slab's rounds, whether a ghost row
    changed (the seam aborted), and whether the slab certified the field
    (seam intact and certificate clean), so that no full-field round ran."""
    fit: bool
    slab_rounds: int
    seam_abort: bool
    done: bool


@dataclasses.dataclass(frozen=True)
class BandedPaddedResult:
    """Converged field on the padded [Rp, Cp, Bp] grid; with
    converge="pred" also the int8 class table [V, Bp] of its certificate;
    with `warm_window` the window's record."""
    d_pad: torch.Tensor
    rounds: int
    converged: bool
    cls: torch.Tensor | None = None
    window: WindowRecord | None = None


BF16_ATOL, BF16_RTOL = 1e-3, 4e-3   # the bfloat16 solve's tolerance floors (pallas_banded.py:1484-1486)


def banded_solve_padded(
    plan: BandedKernelPlan,
    seeds: torch.Tensor,
    *,
    max_rounds: int = 256,
    atol: float = 1e-5,
    rtol: float = 1e-5,
    converge: str = "round",
    timer=None,
    dtype=torch.float32,
    skip_rows: bool | None = None,
    scan_steps: int = 0,
    four_dir: bool | None = None,
    plan_t: BandedKernelPlan | None = None,
    scan_dirs: str = "both",
    warm_d: torch.Tensor | None = None,
    warm_changed: torch.Tensor | None = None,
    warm_raised: torch.Tensor | None = None,
    warm_pos: torch.Tensor | None = None,
    warm_window: int | None = None,
    init_pad: torch.Tensor | None = None,
) -> BandedPaddedResult:
    """Banded GS rounds (one pass down, the first forced, one pass up) to
    convergence on the padded field. converge="pred": after every round the
    class-pred pass runs and its violation flag ends the loop, so the last
    certificate's table comes out of the solve. converge="check": the
    read-only certificate (check kernel) ends the loop. converge="round":
    the loop ends on a round with no supra-tolerance improvement. One host
    read of a flag per round.

    The reference's solver options (pallas_banded.py:1413-1545):
    - `dtype` torch.bfloat16 stores the field in bfloat16 (every plane and
      chain weight stays f32; the passes compute in f32 and round to
      nearest-even at store), with atol / rtol raised to at least
      BF16_ATOL / BF16_RTOL. The result's d_pad stays bfloat16.
    - skip_rows=False (None: True) scans and writes every row of every
      pass, with no dirty table.
    - `scan_steps` (0: the plan's depth) cuts the lateral scan to that many
      doubling steps a direction (pass_scan_depth); below full depth the
      passes keep the dirty table, so a row whose scan still improved is
      scanned again.
    - scan_dirs="up" (with skip_rows): the down pass relaxes the cross
      edges only and defers each written row's scan to the up pass of the
      same round through the dirty table.
    - four_dir=True (None: False, :1532-1537) adds the column passes each
      round, on the field transposed under `plan_t` (default:
      transpose_banded_plan(plan)), after the row passes and before the
      residual scatter-min; each orientation's dirty table takes the lines
      the other changed (:1611-1625, :1647-1653). converge="pred" excludes
      it (:1963).
    The passes keep the dirty table (with skip_rows) wherever a scanned row
    can be left off its lateral fixed point: residual edges, partial
    depth, four_dir, the deferring pass, a warm resolve (:1545-1547).

    `warm_d` ([Rp, Cp, Bp], the previous solve's field for the same seeds)
    with `warm_changed` / `warm_raised` ([R, Cp] bool planes of changed /
    raised costs) and `warm_pos` (position_planes) is the incremental warm
    resolve (pallas_banded.py:1686-1789, :1946-1949): the passes keep a dirty
    table, and the first down pass cuts every label that may have routed
    through a raised edge and re-inserts the seeds (see _warm_start). Unlike
    the reference's, its first full round is forced in both passes. It
    needs converge="check". The solve works on a copy: warm_d is unchanged.

    `warm_window` (rows, a positive multiple of 128) runs the warm resolve's
    rounds on a slab of that many rows around the rows it affects
    (pallas_banded.py:1790-1944, with two faults of the reference repaired;
    see _warm_window), where the plan has no residual edges, neither
    four_dir nor the deferring pass runs, and the window is shorter than
    the field (:1804-1808). The result's `window` records what it did.

    `init_pad` ([R', Cp, B'] padded field) is the propagation mode
    (pallas_banded.py:1437-1448, :1499-1517): the field starts from a copy
    of init_pad conformed to this solve's rows and lanes (+inf where it
    lacks any, cut where it has more), no seed is injected (only
    len(seeds) matters), and the rounds, the first forced, run to the fixed
    point of the graph constraints from there. init_pad is unchanged.

    On an irregular plan (residual edges; pallas_banded.py:1530-1678) the
    passes relax the plan's extended lanes, and each round ends with the
    residual scatter-min (_residual_round): converge="round" and "check"
    work there, "pred" does not (class tables cannot hold residual
    predecessors).

    `timer` (utils.timing.StageTimer) records the solve, pred, check,
    transpose, warm_setup and window stages and the residual scatter-min's
    span "solve/residual". With a timer every pass of the solve adds the
    rows its blocks walk to one int32 counter on the device, read once
    after the loop (whose last flag read has already waited for the card)
    into kernels.LAUNCHES["banded_pass_rows"]; with none, no counter
    exists."""
    if converge not in ("pred", "round", "check"):
        raise NotImplementedError(f"converge={converge!r}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the banded solve stores f32 or bfloat16 fields, not {dtype}")
    if scan_dirs not in ("both", "up"):
        raise ValueError(f"scan_dirs must be 'both' or 'up', got {scan_dirs!r}")
    if dtype == torch.bfloat16:
        atol, rtol = max(atol, BF16_ATOL), max(rtol, BF16_RTOL)
    check_warm_window(warm_window)
    skip = True if skip_rows is None else bool(skip_rows)
    four_dir = bool(four_dir)
    defer = scan_dirs == "up" and skip
    depth = pass_scan_depth(plan.n_cols, plan.n_scan, scan_steps)
    warm = warm_d is not None
    if warm and init_pad is not None:
        raise ValueError("init_pad and warm_d exclude each other")
    use_dirty = skip and (bool(plan.n_residual) or depth > 0 or four_dir or defer or warm)
    prob = prepare_padded(plan, seeds, seeded=not warm and init_pad is None, dtype=dtype)
    Rp = prob.down.shape[0]
    Cp = plan.n_cols_pad
    dirty = cut = None
    if warm:
        assert converge == "check", "warm resolve requires converge='check'"
        with _stage(timer, "warm_setup"):
            d, dirty, cut = _warm_start(
                plan, seeds, warm_d, warm_changed, warm_raised, warm_pos,
                Rp=Rp, bb=prob.bb, atol=atol, rtol=rtol, dtype=dtype,
            )
        if not use_dirty:
            dirty = None
    elif init_pad is not None:
        d = conform_padded(init_pad, Rp, Cp, _round_up(seeds.shape[0], prob.bb), dtype)
    else:
        d = prob.d0
    nb = d.shape[2] // prob.bb
    if use_dirty and dirty is None:
        dirty = torch.zeros((nb, Rp), dtype=torch.int32, device=d.device)
    cols = _columns_problem(plan, plan_t, Rp, nb, use_dirty, scan_steps) if four_dir else None
    if four_dir and converge == "pred":
        raise ValueError("converge='pred' excludes four_dir (pallas_banded.py:1963)")
    rows = None if timer is None else torch.zeros(1, dtype=torch.int32, device=d.device)
    pass_kw = dict(atol=atol, rtol=rtol, skip=skip, rows_walked=rows)

    def finish(res: BandedPaddedResult) -> BandedPaddedResult:
        if rows is not None:
            kernels.LAUNCHES["banded_pass_rows"] += int(rows)
        return res

    def one_round(force: bool = False, cut=None, force_up: bool = False) -> torch.Tensor:
        with _stage(timer, "solve"):
            start = d.clone() if cols is not None and use_dirty and not force else None
            c_dn = directional_pass(
                d, prob.down, prob.a_fwd, prob.a_bwd, reverse=False, force=force, dirty=dirty,
                warm_cut=cut, xcross=prob.xdown, xlanes=plan.xlanes_down,
                xlist=prob.xlist_down, scan_steps=0 if defer else depth, defer=defer, **pass_kw,
            )
            c_up = directional_pass(
                d, prob.up, prob.a_fwd, prob.a_bwd, reverse=True, force=force_up, dirty=dirty,
                xcross=prob.xup, xlanes=plan.xlanes_up, xlist=prob.xlist_up, scan_steps=depth,
                **pass_kw,
            )
            changed = c_dn | c_up
        if cols is not None:
            changed = changed | _column_passes(d, start, dirty, cols, force, timer, **pass_kw)
        if plan.n_residual:
            with _stage(timer, "solve"), _span(timer, "solve/residual"):
                changed = changed | _residual_round(
                    plan, d, dirty, prob.bb, atol, rtol,
                    dirty_t=None if cols is None else cols["dirty"])
        return changed

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
                    tol=pred_tol, check=(atol, rtol),
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
        return finish(BandedPaddedResult(d_pad=d, rounds=rounds, converged=not violated,
                                         cls=cls))

    if converge == "check":
        # same positive-tolerance requirement as "pred" (pallas_banded.py:
        # 2000-2006): the certificate is ulp-strict
        assert atol > 0 or rtol > 0, "converge='check' needs tolerance > 0"
        w8 = _w8_planes(plan, Rp)

        def certified() -> bool:
            with _stage(timer, "check"):
                return check_converged_banded(plan, d, atol=atol, rtol=rtol, w8=w8)

        window = None
        if (warm and warm_window is not None and not plan.n_residual and not four_dir
                and not defer and warm_window < Rp):
            window = _warm_window(plan, prob, d, dirty, cut, warm_changed, seeds, warm_window,
                                  max_rounds=min(WINDOW_MAX_ROUNDS, max_rounds), atol=atol,
                                  rtol=rtol, timer=timer, skip=skip, depth=depth,
                                  rows_walked=rows)
        if window is not None and window.done:
            return finish(BandedPaddedResult(d_pad=d, rounds=window.slab_rounds,
                                             converged=True, window=window))
        # a warm resolve's first full round is forced in both passes: every
        # row holding a label is rescanned, so the sub-tolerance gains that
        # gated rounds drop cannot compound along the chains it re-solves
        # (left unforced, as the reference's, a 128-lane replan chain at 1M
        # drifted past 1% above the exact field; ROADMAP queue C)
        full_force = warm
        if window is not None and window.fit:
            # the slab cut the field and re-inserted the seeds; the full loop
            # finishes from the slab-written field
            rounds, ok = window.slab_rounds, False
        else:
            one_round(force=True, cut=cut, force_up=warm)
            ok = certified()
            rounds, full_force = 1, False
        while not ok and rounds < max_rounds:
            one_round(force=full_force, force_up=full_force)
            ok = certified()
            rounds, full_force = rounds + 1, False
        return finish(BandedPaddedResult(d_pad=d, rounds=rounds, converged=ok, window=window))

    changed = bool(one_round(True).any())
    rounds = 1
    while changed and rounds < max_rounds:
        changed = bool(one_round(False).any())
        rounds += 1
    return finish(BandedPaddedResult(d_pad=d, rounds=rounds, converged=not changed))


def _columns_problem(plan, plan_t, Rp: int, nb: int, use_dirty: bool, scan_steps: int) -> dict:
    """The column passes' planes and dirty table (pallas_banded.py:1552-1582):
    the transposed plan's planes padded to Cp rows (the field's padded
    columns; rows past its n_rows are +inf), the transposed field's width
    its n_cols_pad (the plan's rows rounded up to 8, >= Rp), its own scan
    depth, and a [nb, Cp] dirty table."""
    pt = transpose_banded_plan(plan) if plan_t is None else plan_t
    Cp = plan.n_cols_pad
    if pt.n_rows != plan.n_cols or pt.n_cols != plan.n_rows or pt.n_cols_pad < Rp:
        raise ValueError("plan_t is not this plan's transpose")
    pad = lambda p: _pad_rows(p, Cp).contiguous()   # noqa: E731
    return dict(
        plan=pt, down=pad(pt.down), up=pad(pt.up), a_fwd=pad(pt.a_fwd), a_bwd=pad(pt.a_bwd),
        xdown=pad(pt.xdown) if pt.xlanes_down else None,
        xup=pad(pt.xup) if pt.xlanes_up else None,
        xlist_down=pt.xlist_down.pad_rows(Cp, pt.n_cols_pad) if pt.xlanes_down else None,
        xlist_up=pt.xlist_up.pad_rows(Cp, pt.n_cols_pad) if pt.xlanes_up else None,
        depth=pass_scan_depth(pt.n_cols, pt.n_scan, scan_steps),
        dirty=torch.zeros((nb, Cp), dtype=torch.int32, device=pt.device) if use_dirty else None,
    )


def _column_passes(d, start, dirty, cols: dict, force: bool, timer, **pass_kw) -> torch.Tensor:
    """The column passes of a four_dir round (pallas_banded.py:1607-1656), in
    place on d [Rp, Cp, Bp]: the column dirty table takes every column a
    row pass changed since `start` (every column on a forced round), the
    field is transposed to [Cp, Rt, Bp], passed down (forced on a forced
    round) and up under the transposed plan, the row dirty table takes
    every row a column pass changed, and the field is transposed back.
    Returns the column passes' changed flag."""
    pt, dirty_t = cols["plan"], cols["dirty"]
    Rp, Cp, Bp = d.shape
    nb = Bp // PASS_LANES if dirty_t is None else dirty_t.shape[0]
    with _stage(timer, "transpose"):
        if dirty_t is not None:
            if force:
                dirty_t.fill_(1)
            else:
                colj = (d != start).any(dim=0).view(Cp, nb, -1).any(dim=2)      # [Cp, nb]
                torch.maximum(dirty_t, colj.T.to(torch.int32), out=dirty_t)
        dt = torch.full((Cp, pt.n_cols_pad, Bp), INF, dtype=d.dtype, device=d.device)
        dt[:, :Rp] = d.transpose(0, 1)
        before = dt.clone() if dirty is not None else None
    with _stage(timer, "solve"):
        c_l = directional_pass(dt, cols["down"], cols["a_fwd"], cols["a_bwd"], reverse=False,
                               force=force, dirty=dirty_t, xcross=cols["xdown"],
                               xlanes=pt.xlanes_down, xlist=cols["xlist_down"],
                               scan_steps=cols["depth"], **pass_kw)
        c_r = directional_pass(dt, cols["up"], cols["a_fwd"], cols["a_bwd"], reverse=True,
                               dirty=dirty_t, xcross=cols["xup"], xlanes=pt.xlanes_up,
                               xlist=cols["xlist_up"], scan_steps=cols["depth"], **pass_kw)
    with _stage(timer, "transpose"):
        if dirty is not None:
            rowj = (dt[:, :Rp] != before[:, :Rp]).any(dim=0).view(Rp, nb, -1).any(dim=2)
            torch.maximum(dirty, rowj.T.to(torch.int32), out=dirty)
            del before
        d.copy_(dt[:, :Rp].transpose(0, 1))
    return c_l | c_r


def _residual_round(plan, d, dirty, bb: int, atol: float, rtol: float,
                    dirty_t: torch.Tensor | None = None) -> torch.Tensor:
    """The residual scatter-min that ends a round on an irregular plan
    (pallas_banded.py:1655-1676), in place on d: cand = d[src] + w, the
    ungated write d[dst] = min(d[dst], cand) (sub-tolerance gains are kept,
    unlike the passes), and where a candidate improved by more than the
    tolerance, its destination row is marked dirty for its 8-lane block
    (and, with the column passes' table `dirty_t`, its column). A bfloat16
    field adds in bfloat16 (the weights rounded to it first) and compares
    the improvement in f32. Plain torch, as the reference's is XLA code
    outside any Pallas kernel. Returns the improved flag (bool [1] tensor)."""
    Rp, Cp, Bp = d.shape
    dst, src, w = _residual_edges(plan)
    flat = d.view(Rp * Cp, Bp)
    cand = flat.index_select(0, src) + w.to(d.dtype)[:, None]
    imp = cand.float() * (1.0 + rtol) + atol < flat.index_select(0, dst).float()
    flat.index_reduce_(0, dst, cand, "amin")
    if dirty is not None:
        impj = imp.view(-1, Bp // bb, bb).any(dim=2).T.to(torch.int32)     # [nb, n]
        dirty.index_reduce_(1, dst // Cp, impj, "amax")
        if dirty_t is not None:
            dirty_t.index_reduce_(1, dst % Cp, impj, "amax")
    return imp.any().reshape(1)


def _warm_start(plan, seeds, warm_d, warm_changed, warm_raised, warm_pos, *,
                Rp: int, bb: int, atol: float, rtol: float, dtype=torch.float32):
    """Start of the incremental warm resolve (pallas_banded.py:1686-1789):
    (field copy, dirty table [Bp // bb, Rp] int32, warm cut args).

    A label that may have routed through a raised edge is >= the per-lane
    min of warm_d over the dilated raised set (the threshold, shaved by the
    tolerance envelope) plus the geodesic-shadow bound of its distance to
    that set (lb_plane, from the set's bounding sphere in warm_pos); the
    first down pass cuts such labels to +inf at load and re-inserts the
    seeds at 0. Rows of the dilated changed set and the seed rows start
    dirty in every block. The threshold's min is taken over the rows that
    hold the raised set only (the same value as the reference's full or
    32-row windowed min); finding them is one host read. An empty raised
    set (a pure clear) gives a +inf threshold, which cuts nothing. Unlike
    the reference, the sphere leaves out the padding cells that the
    dilation reaches next to the plan's last columns or rows."""
    if tuple(warm_d.shape[:2]) != (Rp, plan.n_cols_pad):
        raise ValueError(f"warm_d {tuple(warm_d.shape)} is not this plan's padded field")
    Bp = warm_d.shape[2]
    dev = warm_d.device
    C = plan.n_cols
    mask_p = _pad_rows(_dilate_changed(plan, warm_changed), Rp, False)
    raise_p = (mask_p if warm_raised is None
               else _pad_rows(_dilate_changed(plan, warm_raised), Rp, False))
    d = warm_d.to(dtype, copy=True)
    rows = torch.nonzero(raise_p.any(dim=1)).flatten().tolist()
    if rows:
        a, b = rows[0], rows[-1] + 1
        thresh = torch.where(raise_p[a:b, :, None], warm_d[a:b].float(), INF).amin(dim=(0, 1))
    else:
        thresh = torch.full((Bp,), INF, dtype=torch.float32, device=dev)
    thresh = thresh * (1.0 - 2.0 * rtol) - 2.0 * atol
    lb = torch.zeros((Rp, plan.n_cols_pad), dtype=torch.float32, device=dev)
    if warm_pos is not None:
        pos = _pad_rows(warm_pos.transpose(0, 1), Rp).transpose(0, 1)   # [3, Rp, Cp]
        # the sphere encloses the raised vertices only: the dilation can
        # reach padding cells, whose +inf positions would turn the centre
        # and every bound into NaN and so cut nothing (the reference's
        # fault, pallas_banded.py:1760-1774)
        chm = raise_p & torch.isfinite(pos).all(dim=0)
        n_ch = torch.clamp(chm.sum(), min=1)
        ctr = torch.where(chm[None], pos, 0.0).sum(dim=(1, 2)) / n_ch
        dc = torch.sqrt(((pos - ctr[:, None, None]) ** 2).sum(dim=0))
        r_enc = torch.where(chm, dc, 0.0).max()
        lb = torch.clamp(dc - r_enc, min=0.0).contiguous()
    seeds = seeds.long()
    B = seeds.shape[0]
    seedrc = torch.full((2, Bp), -1, dtype=torch.int32, device=dev)
    seedrc[0, :B] = (seeds // C).to(torch.int32)
    seedrc[1, :B] = (seeds % C).to(torch.int32)
    row_dirty = mask_p.any(dim=1)
    row_dirty[seeds // C] = True
    dirty = row_dirty[None, :].expand(Bp // bb, Rp).to(torch.int32).contiguous()
    return d, dirty, (lb, thresh.contiguous(), seedrc)


_WINDOW_SCAN_ROWS = 128   # rows a step of the window's footprint scan reads


def _warm_window(plan, prob, d, dirty, cut, warm_changed, seeds, W: int, *,
                 max_rounds: int, atol: float, rtol: float, timer=None, skip: bool = True,
                 depth: int = 0, rows_walked: torch.Tensor | None = None) -> WindowRecord:
    """The windowed warm resolve (pallas_banded.py:1790-1944), in place on
    the warm copy d and its dirty table, after _warm_start.

    The affected rows are those holding a finite label that the cut
    changes, the rows of the dilated changed set, and the row of every
    seed whose label in d is not 0 (one host read finds their span). Where
    they and WINDOW_GHOST ghost rows on each side fit W rows, the rounds
    run on the slab of W rows from lo = r_lo - WINDOW_GHOST (clamped into
    the field), a view of d that the kernels take in place: the first
    round cuts with the slab's rows of the cut and the seeds shifted into
    it. After each round the check kernel certifies the slab and its ghost
    rows are compared with the incoming field bit for bit; the loop goes on
    while the slab violates the certificate and the seam is intact, up to
    max_rounds. `done` (seam intact, certificate clean) certifies the
    field: nothing outside the slab was cut, no weight outside its interior
    changed, and every row outside is as the previous solve left it. Else
    the slab rows join the dirty table and the caller's full loop finishes
    from the slab-written field (every slab write relaxes valid upper
    bounds).

    Two faults of the reference are repaired. Its loop stores the negation
    of the violation flag in its violation slot (:1904, :1913), so it leaves
    on the first round that still violates and certifies that slab. And it
    drops the seeds outside the slab (:1849-1853); here such a seed, unless
    its label is already 0 (then it is at its fixed point: a cut that
    reaches it makes its row a cut row), widens the affected span, so the
    window misses and the full path re-inserts it. Two choices differ from
    the reference's without changing a certified result: the certificate
    leaves out the slab's edge rows' in-edges from beyond the slab (the
    check's clamped halo would relax an edge row from itself through them,
    a false violation), and a seam on the field's first or last row is not
    compared (nothing lies beyond it). As a full warm resolve's first round
    is forced, the slab's first round rescans every interior row in both
    passes, through the dirty table: the force flag would rescan the ghost
    rows too and rewrite them by sub-tolerance gains, which the seam test
    reads as a crossing. With skip=False (no dirty table) every slab pass
    scans every slab row; `depth` is the passes' partial scan depth;
    `rows_walked` (optional) gains the rows the slab passes walk."""
    Rp, Cp, Bp = d.shape
    GH = WINDOW_GHOST
    lb, thresh, seedrc = cut
    dev = d.device
    with _stage(timer, "window"):
        cut_rows = torch.zeros(Rp, dtype=torch.bool, device=dev)
        for r0 in range(0, Rp, _WINDOW_SCAN_ROWS):
            blk = d[r0:r0 + _WINDOW_SCAN_ROWS]
            hit = (blk >= lb[r0:r0 + _WINDOW_SCAN_ROWS, :, None] + thresh) & (blk < INF)
            cut_rows[r0:r0 + blk.shape[0]] = hit.flatten(1).any(dim=1)
        changed_rows = _pad_rows(_dilate_changed(plan, warm_changed), Rp, False).any(dim=1)
        seeds = seeds.long()
        sr = seeds // plan.n_cols
        off_zero = d[sr, seeds % plan.n_cols, torch.arange(seeds.shape[0], device=dev)] != 0
        seed_rows = torch.zeros(Rp, dtype=torch.int32, device=dev).index_add_(
            0, sr, off_zero.to(torch.int32)) > 0
        aff = cut_rows | changed_rows | seed_rows
        idx = torch.arange(Rp, device=dev)
        r_lo, r_hi = torch.stack([torch.where(aff, idx, Rp).min(),
                                  torch.where(aff, idx, -1).max()]).tolist()
    if not (r_hi >= r_lo and r_hi - r_lo + 1 + 2 * GH <= W):
        return WindowRecord(fit=False, slab_rounds=0, seam_abort=False, done=False)
    lo = min(max(r_lo - GH, 0), Rp - W)
    sl = slice(lo, lo + W)
    d_s = d[sl]
    top = d[lo:lo + GH].clone() if lo > 0 else None
    bot = d[lo + W - GH:lo + W].clone() if lo + W < Rp else None
    w8_s = _w8_planes(plan, Rp)[sl].clone()
    w8_s[0, 2:5] = INF       # in-edges from the row above the slab
    w8_s[-1, 5:8] = INF      # from the row below it
    seed_r = seedrc[0] - lo
    inside = (seedrc[0] >= 0) & (seed_r >= 0) & (seed_r < W)
    seedrc_s = torch.stack([torch.where(inside, seed_r, -1), seedrc[1]]).to(torch.int32)
    # the first round marks every interior row before each pass (the
    # affected rows all lie there); a ghost row is walked only where a gain
    # crosses the seam, so a seed at 0 in it is not rescanned
    dirty_s = (None if dirty is None else
               torch.zeros((dirty.shape[0], W), dtype=torch.int32, device=dev))
    planes = [(prob.down[sl], None if prob.xdown is None else prob.xdown[sl], plan.xlanes_down,
               None if prob.xlist_down is None else prob.xlist_down.rows(lo, lo + W), False),
              (prob.up[sl], None if prob.xup is None else prob.xup[sl], plan.xlanes_up,
               None if prob.xlist_up is None else prob.xlist_up.rows(lo, lo + W), True)]
    a_fwd, a_bwd = prob.a_fwd[sl], prob.a_bwd[sl]
    interior = slice(GH if top is not None else 0, W - GH if bot is not None else W)

    def slab_round(warm_cut=None):
        with _stage(timer, "solve"):
            for cross, xcross, xlanes, xlist, reverse in planes:
                if warm_cut is not None and dirty_s is not None:
                    dirty_s[:, interior] = 1
                directional_pass(d_s, cross, a_fwd, a_bwd, reverse=reverse, atol=atol, rtol=rtol,
                                 dirty=dirty_s, warm_cut=None if reverse else warm_cut,
                                 xcross=xcross, xlanes=xlanes, xlist=xlist, skip=skip,
                                 scan_steps=depth, rows_walked=rows_walked)

    def state():
        """(violates, seam broken), one host read."""
        with _stage(timer, "check"):
            flags = [check(d_s, w8_s, atol=atol, rtol=rtol).any()]
            if top is not None:
                flags.append((d_s[:GH] != top).any())
            if bot is not None:
                flags.append((d_s[W - GH:] != bot).any())
            f = torch.stack(flags).tolist()
        return bool(f[0]), any(f[1:])

    slab_round((lb[sl], thresh, seedrc_s))
    rounds = 1
    violates, seam = state()
    while violates and not seam and rounds < max_rounds:
        slab_round()
        rounds += 1
        violates, seam = state()
    done = not violates and not seam
    if not done and dirty is not None:
        dirty[:, sl] = 1
    return WindowRecord(fit=True, slab_rounds=rounds, seam_abort=seam, done=done)


def conform_padded(x: torch.Tensor, rows: int, cols: int, lanes: int,
                   dtype=torch.float32) -> torch.Tensor:
    """A new [rows, cols, lanes] field of `dtype` from a padded field x [R',
    cols, B']: rows and lanes that x lacks are +inf, those it has in excess
    are cut (pallas_banded.py:1499-1517)."""
    if x.dim() != 3 or x.shape[1] != cols:
        raise ValueError(f"padded field {tuple(x.shape)} does not have {cols} padded columns")
    if tuple(x.shape) == (rows, cols, lanes):
        return x.to(dtype, copy=True)
    out = torch.full((rows, cols, lanes), INF, dtype=dtype, device=x.device)
    r, b = min(rows, x.shape[0]), min(lanes, x.shape[2])
    out[:r, :, :b] = x[:r, :, :b]
    return out


# --------------------------------------------------------------------------
# the reference's full result
# --------------------------------------------------------------------------

class BandedPallasResult(NamedTuple):
    """The full-result solve's output (pallas_banded.py:1393)."""
    dist: torch.Tensor    # [B, V] f32
    pred: torch.Tensor    # [B, V] i32
    rounds: int
    converged: bool


def batched_field_banded_pallas(
    mesh: MeshArrays,
    weights_vd: torch.Tensor,
    plan: BandedKernelPlan,
    seeds: torch.Tensor,        # [B]
    *,
    max_rounds: int = 256,
    atol: float = 1e-5,
    rtol: float = 1e-5,
    dtype=torch.float32,
    scan_steps: int = 0,
    timer=None,
) -> BandedPallasResult:
    """Batched SSSP with the full result (pallas_banded.py:2969-3011):
    banded_solve_padded (converge "round", no warm start; on a CUDA plan the
    pass kernel, and on an irregular plan the residual scatter-min), the
    field unpadded to [V, B] f32, then predecessors_banded at tol 1e-2 for a
    bfloat16 solve, else max(atol, 1e-6). Fields come back [B, V]. `mesh`
    and `weights_vd` are unused, as in the reference; the solve runs on the
    plan's device. `timer` times the solve's passes ("solve") and the
    recovery ("unpad", "pred")."""
    V, B = plan.num_vertices, seeds.shape[0]
    R, C = plan.n_rows, plan.n_cols
    res = banded_solve_padded(plan, seeds.to(plan.device), max_rounds=max_rounds, atol=atol,
                              rtol=rtol, dtype=dtype, scan_steps=scan_steps, timer=timer)
    with _stage(timer, "unpad"):
        dist = res.d_pad[:R, :C, :B].reshape(R * C, B)[:V].to(torch.float32)
    pred_tol = 1e-2 if dtype == torch.bfloat16 else max(atol, 1e-6)
    with _stage(timer, "pred"):
        pred = predecessors_banded(plan, dist, tol=pred_tol)
    with _stage(timer, "unpad"):
        dist, pred = dist.T.contiguous(), pred.T.contiguous()
    return BandedPallasResult(dist=dist, pred=pred, rounds=res.rounds, converged=res.converged)


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
    res_row_map: torch.Tensor | None = None,   # [V] int32 (residual decode)
    res_jump: torch.Tensor | None = None,      # [NDp, 8] int32
    res_choice: torch.Tensor | None = None,    # [NDp, >= B] int8
    timer=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Walk each lane's predecessor chain from start to goal, decoding
    next = v + delta[class] (class 8 = self ends the walk). With the
    residual tables (predecessors_banded_classes_residual), class 9 decodes
    through the jump table: next = res_jump[res_row_map[v],
    res_choice[row, lane]] (pallas_banded.py:2674-2698).
    CPU tensors run extract_paths_cls_plain (chunks of `chunk` steps).
    CUDA tensors launch csrc/walk.cu once (one thread a lane walks its whole
    chain; the residual decode is a template flag of the kernel, taken when
    the tables are given) and read nothing back, or raise; its paths equal
    the plain loop's bit for bit. kernels.LAUNCHES["walk"] gains one a
    launch. Given a `timer` (utils.timing.StageTimer), "walk_steps" gains
    the longest lane's walked steps and "walk_lane_steps" the walked steps
    of all lanes, from the kernel's per-lane counts (one reduction and one
    host read); without one the card's walk counts neither.
    Returns (path [B, max_len] i64, valid [B, max_len] bool); dead steps
    repeat the terminal vertex with valid False."""
    decode = dict(res_row_map=res_row_map, res_jump=res_jump, res_choice=res_choice)
    if cls_vb.device.type == "cpu":
        return extract_paths_cls_plain(cls_vb, start_v, goal_v, max_len, C, chunk=chunk,
                                       timer=timer, **decode)
    if cls_vb.device.type != "cuda":
        raise ValueError(f"extract_paths_cls: unsupported device {cls_vb.device}")
    dev = cls_vb.device
    B = start_v.shape[0]
    residual = res_row_map is not None
    if sum(t is not None for t in decode.values()) != 3 * residual:
        raise ValueError("extract_paths_cls: give all three residual tables or none")
    if (cls_vb.dim() != 2 or cls_vb.dtype != torch.int8 or cls_vb.stride(1) != 1
            or cls_vb.shape[1] < B or cls_vb.shape[0] < 1):
        raise ValueError(f"extract_paths_cls: cls_vb must be [V, >= {B}] int8 with unit "
                         f"lane stride, got {tuple(cls_vb.shape)} {cls_vb.dtype} "
                         f"strides {cls_vb.stride()}")
    for name, t in (("start_v", start_v), ("goal_v", goal_v)):
        if t.shape != (B,) or t.dtype.is_floating_point or t.dtype == torch.bool:
            raise ValueError(f"extract_paths_cls: {name} must be [{B}] integer ids")
    tables = [cls_vb, start_v, goal_v]
    n_rows = 0
    if residual:
        V = cls_vb.shape[0]
        if (res_row_map.shape != (V,) or res_row_map.dtype != torch.int32
                or not res_row_map.is_contiguous()):
            raise ValueError(f"extract_paths_cls: res_row_map must be contiguous [{V}] int32")
        if (res_jump.dim() != 2 or res_jump.shape[1] != 8 or res_jump.dtype != torch.int32
                or not res_jump.is_contiguous() or res_jump.shape[0] < 1):
            raise ValueError("extract_paths_cls: res_jump must be contiguous [NDp, 8] int32")
        if (res_choice.dim() != 2 or res_choice.shape[0] != res_jump.shape[0]
                or res_choice.shape[1] < B or res_choice.dtype != torch.int8
                or res_choice.stride(1) != 1):
            raise ValueError("extract_paths_cls: res_choice must be [NDp, >= B] int8 with "
                             "unit lane stride")
        n_rows = res_jump.shape[0] - 1
        tables += [res_row_map, res_jump, res_choice]
    if any(t.device != dev for t in tables):
        raise ValueError("extract_paths_cls: every table must lie on the class table's device")
    path = torch.empty((max_len, B), dtype=torch.int64, device=dev)
    valid = torch.empty((max_len, B), dtype=torch.bool, device=dev)
    if B == 0:
        return path.T, valid.T
    steps = torch.empty(B, dtype=torch.int32, device=dev) if timer is not None else None
    starts = start_v.to(torch.int64).contiguous()
    goals = goal_v.to(torch.int64).contiguous()
    ptr = lambda t: None if t is None else t.data_ptr()   # noqa: E731
    err = kernels.launcher("walk")(
        cls_vb.data_ptr(), cls_vb.stride(0), cls_vb.shape[0], starts.data_ptr(),
        goals.data_ptr(), ptr(res_row_map), ptr(res_jump), ptr(res_choice),
        res_choice.stride(0) if residual else 0, n_rows, path.data_ptr(), valid.data_ptr(),
        ptr(steps), B, max_len, C, torch.cuda.current_stream(dev).cuda_stream,
    )
    kernels.check("walk", err)
    kernels.LAUNCHES["walk"] += 1
    if steps is not None:
        longest, total = torch.stack((steps.max().long(), steps.sum())).tolist()
        kernels.LAUNCHES["walk_steps"] += longest
        kernels.LAUNCHES["walk_lane_steps"] += total
    return path.T, valid.T


def extract_paths_cls_plain(
    cls_vb: torch.Tensor,
    start_v: torch.Tensor,
    goal_v: torch.Tensor,
    max_len: int,
    C: int,
    *,
    chunk: int = 256,
    res_row_map: torch.Tensor | None = None,
    res_jump: torch.Tensor | None = None,
    res_choice: torch.Tensor | None = None,
    timer=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of extract_paths_cls, on any device: chunks of
    `chunk` steps, with one host check of any(alive) before each.
    kernels.LAUNCHES["walk_steps"] gains the steps run (chunks times
    `chunk`); given a `timer`, "walk_lane_steps" gains the steps in which a
    lane still walked, summed over the lanes (one reduction and one host
    read)."""
    dev = start_v.device
    B = start_v.shape[0]
    lane = torch.arange(B, device=dev)
    delta = torch.tensor([-1, 1, -C - 1, -C, -C + 1, C - 1, C, C + 1, 0, 0],
                         dtype=torch.int64, device=dev)
    residual = res_row_map is not None
    if residual:
        n_rows = res_jump.shape[0] - 1
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
        kernels.LAUNCHES["walk_steps"] += chunk
        for i in range(j * chunk, (j + 1) * chunk):
            path[i] = v
            valid[i] = alive
            k = cls_vb[v, lane].long()
            nxt = v + delta[k]
            if residual:
                row = res_row_map[v].long().clamp(0, n_rows)
                slot = res_choice[row, lane].long().clamp(0, 7)
                nxt = torch.where(k == 9, res_jump[row, slot].long(), nxt)
            alive = alive & (v != goal) & (k != 8)
            v = torch.where(alive, nxt, v)
    if timer is not None:
        kernels.LAUNCHES["walk_lane_steps"] += int(valid.sum())
    fill = torch.where(valid, path, v[None, :])
    return fill[:max_len].T, valid[:max_len].T


def extract_paths_vb(
    pred_vb: torch.Tensor,     # [V, >= B] predecessor ids (lane-minor)
    start_v: torch.Tensor,     # [B]
    goal_v: torch.Tensor,      # [B]
    max_len: int,
    *,
    chunk: int = 256,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The predecessor walk over a lane-minor id table, e.g. the [V, Bp]
    table of predecessors_banded_ids (pallas_banded.py:2785): one [B]
    gather a step, no [B, V] transpose. A lane stops after v == goal or
    pred[v] == v. Chunks of `chunk` steps with one host read of any(alive)
    before each. Returns (path [B, max_len] i64, valid [B, max_len] bool);
    dead steps repeat the terminal vertex with valid False."""
    return _sweeps.extract_path(pred_vb.t(), start_v, goal_v, max_len, chunk=chunk)


def descend_paths(
    plan: BandedKernelPlan,
    dist_bv: torch.Tensor,     # [B, V] converged labels
    start_v: torch.Tensor,     # [B] real vertex ids
    goal_v: torch.Tensor,      # [B] real vertex ids (the seeds)
    max_len: int,
    *,
    tol: float = 1e-5,
    chunk: int = 256,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Greedy descent straight from a [B, V] field (pallas_banded.py:2923),
    with no predecessor table: each step moves to the argmin over the eight
    class in-edges of dist[u] + w(u, v) (the first class on ties) while
    best <= dv*(1+tol)+tol, dv > 0 and dv is finite; a lane stops at its
    goal or where no in-edge explains its label. The reference runs all
    max_len steps; here chunks of `chunk` steps with one host read of
    any(alive) before each, and steps after a lane stops repeat its final
    vertex with valid False either way. Returns (path [B, max_len] i64,
    valid [B, max_len] bool)."""
    dev = dist_bv.device
    B, V = start_v.shape[0], plan.num_vertices
    W8, offs = _inbound_tables(plan)
    lane = torch.arange(B, device=dev)
    n_chunks = -(-max_len // chunk)
    v = start_v.long().clone()
    goal = goal_v.long()
    alive = torch.ones(B, dtype=torch.bool, device=dev)
    path = v[None, :].repeat(n_chunks * chunk, 1)
    valid = torch.zeros((n_chunks * chunk, B), dtype=torch.bool, device=dev)
    for j in range(n_chunks):
        if not bool(alive.any()):
            break
        for i in range(j * chunk, (j + 1) * chunk):
            path[i] = v
            valid[i] = alive
            dv = dist_bv[lane, v]
            u = torch.clamp(v[None, :] + offs[:, None], 0, V - 1)          # [8, B]
            best, arg = torch.min(dist_bv[lane[None], u] + W8[:, _to_padded_flat(plan, v)], dim=0)
            descends = (best <= dv * (1.0 + tol) + tol) & (dv > 0) & torch.isfinite(dv)
            alive = alive & (v != goal) & descends
            v = torch.where(alive, torch.gather(u, 0, arg[None])[0], v)
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
    no neighbour explains the label. On an irregular plan up to 8 residual
    in-edges of each vertex are probed too, through a dst-sorted copy of
    the residual list (pallas_banded.py:2884-2917); without them a vertex
    reached only by a residual edge reads pred = self. Returns real vertex
    ids [B, K]."""
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
    if plan.n_residual:
        C, Cp, P = plan.n_cols, plan.n_cols_pad, 8
        order = plan.res_order[:plan.n_residual].long()   # stable sort by dst
        rd = plan.res_dst.index_select(0, order).long()
        rs = plan.res_src.index_select(0, order).long()
        rw = plan.res_w.index_select(0, order)
        vp = _to_padded_flat(plan, vids)                                  # [B, K]
        idx = torch.searchsorted(rd, vp)[..., None] + torch.arange(P, device=vids.device)
        idx_cl = idx.clamp(max=rd.shape[0] - 1)                           # [B, K, P]
        ok = (idx < rd.shape[0]) & (rd[idx_cl] == vp[..., None])
        srcp = rs[idx_cl]
        src_real = ((srcp // Cp) * C + srcp % Cp).clamp(0, V - 1)
        cand_r = torch.where(ok, d_flat[srcp, lane[..., None]] + rw[idx_cl], INF)
        best_r, arg_r = torch.min(cand_r, dim=-1)
        u_r = torch.gather(src_real, -1, arg_r[..., None])[..., 0]
        u_best = torch.where(best_r < best, u_r, u_best)
        best = torch.minimum(best, best_r)
    has = (best <= dv * (1.0 + tol) + tol) & (dv > 0) & torch.isfinite(dv)
    return torch.where(has, u_best, vids)


# --------------------------------------------------------------------------
# live-replan plane refresh and the changed-region planes
# --------------------------------------------------------------------------

_REFRESH_HALO = 3   # costs reach plane rows via the effective laterals
                    # (+-1 row) and extended lanes (|dr| <= 2)
_PLANE_KEYS = (
    "down", "up", "a_fwd", "a_bwd", "xdown", "xup", "lat_fwd", "lat_bwd",
    "l2_fwd", "l2_bwd", "wback_fwd", "wback_bwd",
)


def _grid_plane(plan: BandedKernelPlan, values: torch.Tensor, fill) -> torch.Tensor:
    """[V] per-vertex values -> [R, Cp] plane, `fill` in padding."""
    R, C, Cp, V = plan.n_rows, plan.n_cols, plan.n_cols_pad, plan.num_vertices
    p = torch.full((R * C,), fill, dtype=values.dtype, device=values.device)
    p[:V] = values
    p = p.view(R, C)
    if Cp > C:
        p = torch.cat([p, torch.full((R, Cp - C), fill, dtype=p.dtype, device=p.device)], dim=1)
    return p


def _planes_from_cost_plane(
    plan: BandedKernelPlan, cost_pad: torch.Tensor,
    dist_lat_fwd, dist_lat_bwd, dist_down, dist_up, xdist_down, xdist_up,
    f: float, cost_limit: float,
) -> dict:
    """Every dense weight plane from a cost plane [Rs, Cp] (the full plane
    or a row slab; pallas_banded.py:623-683). w(u -> v) = dist * (1 + f *
    (c_u + c_v) / 2), +inf when either cost is inf, when the source cost
    exceeds cost_limit, or where the edge is absent (baked into the static
    distance planes). Local to +-2 rows, so a slab with 3 halo rows
    reproduces the full result on its interior."""
    S, Cp = plan.n_scan, plan.n_cols_pad

    def weigh(dist_p, dr, dc):
        cu = _shift2(cost_pad, dr, dc)                # source cost
        w = dist_p * (1.0 + f * 0.5 * (cost_pad + cu))
        ok = (torch.isfinite(dist_p) & torch.isfinite(cost_pad)
              & torch.isfinite(cu) & (cu <= cost_limit))
        return torch.where(ok, w, INF).to(torch.float32)

    lat_fwd = weigh(dist_lat_fwd, 0, -1)
    lat_bwd = weigh(dist_lat_bwd, 0, 1)
    down = torch.stack([weigh(dist_down[:, i], -1, i - 1) for i in range(3)], dim=1)
    up = torch.stack([weigh(dist_up[:, i], 1, i - 1) for i in range(3)], dim=1)
    lf_eff, lb_eff = _effective_laterals(lat_fwd, lat_bwd, down, up)
    a_fwd, a_bwd = _chain_weights(lf_eff, lb_eff, S)
    _, l2f, l2b, wbf, wbb = (_two_level_tables(a_fwd, a_bwd, S, Cp) if plan.n_scan2
                             else (0, None, None, None, None))
    xdown, xup = plan.xdown, plan.xup
    if plan.xlanes_down:
        xdown = torch.stack([weigh(xdist_down[:, i], -sel, dc)
                             for i, (sel, dc) in enumerate(plan.xlanes_down)], dim=1)
    if plan.xlanes_up:
        xup = torch.stack([weigh(xdist_up[:, i], sel, dc)
                           for i, (sel, dc) in enumerate(plan.xlanes_up)], dim=1)
    return dict(down=down, up=up, a_fwd=a_fwd, a_bwd=a_bwd, xdown=xdown, xup=xup,
                lat_fwd=lat_fwd, lat_bwd=lat_bwd, l2_fwd=l2f, l2_bwd=l2b,
                wback_fwd=wbf, wback_bwd=wbb)


def refresh_banded_planes(plan: BandedKernelPlan, weights_vd) -> BandedKernelPlan:
    """Every weight plane again from a new [V, D] slot-weight table, on the
    plan's device with no host read (pallas_banded.py:512-577): the
    live-replan refresh where edge weights come from another source than
    the cost field. The static classification is reused (slot_map, the
    residual slots, the lanes' slot maps xslot_*), so a lethal edge comes
    out +inf as in a fresh build; the lanes' lists keep their edges and
    take the new weights."""
    dev = plan.device
    W = torch.as_tensor(weights_vd).to(dev, torch.float32)
    V, C, Cp, S = plan.num_vertices, plan.n_cols, plan.n_cols_pad, plan.n_scan
    vid = torch.arange(V, device=dev)

    def plane(sm):
        sm = sm.long()
        return _grid_plane(plan, torch.where(sm >= 0, W[vid, sm.clamp(min=0)], INF), INF)

    lat_fwd, lat_bwd = plane(plan.slot_map[0]), plane(plan.slot_map[1])
    down = torch.stack([plane(plan.slot_map[2 + i]) for i in range(3)], dim=1)
    up = torch.stack([plane(plan.slot_map[5 + i]) for i in range(3)], dim=1)
    lf_eff, lb_eff = _effective_laterals(lat_fwd, lat_bwd, down, up)
    a_fwd, a_bwd = _chain_weights(lf_eff, lb_eff, S)
    _, l2f, l2b, wbf, wbb = (_two_level_tables(a_fwd, a_bwd, S, Cp) if plan.n_scan2
                             else (0, None, None, None, None))
    res_dst, res_slot = plan.res_dst.long(), plan.res_slot.long()
    res_w = torch.where(res_slot >= 0, W[(res_dst // Cp) * C + res_dst % Cp, res_slot.clamp(min=0)],
                        INF)
    xplanes = {}
    for name in ("down", "up"):
        lanes = getattr(plan, f"xlanes_{name}")
        slots = getattr(plan, f"xslot_{name}")
        xplanes[f"x{name}"] = (torch.stack([plane(slots[k]) for k in range(len(lanes))], dim=1)
                               if lanes else getattr(plan, f"x{name}"))
    return with_planes(
        plan, down=down, up=up, a_fwd=a_fwd.contiguous(), a_bwd=a_bwd.contiguous(),
        res_w=res_w.to(torch.float32), lat_fwd=lat_fwd, lat_bwd=lat_bwd, l2_fwd=l2f,
        l2_bwd=l2b, wback_fwd=wbf, wback_bwd=wbb, **xplanes)


def _residual_weights_from_costs(plan: BandedKernelPlan, cost_pad: torch.Tensor,
                                 f: float, cost_limit: float) -> torch.Tensor:
    """The residual edges' weights from a full cost plane [R, Cp]
    (pallas_banded.py:686-701), by the rule of _planes_from_cost_plane."""
    cflat = cost_pad.reshape(-1)
    c_dst = cflat[plan.res_dst.long()]
    c_src = cflat[plan.res_src.long()]
    w = plan.res_dist * (1.0 + f * 0.5 * (c_dst + c_src))
    ok = (torch.isfinite(plan.res_dist) & torch.isfinite(c_dst) & torch.isfinite(c_src)
          & (c_src <= cost_limit))
    return torch.where(ok, w, INF).to(torch.float32)


def refresh_banded_planes_from_costs(
    plan: BandedKernelPlan, vertex_costs: torch.Tensor, *,
    edge_cost_factor: float = 0.0, cost_limit: float = 1.0,
) -> BandedKernelPlan:
    """Gather-free live-replan refresh (pallas_banded.py:580-620): every
    weight plane straight from the [V] cost field and the plan's static
    distance planes, and the residual edges' weights (a gather of the
    residual list); the lanes' lists take the new weights (a gather)."""
    cost_pad = _grid_plane(plan, vertex_costs.to(torch.float32), INF)
    planes = _planes_from_cost_plane(
        plan, cost_pad, plan.dist_lat_fwd, plan.dist_lat_bwd, plan.dist_down,
        plan.dist_up, plan.xdist_down, plan.xdist_up, edge_cost_factor, cost_limit,
    )
    res_w = _residual_weights_from_costs(plan, cost_pad, edge_cost_factor, cost_limit)
    return with_planes(plan, res_w=res_w, **planes)


def _row_slab(x: torch.Tensor, start: int, size: int, fill=INF) -> torch.Tensor:
    """Rows [start, start + size) of x, `fill` rows outside [0, R)."""
    R = x.shape[0]
    lo, hi = max(start, 0), min(start + size, R)
    parts = [x[lo:hi]]
    if lo > start:
        parts.insert(0, torch.full((lo - start,) + tuple(x.shape[1:]), fill,
                                   dtype=x.dtype, device=x.device))
    if start + size > hi:
        parts.append(torch.full((start + size - hi,) + tuple(x.shape[1:]), fill,
                                dtype=x.dtype, device=x.device))
    return torch.cat(parts) if len(parts) > 1 else parts[0]


def refresh_banded_planes_rows(
    base_plan: BandedKernelPlan, base_costs: torch.Tensor, vertex_costs: torch.Tensor,
    *, edge_cost_factor: float = 0.0, cost_limit: float = 1.0, row_window: int = 64,
) -> BandedKernelPlan:
    """Incremental plane refresh (pallas_banded.py:704-807): rewrite only the
    plane rows whose costs changed against `base_costs`, the costs
    `base_plan`'s planes were refreshed at. The changed rows plus a 3-row
    halo are recomputed on a `row_window`-row slab and written over copies
    of the base planes; when they do not fit the slab, all planes are
    recomputed. Exact either way. The branch is chosen by one host read.
    The residual weights are refreshed from the whole cost plane, the
    lanes' lists' weights gathered from the refreshed planes."""
    R = base_plan.n_rows
    PR, H = row_window, _REFRESH_HALO
    if R < PR + 2 * H:
        return refresh_banded_planes_from_costs(
            base_plan, vertex_costs, edge_cost_factor=edge_cost_factor, cost_limit=cost_limit,
        )
    cost_pad = _grid_plane(base_plan, vertex_costs.to(torch.float32), INF)
    res_w = _residual_weights_from_costs(base_plan, cost_pad, edge_cost_factor, cost_limit)
    base_pad = _grid_plane(base_plan, base_costs.to(torch.float32), INF)
    row_changed = torch.any(cost_pad != base_pad, dim=1)
    idx = torch.arange(R, device=cost_pad.device)
    a = torch.where(row_changed, idx, R).min()
    b = torch.where(row_changed, idx, -1).max()
    fits = (b - a + 1 + 2 * H <= PR - 2).to(torch.int64)
    p0 = torch.clamp(a - H - 1, 0, R - PR)
    fits, p0 = torch.stack([fits, p0]).tolist()
    bp = base_plan
    if not fits:
        planes = _planes_from_cost_plane(
            bp, cost_pad, bp.dist_lat_fwd, bp.dist_lat_bwd, bp.dist_down, bp.dist_up,
            bp.xdist_down, bp.xdist_up, edge_cost_factor, cost_limit,
        )
        return with_planes(bp, res_w=res_w, **planes)

    def slab(x):
        return _row_slab(x, p0 - H, PR + 2 * H)

    planes = _planes_from_cost_plane(
        bp, slab(cost_pad), slab(bp.dist_lat_fwd), slab(bp.dist_lat_bwd),
        slab(bp.dist_down), slab(bp.dist_up),
        slab(bp.xdist_down) if bp.xlanes_down else bp.xdist_down,
        slab(bp.xdist_up) if bp.xlanes_up else bp.xdist_up,
        edge_cost_factor, cost_limit,
    )

    def write(base, part):
        if part is None or base is None or part is base:
            return base
        out = base.clone()
        out[p0:p0 + PR] = part[H:H + PR]
        return out

    return with_planes(
        bp, res_w=res_w, **{k: write(getattr(bp, k), planes[k]) for k in _PLANE_KEYS}
    )


def position_planes(plan: BandedKernelPlan, mesh: MeshArrays) -> torch.Tensor:
    """[3, R, Cp] vertex-position planes (+inf padding), the static geometry
    of the warm resolve's shadow bound (pallas_banded.py:2069)."""
    return torch.stack([_grid_plane(plan, mesh.vertices[:, k].to(plan.device), INF)
                        for k in range(3)])


def changed_plane_from_costs(plan: BandedKernelPlan, old_costs, new_costs) -> torch.Tensor:
    """[R, Cp] bool plane of vertices whose cost changed (pallas_banded.py:2082)."""
    ch = ~((old_costs == new_costs) | (torch.isnan(old_costs) & torch.isnan(new_costs)))
    return _grid_plane(plan, ch, False)


def raised_plane_from_costs(plan: BandedKernelPlan, old_costs, new_costs) -> torch.Tensor:
    """[R, Cp] bool plane of vertices whose cost increased
    (pallas_banded.py:2097): only raises can strand stale-low labels, so the
    warm resolve's invalidation keys on this set."""
    up = (new_costs > old_costs) | (torch.isnan(new_costs) & ~torch.isnan(old_costs))
    return _grid_plane(plan, up, False)


def _dilate_changed(plan: BandedKernelPlan, changed_rc: torch.Tensor) -> torch.Tensor:
    """Dilate the changed-vertex plane to every endpoint of every weight-
    changed edge: dense classes and extended lanes reach |dr| <= 2,
    |dc| <= 4; both endpoints of a residual edge with a changed endpoint
    are added exactly (pallas_banded.py:2116-2143)."""
    m = changed_rc
    acc = m
    for dr in (-2, -1, 1, 2):
        acc = acc | _shift2(m, dr, 0, False)
    m = acc
    for dc in (-4, -3, -2, -1, 1, 2, 3, 4):
        acc = acc | _shift2(m, 0, dc, False)
    if plan.n_residual:
        dst, src, _ = _residual_edges(plan)
        ch = changed_rc.reshape(-1)
        touched = (ch.index_select(0, src) | ch.index_select(0, dst)).to(torch.uint8)
        flat = acc.reshape(-1).to(torch.uint8)
        flat.index_reduce_(0, src, touched, "amax")
        flat.index_reduce_(0, dst, touched, "amax")
        acc = flat.view(changed_rc.shape).bool()
    return acc
