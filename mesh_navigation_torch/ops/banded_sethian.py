"""Shift-based Sethian inflation solve for band-ordered meshes (port of
mesh_navigation_tpu/ops/banded_sethian.py:46-411).

The inflation wavefront (inflation_layer.cpp:341-491) is a geodesic distance
transform from the lethal set, bounded by the inflation radius. On a
band-ordered mesh each triangle corner's two supporting vertices sit at
small (dr, dc) grid offsets, so the Sethian update of every vertex becomes a
few dense 2D shifts of the distance plane per offset "pattern"
(dr1, dc1, dr2, dc2), evaluated with `sethian_candidates`; off-pattern
corners go to a small residual list. Jacobi label-correcting rounds run to
the fixed point.

The reference decides between its branches with lax.cond; here each
decision is one host read of a small flag: the loop's `changed` flag once
per round, and in the windowed solve `fits` once before it and the two
escape certificates once after it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mesh_navigation_torch.mesh.arrays import MeshArrays, host_array
from mesh_navigation_torch.ops import banded as _banded
from mesh_navigation_torch.ops.banded_gpu import _shift2
from mesh_navigation_torch.ops.eikonal import sethian_candidates

INF = float("inf")

# dense-pattern reach: _decompose bounds |dr| / |dc|, and the windowed
# solve's border-certificate widths and margin are derived from these
MAX_DR = 2
MAX_DC = 4


@dataclasses.dataclass(frozen=True)
class SethianPlan:
    """Per-pattern triangle side-length planes on the padded [R, Cp] grid.

    Pattern p = (dr1, dc1, dr2, dc2): for free vertex v at (r, c), support
    vertices v1 at (r+dr1, c+dc1) and v2 at (r+dr2, c+dc2). Side lengths
    (a = |v2 v3|, b = |v1 v3|, c = |v1 v2|, inflation_layer.cpp:423-441) are
    +inf where the pattern has no face."""
    n_rows: int
    n_cols: int
    n_cols_pad: int
    num_vertices: int
    patterns: tuple          # ((dr1, dc1, dr2, dc2), ...)
    n_residual: int
    pat_a: torch.Tensor      # [P, R, Cp] f32
    pat_b: torch.Tensor
    pat_c: torch.Tensor
    res_v3: torch.Tensor     # [Rz] i64 real ids (padded with 0, sides inf)
    res_v1: torch.Tensor
    res_v2: torch.Tensor
    res_a: torch.Tensor      # [Rz] f32
    res_b: torch.Tensor
    res_c: torch.Tensor
    invalid_plane: torch.Tensor  # [R, Cp] bool: invalid vertices never update


def _decompose(off: int, n: int, col: np.ndarray):
    """Split id-offset `off` into (dr, dc) with the column staying in-band.
    Returns (dr, dc, valid_mask_per_row_position)."""
    best = None
    for dr in range(-MAX_DR, MAX_DR + 1):
        dc = off - dr * n
        if abs(dc) <= MAX_DC:
            ok = (col + dc >= 0) & (col + dc < n)
            if best is None or abs(dc) < abs(best[1]):
                best = (dr, dc, ok)
    return best


def build_sethian_plan(
    mesh: MeshArrays, *, n_cols: int = 0, min_hits_frac: float = 2e-4
) -> SethianPlan:
    """Host-side classification of every (face, free corner) into dense
    shift patterns plus a residual list. Geometry only (edge distances,
    inflation_layer.cpp:452), so one plan serves every cost update."""
    faces = host_array(mesh, "faces")
    face_edges = host_array(mesh, "face_edges")
    edist = host_array(mesh, "edge_dist")
    invalid = host_array(mesh, "invalid")
    V = mesh.num_vertices
    if n_cols <= 0:
        n_cols = _banded.infer_band_width(mesh)
    if n_cols <= 0:
        raise ValueError("mesh has no band structure")
    n = n_cols
    R = -(-V // n)
    Cp = -(-n // 8) * 8
    F = faces.shape[0]

    # corner-major tables: free corner k, supports k+1, k+2
    pats: dict = {}
    residual = []
    col_all = np.arange(V, dtype=np.int64) % n
    for k in range(3):
        v3 = faces[:, k]
        v1 = faces[:, (k + 1) % 3]
        v2 = faces[:, (k + 2) % 3]
        c_len = edist[face_edges[:, k]]
        b_len = edist[face_edges[:, (k + 2) % 3]]
        a_len = edist[face_edges[:, (k + 1) % 3]]
        o1 = (v1 - v3).astype(np.int64)
        o2 = (v2 - v3).astype(np.int64)
        col3 = col_all[v3]
        pair_key = o1 * (4 * V) + o2
        uniq, inv = np.unique(pair_key, return_inverse=True)
        for ui in range(len(uniq)):
            sel = np.nonzero(inv == ui)[0]
            off1 = int(uniq[ui]) // (4 * V)
            off2 = int(uniq[ui]) - off1 * (4 * V)
            if off2 > 2 * V:
                off1 += 1
                off2 -= 4 * V
            d1 = _decompose(off1, n, col3[sel])
            d2 = _decompose(off2, n, col3[sel])
            if d1 is not None and d2 is not None:
                ok = d1[2] & d2[2]
                good = sel[ok]
                bad = sel[~ok]
            else:
                good = np.empty(0, np.int64)
                bad = sel
            if len(good) and len(good) >= max(8, int(min_hits_frac * F)):
                pats.setdefault((d1[0], d1[1], d2[0], d2[1]), []).append(
                    (v3[good], v1[good], v2[good], a_len[good], b_len[good], c_len[good])
                )
            elif len(good):
                bad = sel
            if len(bad):
                residual.append((v3[bad], v1[bad], v2[bad], a_len[bad], b_len[bad], c_len[bad]))

    def plane_of(vids, vals):
        p = np.full(R * n, np.inf, np.float32)
        p[vids] = vals
        return np.pad(p.reshape(R, n), ((0, 0), (0, Cp - n)), constant_values=np.inf)

    pat_keys = sorted(pats.keys())
    pa, pb, pc = [], [], []
    for pk in pat_keys:
        cols = [np.concatenate([e[i] for e in pats[pk]]) for i in range(6)]
        vids = cols[0]
        # a vertex can be the free corner of two faces with the same offset
        # signature on irregular meshes; the dense plane holds one entry per
        # vertex, so duplicates fall back to the exact residual list
        _, first_idx = np.unique(vids, return_index=True)
        dup = np.ones(len(vids), bool)
        dup[first_idx] = False
        if dup.any():
            residual.append(tuple(col[dup] for col in cols))
        keep = ~dup
        pa.append(plane_of(vids[keep], cols[3][keep]))
        pb.append(plane_of(vids[keep], cols[4][keep]))
        pc.append(plane_of(vids[keep], cols[5][keep]))
    if not pat_keys:
        pat_keys = [(0, 0, 0, 0)]
        pa = pb = pc = [np.full((R, Cp), np.inf, np.float32)]

    if residual:
        rv3, rv1, rv2 = (np.concatenate([r[i] for r in residual]).astype(np.int64) for i in range(3))
        ra, rb, rc = (np.concatenate([r[i] for r in residual]).astype(np.float32) for i in (3, 4, 5))
    else:
        rv3 = rv1 = rv2 = np.zeros(0, np.int64)
        ra = rb = rc = np.zeros(0, np.float32)
    n_res = len(rv3)
    pad = max(8, -(-max(n_res, 1) // 8) * 8) - n_res
    rv3, rv1, rv2 = (np.pad(x, (0, pad)) for x in (rv3, rv1, rv2))
    ra, rb, rc = (np.pad(x, (0, pad), constant_values=np.inf) for x in (ra, rb, rc))

    inv_plane = np.zeros(R * n, bool)
    inv_plane[:V] = invalid.astype(bool)
    inv_plane = np.pad(inv_plane.reshape(R, n), ((0, 0), (0, Cp - n)), constant_values=True)

    dev = mesh.device
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    return SethianPlan(
        n_rows=R, n_cols=n, n_cols_pad=Cp, num_vertices=V,
        patterns=tuple(pat_keys), n_residual=n_res,
        pat_a=t(np.stack(pa)), pat_b=t(np.stack(pb)), pat_c=t(np.stack(pc)),
        res_v3=t(rv3), res_v1=t(rv1), res_v2=t(rv2),
        res_a=t(ra), res_b=t(rb), res_c=t(rc),
        invalid_plane=t(inv_plane),
    )


def _rounds(plan: SethianPlan, d, seed_mask, pa, pb, pc, invalid, source_cap,
            max_rounds, atol, res_flat=None):
    """Jacobi rounds over a full or windowed plane until no label improves
    by more than atol (one host read per round) or max_rounds."""
    for _ in range(max_rounds):
        best = d
        for p, (dr1, dc1, dr2, dc2) in enumerate(plan.patterns):
            u1 = _shift2(d, dr1, dc1)
            u2 = _shift2(d, dr2, dc2)
            cand = sethian_candidates(u1, u2, pa[p], pb[p], pc[p]).value
            cand = torch.where((u1 <= source_cap) & (u2 <= source_cap), cand, INF)
            best = torch.minimum(best, cand)
        best = torch.where(invalid | seed_mask, d, best)
        if res_flat is not None:
            flat = best.reshape(-1)
            u1 = flat[res_flat[0]]
            u2 = flat[res_flat[1]]
            cand = sethian_candidates(u1, u2, plan.res_a, plan.res_b, plan.res_c).value
            cand = torch.where((u1 <= source_cap) & (u2 <= source_cap), cand, INF)
            tgt = res_flat[2]
            keep = ~(invalid.reshape(-1)[tgt] | seed_mask.reshape(-1)[tgt])
            cand = torch.where(keep, cand, INF)
            flat = flat.scatter_reduce(0, tgt, cand, reduce="amin")
            best = flat.reshape(d.shape)
        changed = bool(torch.any(best + atol < d))
        d = best
        if not changed:
            break
    return d


def sethian_distances_banded(
    plan: SethianPlan,
    seed_dist: torch.Tensor,      # [V] f32, inf except seeds (0 at lethals)
    *,
    source_cap: float = INF,
    max_rounds: int = 64,
    atol: float = 1e-6,
    window: tuple[int, int] | None = None,
) -> torch.Tensor:
    """Label-correcting Jacobi rounds of the dense-pattern Sethian update.
    Returns dist [V].

    With `window=(wr, wc)` the rounds run on a sub-plane placed around the
    seeds' bounding box (the live-replan path: a sensed obstacle's wave only
    travels the inflation radius). The windowed result, extended by +inf, is
    accepted only if (1) the window's inner border band (the patterns'
    reach: 2 rows / 4 columns) stayed +inf outside the seeds, so no dense
    candidate escapes, and (2) no residual support vertex in the window
    holds a finite label. Then it is the unique fixed point of the full
    relaxation; otherwise, or when the box does not fit, full-plane rounds
    run instead."""
    R, C, Cp, V = plan.n_rows, plan.n_cols, plan.n_cols_pad, plan.num_vertices
    dev = plan.pat_a.device
    d0 = torch.full((R * C,), INF, dtype=torch.float32, device=dev)
    d0[:V] = seed_dist.to(torch.float32)
    d0 = d0.view(R, C)
    if Cp > C:
        d0 = torch.cat([d0, torch.full((R, Cp - C), INF, dtype=torch.float32, device=dev)], 1)
    is_seed = torch.isfinite(d0)
    has_res = plan.n_residual > 0
    pf = lambda v: (v // C) * Cp + v % C
    res_flat = (pf(plan.res_v1), pf(plan.res_v2), pf(plan.res_v3)) if has_res else None

    def full_solve():
        d = _rounds(plan, d0, is_seed, plan.pat_a, plan.pat_b, plan.pat_c,
                    plan.invalid_plane, source_cap, max_rounds, atol, res_flat)
        return d[:, :C].reshape(-1)[:V]

    if window is None:
        return full_solve()

    wr, wc = min(window[0], R), min(window[1], Cp)
    margin = 8  # room for the wave to grow before the border certificate
    # the border certificate's seed exclusion is sound only while the seed
    # box sits >= the border widths away from the window edges
    assert margin >= max(MAX_DR, MAX_DC), (margin, MAX_DR, MAX_DC)
    rows_any = is_seed.any(dim=1)
    cols_any = is_seed.any(dim=0)
    idx_r = torch.arange(R, device=dev)
    idx_c = torch.arange(Cp, device=dev)
    rmin = torch.where(rows_any, idx_r, R).min()
    rmax = torch.where(rows_any, idx_r, -1).max()
    cmin = torch.where(cols_any, idx_c, Cp).min()
    cmax = torch.where(cols_any, idx_c, -1).max()
    fits = (rows_any.any() & (rmax - rmin + 1 + 2 * margin <= wr)
            & (cmax - cmin + 1 + 2 * margin <= wc))
    r0 = torch.clamp(torch.div(rmin + rmax + 1 - wr, 2, rounding_mode="floor"), 0, R - wr)
    c0 = torch.clamp(torch.div(cmin + cmax + 1 - wc, 2, rounding_mode="floor"), 0, Cp - wc)
    fits, r0, c0 = torch.stack([fits.to(torch.int64), r0, c0]).tolist()
    if not fits:
        return full_solve()

    rs, cs = slice(r0, r0 + wr), slice(c0, c0 + wc)
    sw = is_seed[rs, cs]
    dw = _rounds(plan, d0[rs, cs], sw, plan.pat_a[:, rs, cs], plan.pat_b[:, rs, cs],
                 plan.pat_c[:, rs, cs], plan.invalid_plane[rs, cs], source_cap,
                 max_rounds, atol)
    fin = torch.isfinite(dw)
    rr = torch.arange(wr, device=dev)[:, None]
    cc = torch.arange(wc, device=dev)[None, :]
    border = (rr < MAX_DR) | (rr >= wr - MAX_DR) | (cc < MAX_DC) | (cc >= wc - MAX_DC)
    clean = ~torch.any(fin & border & ~sw)
    if has_res:
        def in_win_val(ids_flat):
            rws = ids_flat // Cp - r0
            cws = ids_flat % Cp - c0
            inside = (rws >= 0) & (rws < wr) & (cws >= 0) & (cws < wc)
            v = dw[torch.clamp(rws, 0, wr - 1), torch.clamp(cws, 0, wc - 1)]
            return torch.where(inside, v, INF)
        pad_ok = torch.isfinite(plan.res_a)   # padded entries have inf sides
        clean = clean & ~torch.any(
            (torch.isfinite(in_win_val(res_flat[0])) | torch.isfinite(in_win_val(res_flat[1])))
            & pad_ok
        )
    if not bool(clean):
        return full_solve()
    out = torch.full((R, Cp), INF, dtype=torch.float32, device=dev)
    out[rs, cs] = dw
    return out[:, :C].reshape(-1)[:V]
