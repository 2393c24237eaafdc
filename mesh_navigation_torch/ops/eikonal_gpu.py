"""Banded fast-sweeping eikonal solve with a hand-written Hopper kernel.

Counterpart of mesh_navigation_tpu/ops/pallas_eikonal.py: the per-element
CVP unfolding update (unfolding_value, :55), the offset-pair classification
of the (face, corner) update table (EikonalKernelPlan /
build_eikonal_kernel_plan, :113-275, and apply_target_mask, :724), the
round loop (eikonal_solve_padded, :516, with the hybrid graph transport
through banded_gpu's pass kernel) and the lazy path descent and direction
rows read straight off the converged field (cvp_descend_paths,
:753, and cvp_rows_at_vertices, :851).

One kernel carries the solve: `eik_pass` — csrc/eik_pass.cu, replacing
`_eik_pass_kernel` (:278). Its plain PyTorch version `_eik_pass_plain` has
the same reads, gating, gated writes and flags, and agrees with it bit for
bit. A wrapper runs the plain version only for a tensor on the CPU; on a
CUDA tensor it launches the kernel or raises.

Three choices of the port differ from the reference. The first two leave
the fixed point as it is; the third lets the kernel run as a skewed
wavefront over the whole card:
- In-row freshness. The reference runs each row in `cw`-column chunks with
  `n_inner` Jacobi repeats inside a chunk (cw = n_inner = 8 on the CVP scale
  path). The port walks a row one column at a time in the chunk direction,
  each column reading the value just written to its neighbour behind it: a
  wavefront crosses a whole row per pass in that direction. A neighbour
  ahead of it is read as the pass found it. `cw` and `n_inner` are gone.
- Lane blocks of EIK_LANES = 32 lanes instead of 128: `imp` and the dirty
  table [Bp // 32, Rp] are per 32-lane block.
- Strip-rows instead of rows as the unit of the skip and of the gated
  write: `strip_width` columns of one row (EIK_STRIP_WIDTH by default; a
  width of at least the row is the reference's row rule). The dirty table
  stays per row. The unfolding update's fixed point depends on the update
  order (ROADMAP queue C), so finer gating may settle at another one
  within the solve's tolerances. A solve refuses strips narrower than
  EIK_MIN_SOLVE_WIDTH (at 2 columns the 16x16 planner's field leaves the
  reference's by more than 1e-3), and on the card widens its strip until
  the kernel's strips can all be resident (resident_strip_width).
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import numpy as np
import torch

from mesh_navigation_torch.mesh.arrays import MeshArrays, host_array
from mesh_navigation_torch.mesh import geometry
from mesh_navigation_torch.ops import banded as _banded
from mesh_navigation_torch.ops import banded_gpu as _bg
from mesh_navigation_torch.ops import kernels
from mesh_navigation_torch.ops.eikonal import _face_corner_tables, unfolding_candidates
from mesh_navigation_torch.utils.timing import stage as _stage

INF = float("inf")
_EPS = 1e-12
EIK_LANES = 32      # batch lanes per block of the pass kernel
EIK_STRIP_WIDTH = 8  # columns of a strip-row, the pass's unit of gating (PERF.md)
EIK_MIN_SOLVE_WIDTH = 4  # the narrowest strip a solve takes (the narrowest the CPU tests hold)
MAX_CLASSES = 10    # the plan builder's cap on classes; the wrapper passes no more
CUDA_COOPERATIVE_TOO_LARGE = 720   # cudaErrorCooperativeLaunchTooLarge
# the two ordering pairs (row direction reversed?, in-row direction) of a
# round: the fast-sweeping quadrants, two diagonal pairs (pallas_eikonal.py:633-649)
_PAIR_A = ((False, 1), (True, -1))
_PAIR_B = ((False, -1), (True, 1))


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def unfolding_value(u1, u2, a, b, c, valid):
    """CVP unfolding update value only (no θ), with the decision cascade on
    cosines (θ = arccos is decreasing, so θ1 < θ0 iff t1a > t0a). `valid`
    masks absent class entries. Same operations in the same order as
    unfold() in csrc/eik_pass.cu, which is built without FMA contraction,
    so the two round alike."""
    both = torch.isfinite(u1) & torch.isfinite(u2) & valid
    u1s = torch.where(both, u1, 0.0)
    u2s = torch.where(both, u2, 0.0)
    a = torch.where(valid, a, 1.0)
    b = torch.where(valid, b, 1.0)
    c = torch.where(valid, c, 1.0)

    c_safe = torch.clamp(c, min=_EPS)
    sx = (c * c + u1s * u1s - u2s * u2s) / (2.0 * c_safe)
    sy = -torch.sqrt(torch.clamp(u1s * u1s - sx * sx, min=0.0))
    p = (b * b + c * c - a * a) / (2.0 * c_safe)
    hc = torch.sqrt(torch.clamp(b * b - p * p, min=0.0))
    dx = p - sx
    dy = hc - sy
    u3_sq = dx * dx + dy * dy
    u3 = torch.sqrt(u3_sq)

    u3_safe = torch.clamp(u3, min=_EPS)
    t0a = (a * a + b * b - c * c) / torch.clamp(2.0 * a * b, min=_EPS)
    t1a = (u3_sq + b * b - u1s * u1s) / (2.0 * u3_safe * torch.clamp(b, min=_EPS))
    t2a = (a * a + u3_sq - u2s * u2s) / (2.0 * torch.clamp(a, min=_EPS) * u3_safe)

    fb1 = u1s + b
    fb2 = u2s + a
    corner1 = torch.abs(t1a) > 1.0
    corner2 = torch.abs(t2a) > 1.0
    interior_ok = (t1a > t0a) & (t2a > t0a)
    prefer_v1 = t1a > t2a
    value = torch.where(
        corner1, fb1,
        torch.where(corner2, fb2,
                    torch.where(interior_ok, u3, torch.where(prefer_v1, fb1, fb2))),
    )
    return torch.where(both & torch.isfinite(value), value, INF)


# --------------------------------------------------------------------------
# host plan
# --------------------------------------------------------------------------

EIK_PLAN_ARRAYS = ("abc", "res_v3", "res_v1", "res_v2", "res_abc")
EIK_PLAN_META = (
    "n_rows", "n_cols", "n_cols_pad", "classes", "coverage", "num_vertices", "n_residual",
)


@dataclasses.dataclass(frozen=True)
class EikonalKernelPlan:
    """Offset-pair classification of the (face, corner) update table, on one
    device. Vertex v sits at (v // n_cols, v % n_cols) on the padded
    [R, Cp] grid. `abc` holds per-class side lengths in row layout
    ([R, 3K, Cp], entries 3k + {0, 1, 2} = a, b, c; inf = absent). The
    reference's plan also carries the table transposed (abc_t, classes_t,
    n_rows_pad_t), which its solve never reads (pallas_eikonal.py:609); the
    port does not build it. Residual pairs (off-class) are COO with
    padded-flat row-layout ids r * Cp + c. Field meanings are those of
    pallas_eikonal.py:113-137."""
    n_rows: int
    n_cols: int
    n_cols_pad: int
    classes: tuple        # ((dr1, dc1, dr2, dc2), ...) row layout
    coverage: float
    num_vertices: int
    n_residual: int
    abc: torch.Tensor     # [R, 3K, Cp] f32
    res_v3: torch.Tensor  # [Rz] i32 padded-flat
    res_v1: torch.Tensor
    res_v2: torch.Tensor
    res_abc: torch.Tensor  # [Rz, 3] f32 (a, b, c)

    @property
    def device(self) -> torch.device:
        return self.abc.device


def build_eikonal_kernel_plan(
    mesh: MeshArrays, side_lengths, *, n_cols: int = 0, device=None,
) -> EikonalKernelPlan:
    """Host-side classification of every (face, corner) pair by the offsets
    of its two supporting vertices from the free vertex. Pairs outside the
    3x3 window (|dr| <= 1, |dc| <= 1: the kernel's window, class_sources),
    beyond the MAX_CLASSES most frequent classes, or duplicated within a
    class for one vertex go to the residual list. `side_lengths` is [E]
    (numpy preferred). The plan goes to `device` (default: the mesh's)."""
    dev = mesh.device if device is None else torch.device(device)
    faces = host_array(mesh, "faces").astype(np.int64)
    fe = host_array(mesh, "face_edges")
    V = mesh.num_vertices
    sl = (side_lengths.cpu().numpy() if isinstance(side_lengths, torch.Tensor)
          else np.asarray(side_lengths))
    if n_cols <= 0:
        n_cols = _banded.infer_band_width(mesh)
    if n_cols <= 0:
        raise ValueError("mesh has no band structure")
    n = n_cols
    R = -(-V // n)
    Cp = _round_up(n, 8)

    # per (face, corner k): v3 free, v1 = k+1, v2 = k+2 (cvp argument order);
    # side a = |v2 v3| (edge opposite k+1), b = |v1 v3| (opposite k+2), c = |v1 v2|
    v3 = faces.reshape(-1)
    v1 = np.roll(faces, -1, axis=1).reshape(-1)
    v2 = np.roll(faces, -2, axis=1).reshape(-1)
    ec = fe.reshape(-1)
    eb = np.roll(fe, -2, axis=1).reshape(-1)
    ea = np.roll(fe, -1, axis=1).reshape(-1)
    a, b, c = sl[ea], sl[eb], sl[ec]
    col3 = v3 % n
    row3 = v3 // n

    def decompose(vv):
        delta = vv - v3
        dc = ((delta + n // 2) % n) - n // 2
        dr = (delta - dc) // n
        okc = (col3 + dc >= 0) & (col3 + dc < n)
        ok = okc & (np.abs(dr) <= 1) & (np.abs(dc) <= 1) & (dr * n + dc == delta)
        return dr, dc, ok

    dr1, dc1, ok1 = decompose(v1)
    dr2, dc2, ok2 = decompose(v2)
    in_class = ok1 & ok2
    # canonical order (dr1, dc1) <= (dr2, dc2): the update is symmetric
    # under (u1, b) <-> (u2, a)
    swap = dr1 * 16 + dc1 > dr2 * 16 + dc2
    a_s = np.where(swap, b, a)
    b_s = np.where(swap, a, b)
    dr1s, dc1s = np.where(swap, dr2, dr1), np.where(swap, dc2, dc1)
    dr2s, dc2s = np.where(swap, dr1, dr2), np.where(swap, dc1, dc2)
    sig = ((dr1s + 2) * 32 + (dc1s + 8)) * 1024 + (dr2s + 2) * 32 + (dc2s + 8)
    sig_m = np.where(in_class, sig, -1)
    vals, counts = np.unique(sig_m[in_class], return_counts=True)
    top = vals[np.argsort(-counts)][:MAX_CLASSES]

    classes = []
    K = len(top)
    abc = np.full((R, 3 * K, Cp), np.inf, np.float32)
    assigned = np.zeros(len(v3), bool)
    for k, s in enumerate(top):
        classes.append((int(s // 1024 // 32 - 2), int(s // 1024 % 32 - 8),
                        int(s % 1024 // 32 - 2), int(s % 1024 % 32 - 8)))
        hit = np.nonzero((sig_m == s) & ~assigned)[0]
        sel = hit[np.unique(v3[hit], return_index=True)[1]]   # one pair per vertex
        assigned[sel] = True
        rr, cc = row3[sel], col3[sel]
        abc[rr, 3 * k + 0, cc] = a_s[sel]
        abc[rr, 3 * k + 1, cc] = b_s[sel]
        abc[rr, 3 * k + 2, cc] = c[sel]

    left = np.nonzero(~assigned)[0]
    coverage = 1.0 - len(left) / max(len(v3), 1)
    Rz = max(8, _round_up(len(left), 8))
    res = {k: np.zeros(Rz, np.int32) for k in ("res_v3", "res_v1", "res_v2")}
    res_abc = np.full((Rz, 3), np.inf, np.float32)
    for k, vv in (("res_v3", v3), ("res_v1", v1), ("res_v2", v2)):
        res[k][: len(left)] = (vv[left] // n) * Cp + vv[left] % n
    res_abc[: len(left), 0] = a[left]
    res_abc[: len(left), 1] = b[left]
    res_abc[: len(left), 2] = c[left]

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    return EikonalKernelPlan(
        n_rows=R, n_cols=n, n_cols_pad=Cp, classes=tuple(classes), coverage=float(coverage),
        num_vertices=V, n_residual=int(len(left)), abc=t(abc),
        res_v3=t(res["res_v3"]), res_v1=t(res["res_v1"]), res_v2=t(res["res_v2"]),
        res_abc=t(res_abc),
    )


def apply_target_mask(plan: EikonalKernelPlan, target_mask) -> EikonalKernelPlan:
    """Disable updates into masked-out vertices (the cost-limit skip on free
    vertices, cvp_mesh_planner.cpp:802-851): their class entries become
    absent (inf side lengths) and their residual pairs are dropped."""
    tm = (target_mask.cpu().numpy() if isinstance(target_mask, torch.Tensor)
          else np.asarray(target_mask)).astype(bool)
    V, R, C, Cp = plan.num_vertices, plan.n_rows, plan.n_cols, plan.n_cols_pad
    blocked = np.zeros(R * Cp, bool)
    vid = np.arange(V)
    blocked[(vid // C) * Cp + vid % C] = ~tm
    bl_rc = blocked.reshape(R, Cp)
    abc = np.where(bl_rc[:, None, :], np.inf, plan.abc.cpu().numpy()).astype(np.float32)
    res_abc = plan.res_abc.cpu().numpy().copy()
    res_abc[blocked[plan.res_v3.cpu().numpy()]] = np.inf
    dev = plan.device
    return dataclasses.replace(
        plan, abc=torch.from_numpy(abc).to(dev),
        res_abc=torch.from_numpy(res_abc).to(dev),
    )


def class_sources(plan: EikonalKernelPlan) -> torch.Tensor:
    """[K, 2] int32 source slots of each class's two supports in the 3x3
    window around the free vertex: (dr + 1) * 3 + (dc + 1)."""
    idx = [((d1 + 1) * 3 + c1 + 1, (d2 + 1) * 3 + c2 + 1) for d1, c1, d2, c2 in plan.classes]
    return torch.tensor(idx, dtype=torch.int32, device=plan.device).reshape(-1, 2)


# --------------------------------------------------------------------------
# the kernel: one directional pass
# --------------------------------------------------------------------------

def _strips(Cp: int, chunk_dir: int, strip_width: int) -> list[list[int]]:
    """The pass's strips: the columns in `chunk_dir` order, cut into runs of
    `strip_width` (the last one shorter where Cp % strip_width != 0)."""
    cols = list(range(Cp)) if chunk_dir > 0 else list(range(Cp - 1, -1, -1))
    return [cols[i:i + strip_width] for i in range(0, Cp, strip_width)]


def _eik_pass_plain(
    d: torch.Tensor, abc: torch.Tensor, cls: torch.Tensor, dirty: torch.Tensor, *,
    reverse: bool, chunk_dir: int, atol: float, rtol: float, force: bool = False,
    strip_width: int = EIK_STRIP_WIDTH,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the pass over d [Rp, Cp, Bp] (lanes padded
    to EIK_LANES) with abc [Rp, 3K, Cp], cls [K, 2] (class_sources) and the
    last pass's dirty table [Bp // EIK_LANES, Rp] int32; d and dirty are
    left as they were. Rows run down (up when `reverse`); the row before
    is this pass's output (fresh), the row after is read from d (stale).
    Columns run one at a time in `chunk_dir`: the own-row neighbour behind
    a column is its fresh value, the one ahead the stale one.
    The unit of gating is the strip-row: `strip_width` consecutive columns
    of one row (in `chunk_dir` order, see _strips) for one 32-lane block j.
    Strip s of row r is computed when
      need = force | dirty[j, r-1 .. r+1] | carry,
    carry = g of strips s-1, s, s+1 of the row before in pass order and of
    strip s-1 of the same row, g = imp & any(new < cur) of a strip-row; it
    writes its new values when imp = any(new * (1 + rtol) + atol < cur)
    over the strip's columns and the block's lanes, and keeps cur
    otherwise, so the strip after reads the kept value behind it.
    dirty_out[j, r] is the OR of imp over the row's strips, `changed` the
    OR over all. With strip_width >= Cp the one strip is the whole row.
    (The reference's force term also asks for a finite value near the row;
    a row with none computes to cur unchanged, so dropping that test
    changes nothing.)
    Rows in pass order, strips in `chunk_dir` order, columns inside a strip:
    the kernel's skewed schedule reads exactly these values. This version
    is what the CPU runs; on a card it serves only to check the kernel.
    Returns (out, changed int32 [1], dirty_out)."""
    Rp, Cp, Bp = d.shape
    nj = Bp // EIK_LANES
    dev = d.device
    k_rtol = 1.0 + rtol
    cls = cls.long()
    src_r = cls // 3          # [K, 2] 0 = row before, 1 = own, 2 = row after
    src_c = cls % 3           # 0 = column before, 1 = own, 2 = after
    a, b, c = abc[:, 0::3, :], abc[:, 1::3, :], abc[:, 2::3, :]   # [Rp, K, Cp]
    out = torch.empty_like(d)
    dirty_out = torch.zeros_like(dirty)
    inf_row = torch.full((Cp, Bp), INF, dtype=d.dtype, device=dev)
    changed = torch.zeros((), dtype=torch.bool, device=dev)
    strips = _strips(Cp, chunk_dir, strip_width)
    S = len(strips)
    # g of the row before and of this row, one zero column on each side
    g_prev = torch.zeros((nj, S + 2), dtype=torch.bool, device=dev)
    prev = inf_row

    def block_any(x):         # [n, Bp] -> [nj]
        return x.view(x.shape[0], nj, EIK_LANES).any(dim=2).any(dim=0)

    def lanes(blk):           # [nj] -> [1, Bp]
        return blk.repeat_interleave(EIK_LANES)[None, :]

    for r in (range(Rp - 1, -1, -1) if reverse else range(Rp)):
        cur = d[r]
        rn = r - 1 if reverse else r + 1
        stale = d[rn] if 0 <= rn < Rp else inf_row
        up, dn = (stale, prev) if reverse else (prev, stale)
        near = ((dirty[:, r] > 0) | (dirty[:, max(r - 1, 0)] > 0)
                | (dirty[:, min(r + 1, Rp - 1)] > 0))
        if force:
            near = torch.ones_like(near)
        g_cur = torch.zeros_like(g_prev)
        # rows before / own / after with one inf halo column on each side;
        # the own row takes each new value as it is made, and each strip's
        # kept value once its strip is decided
        buf = torch.full((3, Cp + 2, Bp), INF, dtype=d.dtype, device=dev)
        buf[0, 1:-1], buf[1, 1:-1], buf[2, 1:-1] = up, cur, dn
        ar, br, cr = a[r], b[r], c[r]
        vr = cr < INF
        for s, cols in enumerate(strips):
            need = near | g_prev[:, s] | g_prev[:, s + 1] | g_prev[:, s + 2] | g_cur[:, s]
            if not bool(need.any()):
                continue          # the strip keeps cur in buf[1]
            for col in cols:
                u1 = buf[src_r[:, 0], src_c[:, 0] + col]          # [K, Bp]
                u2 = buf[src_r[:, 1], src_c[:, 1] + col]
                cand = unfolding_value(u1, u2, ar[:, col, None], br[:, col, None],
                                       cr[:, col, None], vr[:, col, None])
                buf[1, col + 1] = torch.minimum(buf[1, col + 1], cand.amin(dim=0))
            lo, hi = min(cols), max(cols) + 1
            new, old = buf[1, lo + 1:hi + 1], cur[lo:hi]
            imp = need & block_any(new * k_rtol + atol < old)
            buf[1, lo + 1:hi + 1] = torch.where(lanes(imp), new, old)
            dirty_out[:, r] |= imp.to(torch.int32)
            changed |= imp.any()
            g_cur[:, s + 1] = imp & block_any(new < old)
        out[r] = buf[1, 1:-1]
        prev, g_prev = out[r], g_cur
    return out, changed.to(torch.int32).reshape(1), dirty_out


def eik_pass(
    d: torch.Tensor, abc: torch.Tensor, cls: torch.Tensor, dirty: torch.Tensor, *,
    reverse: bool, chunk_dir: int, atol: float, rtol: float, force: bool = False,
    strip_width: int = EIK_STRIP_WIDTH, sm_ids: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One directional pass of the CVP unfolding update into a new field:
    the semantics of _eik_pass_plain. CPU tensors run _eik_pass_plain; CUDA
    tensors launch csrc/eik_pass.cu or raise: one block of 8 warps (8
    threads a lane) per (strip, 32-lane block) column of strip-rows, walking
    the rows in a skewed wavefront, in a cooperative launch that raises
    where the grid cannot be resident at once. `sm_ids` (CUDA int32,
    eik_pass_grid's block count or more entries) receives the SM that ran
    each block.
    Returns (out, changed int32 [1], dirty_out)."""
    if strip_width < 1:
        raise ValueError(f"eik_pass: strip_width must be at least 1, got {strip_width}")
    if d.device.type == "cpu":
        return _eik_pass_plain(d, abc, cls, dirty, reverse=reverse, chunk_dir=chunk_dir,
                               atol=atol, rtol=rtol, force=force, strip_width=strip_width)
    if d.device.type != "cuda":
        raise ValueError(f"eik_pass: unsupported device {d.device}")
    Rp, Cp, Bp = d.shape
    K = cls.shape[0]
    if Bp % EIK_LANES:
        raise ValueError(f"eik_pass: lanes must be a multiple of {EIK_LANES}, got {Bp}")
    if not 1 <= K <= MAX_CLASSES:
        raise ValueError(f"eik_pass: 1 to {MAX_CLASSES} classes, got {K}")
    if chunk_dir not in (1, -1):
        raise ValueError(f"eik_pass: chunk_dir must be +1 or -1, got {chunk_dir}")
    for name, t, shape, dtype in (
        ("d", d, (Rp, Cp, Bp), torch.float32), ("abc", abc, (Rp, 3 * K, Cp), torch.float32),
        ("cls", cls, (K, 2), torch.int32), ("dirty", dirty, (Bp // EIK_LANES, Rp), torch.int32),
    ):
        if (t.device != d.device or t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"eik_pass: bad {name} {tuple(t.shape)} {t.dtype} {t.device}")
    if sm_ids is not None:
        n = eik_pass_grid(Cp, Bp, K, strip_width)["blocks"]
        if sm_ids.device != d.device or sm_ids.dtype != torch.int32 or sm_ids.numel() < n:
            raise ValueError(f"eik_pass: sm_ids needs {n} int32 entries on {d.device}")
    nj, S = Bp // EIK_LANES, -(-Cp // strip_width)
    out = d.clone()       # the kernel writes only the strip-rows it improves
    dirty_out = torch.zeros_like(dirty)
    chg = torch.zeros(1, dtype=torch.int32, device=d.device)
    progress = torch.zeros(nj * S, dtype=torch.int32, device=d.device)
    stream = torch.cuda.current_stream(d.device).cuda_stream
    err = kernels.launcher("eik_pass")(
        d.data_ptr(), out.data_ptr(), abc.data_ptr(), cls.data_ptr(), dirty.data_ptr(),
        dirty_out.data_ptr(), chg.data_ptr(), progress.data_ptr(),
        None if sm_ids is None else sm_ids.data_ptr(), Rp, Cp, Bp, K, int(reverse),
        int(chunk_dir), int(force), strip_width, 1.0 + rtol, atol, stream,
    )
    _check_launch(err, Cp, strip_width)
    kernels.LAUNCHES["eik_pass"] += 1
    return out, chg, dirty_out


def _check_launch(err: int, Cp: int, strip_width: int) -> None:
    if err == CUDA_COOPERATIVE_TOO_LARGE:
        raise RuntimeError(
            f"eik_pass: the {-(-Cp // strip_width)} strips of width {strip_width} cannot all be "
            f"resident on this card at once; use a wider strip")
    kernels.check("eik_pass", err)


def eik_pass_grid(Cp: int, Bp: int, K: int, strip_width: int = EIK_STRIP_WIDTH) -> dict:
    """The kernel's launch shape for a [*, Cp, Bp] field with K classes on
    the current card: strips S, lane blocks, the grid (S, G) of 256-thread
    blocks (a block walks lane blocks g, g + G, ...), resident blocks an SM
    and the card's SMs. Raises where not even one lane block's S blocks can
    be resident at once (no safe launch exists)."""
    info = (ctypes.c_int * 4)()
    _check_launch(kernels.query("eik_pass")(Cp, Bp, K, strip_width, ctypes.addressof(info)),
                  Cp, strip_width)
    S, G, per_sm, n_sm = info
    return {"strips": S, "lane_blocks": Bp // EIK_LANES, "grid": [S, G], "blocks": S * G,
            "threads_per_block": 8 * EIK_LANES, "blocks_per_sm": per_sm, "sms": n_sm}


def resident_strip_width(Cp: int, Bp: int, K: int, strip_width: int = EIK_STRIP_WIDTH) -> int:
    """The smallest strip width >= strip_width whose ceil(Cp / width) strips
    can all be resident on the current card at once, from eik_pass_grid's
    figures at one strip a row (blocks an SM times SMs). Raises where even
    one strip a row cannot be resident."""
    info = eik_pass_grid(Cp, Bp, K, Cp)
    cap = info["blocks_per_sm"] * info["sms"]
    return max(strip_width, -(-Cp // cap))


# --------------------------------------------------------------------------
# solve loop
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EikonalPaddedResult:
    d_pad: torch.Tensor    # [R, Cp, Bp] row layout, lanes padded to EIK_LANES
    rounds: int
    converged: bool


def _residual_update(plan, d, dirty, k_rtol, atol):
    """Gather / scatter-min of the off-class pairs (pallas_eikonal.py:650-664),
    in place on d; marks the rows of improved pairs dirty. Returns the
    improved flag (bool [])."""
    Rp, Cp, Bp = d.shape
    nj = Bp // EIK_LANES
    flat = d.view(Rp * Cp, Bp)
    v3, v1, v2 = plan.res_v3.long(), plan.res_v1.long(), plan.res_v2.long()
    ra = plan.res_abc
    cand = unfolding_value(flat[v1], flat[v2], ra[:, 0, None], ra[:, 1, None],
                           ra[:, 2, None], ra[:, 2, None] < INF)
    imp = cand * k_rtol + atol < flat[v3]
    flat.scatter_reduce_(0, v3[:, None].expand(-1, Bp), cand, reduce="amin")
    impj = imp.view(-1, nj, EIK_LANES).any(dim=2).T.to(torch.int32)    # [nj, Rz]
    dirty.scatter_reduce_(1, (v3 // Cp)[None, :].expand(nj, -1), impj, reduce="amax")
    return imp.any()


def seeded_field(plan: EikonalKernelPlan, seed_v: torch.Tensor, seed_d: torch.Tensor) -> torch.Tensor:
    """The solve's first field [R, Cp, Bp] (lanes padded to EIK_LANES): +inf
    but at each lane's seeds (seed_v [B, S] real vertex ids, seed_d [B, S];
    the smallest distance where a vertex repeats)."""
    dev = plan.device
    B = seed_v.shape[0]
    R, C, Cp = plan.n_rows, plan.n_cols, plan.n_cols_pad
    Bp = _round_up(B, EIK_LANES)
    seed_v = seed_v.to(dev).long()
    flat_ids = (seed_v // C) * Cp + seed_v % C                       # [B, S]
    lane = torch.arange(B, device=dev)[:, None].expand_as(seed_v)
    d0 = torch.full((R * Cp * Bp,), INF, dtype=torch.float32, device=dev)
    d0.scatter_reduce_(0, (flat_ids * Bp + lane).reshape(-1),
                       seed_d.to(dev, torch.float32).reshape(-1), reduce="amin")
    return d0.view(R, Cp, Bp)


def eikonal_solve_padded(
    plan: EikonalKernelPlan,
    seed_v: torch.Tensor,        # [B, S] real vertex ids (pad: repeat)
    seed_d: torch.Tensor,        # [B, S] f32 seed distances (inf = unused)
    *,
    max_rounds: int = 128,
    atol: float = 1e-5,
    rtol: float = 1e-5,
    init_vb: torch.Tensor | None = None,
    orderings: int = 4,
    graph_plan=None,
    timer=None,
    strip_width: int = EIK_STRIP_WIDTH,
) -> EikonalPaddedResult:
    """Batched eikonal fields by fast-sweeping rounds (pallas_eikonal.py:516).
    The first round is forced and runs all four orderings (row direction x
    in-row direction); later rounds run all four (`orderings` 4) or one
    diagonal pair, alternating by round parity (`orderings` 2). The dirty
    table carries between passes as in the reference (:611-649), then the
    residual pairs update. One host read of the changed flag per round;
    the loop ends on a round with no improvement beyond atol + rtol·|label|.
    `init_vb` [V, B] warm-starts the field with
    upper bounds of the fixed point (a graph-distance field plus the seed
    offset). `strip_width` is the passes' unit of gating (eik_pass), at
    least EIK_MIN_SOLVE_WIDTH; on the card it is widened to
    resident_strip_width where its strips cannot all be resident.

    `graph_plan` (a banded Dijkstra kernel plan over the same side lengths
    and the same grid, e.g. CVPPlanner._dij_plan) makes each round hybrid
    (pallas_eikonal.py:528-545, :660-685): after the orderings and the
    residual update, banded_solve_padded(graph_plan, init_pad=field,
    max_rounds=32) carries every improvement along the graph's edges across
    the mesh at the pass kernel's speed. The triangle update lower-bounds
    the edge relaxation, so the edge constraints do not lower the fixed
    point; a graph with fewer or heavier edges (the CVP '>=' skip) keeps
    them valid upper bounds. The rows the graph stage changed become dirty
    for the next orderings, and its change counts as the round's. The
    graph plan must have the eikonal plan's rows, columns and padded
    columns (ValueError otherwise; the reference assumes it)."""
    if graph_plan is not None and (
            (graph_plan.n_rows, graph_plan.n_cols, graph_plan.n_cols_pad)
            != (plan.n_rows, plan.n_cols, plan.n_cols_pad)):
        raise ValueError(
            f"graph_plan grid {(graph_plan.n_rows, graph_plan.n_cols, graph_plan.n_cols_pad)} "
            f"is not the eikonal plan's {(plan.n_rows, plan.n_cols, plan.n_cols_pad)}")
    if orderings not in (2, 4):
        raise ValueError(f"orderings must be 2 or 4, got {orderings}")
    if strip_width < EIK_MIN_SOLVE_WIDTH:
        raise ValueError(f"a solve's strip_width must be at least {EIK_MIN_SOLVE_WIDTH}, "
                         f"got {strip_width}")
    dev = plan.device
    R, C, V = plan.n_rows, plan.n_cols, plan.num_vertices
    d = seeded_field(plan, seed_v, seed_d)
    B = seed_v.shape[0]
    nj = d.shape[2] // EIK_LANES
    if d.device.type == "cuda":
        strip_width = resident_strip_width(d.shape[1], d.shape[2], len(plan.classes), strip_width)
    if init_vb is not None:
        ip = torch.full((R * C, B), INF, dtype=torch.float32, device=dev)
        ip[:V] = init_vb.to(dev, torch.float32)
        d[:, :C, :B] = torch.minimum(d[:, :C, :B], ip.view(R, C, B))
    abc = plan.abc.contiguous()
    cls = class_sources(plan)
    k_rtol = 1.0 + rtol

    def half_round(d, dirty, pair, force):
        acc = torch.zeros_like(dirty)
        chg = torch.zeros(1, dtype=torch.int32, device=dev)
        for rev, cdir in pair:
            d, c, imp = eik_pass(d, abc, cls, torch.maximum(dirty, acc), reverse=rev,
                                 chunk_dir=cdir, atol=atol, rtol=rtol, force=force,
                                 strip_width=strip_width)
            acc = torch.maximum(acc, imp)
            chg = chg | c
        return d, acc, chg

    def one_round(d, dirty, force=False, phase=None):
        with _stage(timer, "eikonal"):
            if orderings >= 4 or phase is None:
                d, acc, ca = half_round(d, dirty, _PAIR_A, force)
                d, acc2, cb = half_round(d, torch.maximum(dirty, acc), _PAIR_B, force)
                changed, dirty = (ca | cb).bool().any(), torch.maximum(acc, acc2)
            else:
                pair = _PAIR_A if phase % 2 == 0 else _PAIR_B
                d, dirty, changed = half_round(d, dirty, pair, False)
                changed = changed.bool().any()
            if plan.n_residual:
                changed = changed | _residual_update(plan, d, dirty, k_rtol, atol)
        if graph_plan is not None:
            with _stage(timer, "graph"):
                g = _bg.banded_solve_padded(
                    graph_plan, torch.zeros(B, dtype=torch.int64, device=dev), max_rounds=32,
                    atol=atol, rtol=rtol, init_pad=d).d_pad
                if g.shape != d.shape:
                    g = _bg.conform_padded(g, *d.shape)
                # the graph solve worked on its own copy, so d is the field
                # before it: the rows it moved re-enter the orderings
                moved = (g != d).any(dim=1)                                  # [R, Bp]
                dirty = torch.maximum(
                    dirty, moved.view(R, nj, EIK_LANES).any(dim=2).T.to(torch.int32))
                changed = changed | moved.any()
                d = g
        return d, dirty, changed

    dirty = torch.zeros((nj, R), dtype=torch.int32, device=dev)
    d, dirty, changed = one_round(d, dirty, force=True)
    rounds = 1
    while bool(changed) and rounds < max_rounds:
        d, dirty, changed = one_round(d, dirty, phase=rounds)
        rounds += 1
    return EikonalPaddedResult(d_pad=d, rounds=rounds, converged=not bool(changed))


def eikonal_field_banded(mesh: MeshArrays, plan: EikonalKernelPlan, seed_v, seed_d, **kw):
    """Solve and unpad to [B, V] f32: (dist, rounds, converged)."""
    res = eikonal_solve_padded(plan, seed_v, seed_d, **kw)
    R, C, V = plan.n_rows, plan.n_cols, plan.num_vertices
    B = seed_v.shape[0]
    dist = res.d_pad[:R, :C, :B].reshape(R * C, B)[:V]
    return dist.T, res.rounds, res.converged


def padded_flat_from_vb(plan: EikonalKernelPlan, dist_bv: torch.Tensor) -> torch.Tensor:
    """A [B, V] field in the solver's lane-minor padded-flat layout
    [R * Cp, B] (+inf padding), the layout the descent and the direction
    rows read."""
    R, C, Cp, V = plan.n_rows, plan.n_cols, plan.n_cols_pad, plan.num_vertices
    B = dist_bv.shape[0]
    out = torch.full((R, Cp, B), INF, dtype=dist_bv.dtype, device=dist_bv.device)
    full = torch.full((R * C, B), INF, dtype=dist_bv.dtype, device=dist_bv.device)
    full[:V] = dist_bv.T
    out[:, :C] = full.view(R, C, B)
    return out.view(R * Cp, B)


# --------------------------------------------------------------------------
# lazy descent and direction rows
# --------------------------------------------------------------------------

def _winning_candidates(mesh, side_lengths, d_flat, to_flat, vids, lane, tables):
    """The incident (face, corner) candidates of vids ([B] or [B, K]) against
    the field, masked: (value [..., FD], pred_is_v1, theta, u1 ids, u2 ids)."""
    v1t, v2t, _, ea, eb, ec = tables
    f = mesh.vertex_faces[vids].long()
    k = mesh.vertex_face_corner[vids].long()
    m = mesh.vertex_faces_mask[vids]
    u1v, u2v = v1t[f, k], v2t[f, k]
    ln = lane[..., None]
    cands = unfolding_candidates(
        d_flat[to_flat(u1v), ln], d_flat[to_flat(u2v), ln],
        side_lengths[ea[f, k]], side_lengths[eb[f, k]], side_lengths[ec[f, k]],
    )
    return torch.where(m, cands.value, INF), cands.pred_is_v1, cands.theta, u1v, u2v


def cvp_descend_paths(
    plan: EikonalKernelPlan,
    mesh: MeshArrays,
    side_lengths: torch.Tensor,   # [E]
    d_flat: torch.Tensor,         # [R * Cp, >= B] converged field, lane-minor padded flat
    start_v: torch.Tensor,        # [B]
    goal_vids: torch.Tensor,      # [B, S] goal-face seed vertices
    max_len: int,
    *,
    tol: float = 1e-3,
    chunk: int = 256,
    graph: bool | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Vertex-level path extraction from the eikonal field without a [B, V]
    pred map (pallas_eikonal.py:753): per step, recompute the winning
    triangle candidate of the current vertex and step to the supporting
    predecessor, ending on a goal-face seed vertex or a stall. Chunks of
    `chunk` steps with one host read of any(alive) before each. The
    reference takes a [B, V] seed mask; the port takes the seed ids.
    On a CUDA device (`graph` None or True) the first 32 steps run eagerly
    and the rest replay a CUDA graph of 32 steps (~100 small launches each,
    which the host would otherwise issue one by one).
    Returns (path [B, max_len] i64, valid [B, max_len] bool); steps after a
    lane ends hold its final vertex with valid False."""
    C, Cp = plan.n_cols, plan.n_cols_pad
    dev = d_flat.device
    B = start_v.shape[0]
    lane = torch.arange(B, device=dev)
    tables = _face_corner_tables(mesh)
    goal_vids = goal_vids.long()
    use_graph = dev.type == "cuda" if graph is None else graph
    sub = math.gcd(chunk, 32) if use_graph else chunk     # steps per graph replay

    def to_flat(v):
        return (v // C) * Cp + v % C

    v = start_v.long().clone()
    alive = torch.ones(B, dtype=torch.bool, device=dev)
    path_s = torch.empty((sub, B), dtype=torch.int64, device=dev)
    valid_s = torch.empty((sub, B), dtype=torch.bool, device=dev)

    def run_steps():              # in place on v, alive, path_s, valid_s
        for i in range(sub):
            path_s[i] = v
            valid_s[i] = alive
            dv = d_flat[to_flat(v), lane]
            val, is_v1, _, u1v, u2v = _winning_candidates(
                mesh, side_lengths, d_flat, to_flat, v, lane, tables)
            best, arg = torch.min(val, dim=1)
            pick = lambda x: torch.gather(x, 1, arg[:, None])[:, 0]
            nxt = torch.where(pick(is_v1), pick(u1v), pick(u2v))
            descends = (best <= dv * (1.0 + tol) + tol) & torch.isfinite(dv)
            at_goal = (v[:, None] == goal_vids).any(dim=1)
            alive.logical_and_(~at_goal & descends)
            v.copy_(torch.where(alive, nxt, v))

    n_chunks = -(-max_len // chunk)
    path = torch.empty((n_chunks * chunk, B), dtype=torch.int64, device=dev)
    valid = torch.zeros((n_chunks * chunk, B), dtype=torch.bool, device=dev)
    ran, replay = 0, None
    for ci in range(n_chunks):
        if not bool(alive.any()):
            break
        for row in range(ci * chunk, (ci + 1) * chunk, sub):
            if replay is not None:
                replay()
            else:
                run_steps()
                if use_graph:
                    g = torch.cuda.CUDAGraph()
                    with torch.cuda.graph(g):
                        run_steps()       # recorded, not run
                    replay = g.replay
            path[row:row + sub] = path_s
            valid[row:row + sub] = valid_s
        ran = (ci + 1) * chunk
    path[ran:] = v
    return path.T[:, :max_len], valid.T[:, :max_len]


def cvp_rows_at_vertices(
    plan: EikonalKernelPlan,
    mesh: MeshArrays,
    side_lengths: torch.Tensor,   # [E]
    d_flat: torch.Tensor,         # [R * Cp, >= B] converged field, lane-minor padded flat
    vids: torch.Tensor,           # [B, K] real vertex ids
    *,
    tol: float = 1e-3,
) -> torch.Tensor:
    """CVP direction rows at a few vertices per lane (pallas_eikonal.py:851):
    the winning (pred, θ) of each vertex's incident candidates against the
    field, and (pos[pred] - pos[v]) rotated by θ around the vertex normal
    (cvp_mesh_planner.cpp:204-239). No [B, V] pred or θ map is built.
    Returns [B, K, 3] unit rows, zero where no update supports the label
    (seeds and unreached vertices)."""
    C, Cp = plan.n_cols, plan.n_cols_pad
    vids = vids.long()
    B = vids.shape[0]
    lane = torch.arange(B, device=vids.device)[:, None]                 # [B, 1]

    def to_flat(v):
        return (v // C) * Cp + v % C

    val, is_v1, theta, u1v, u2v = _winning_candidates(
        mesh, side_lengths, d_flat, to_flat, vids, lane, _face_corner_tables(mesh))
    best, arg = torch.min(val, dim=-1)                                   # [B, K]
    pick = lambda x: torch.gather(x, -1, arg[..., None])[..., 0]
    pred = torch.where(pick(is_v1), pick(u1v), pick(u2v))
    dv = d_flat[to_flat(vids), lane]
    has = ((best <= dv * (1.0 + tol) + tol) & (dv > 0) & torch.isfinite(dv)
           & (pred != vids))
    d = mesh.vertices[pred] - mesh.vertices[vids]
    rotated = geometry.rotate_about_axis(d, mesh.vertex_normals[vids], pick(theta))
    unit = rotated / torch.clamp(geometry.norm(rotated)[..., None], min=1e-12)
    return torch.where(has[..., None], unit, 0.0)
