"""Stress the banded pass kernel's row stages and carried rows
(csrc/banded_pass.cu), apart from the warm pass's row jumps, which
scripts/banded_jump_stress.py stresses:

- the ordinary stage prefetch: each row, thread 0 arms the next stage's
  barrier and starts its TMA and bulk loads (after the store of two rows
  ago has left that slot), then every thread waits on this row's stage;
  and the wait for a prefetch no row took, after the walk;
- the extended lanes' two-row ring: rows r-1 and r-2 carried in shared
  memory, read by the sel-1 and sel-2 lanes of the neighbouring threads'
  columns, the written row put over r-2 and the two swapped at the row's
  end;
- the dirty mode's second read of the carried row (row0 recomputed for
  the flag of a needed row's scan), which the block's vote on that flag
  must finish before any thread writes its row into the carry;
- the bf16 field's stage ring (TMA boxes of 16-byte rows, the stage's byte
  count on its barrier) and stores rounded to bf16;
- the partial-depth exchange row: each doubling step every thread
  publishes its columns, and after a barrier reads its neighbour's 2^s
  columns away, and a second barrier frees the row for the next step;
- the deferring and unskipped row modes;
- the extended lanes' lists: with each row's stage, thread 0 copies the
  row's header and first entries into the stage's extended-lane slot
  (their bytes counted on the stage's barrier; where and how many it reads
  from the header of the row before, whose stage it has waited for), and
  after the wait each thread reads its own entries, those past the slot's
  cap from device memory.

Launches the shipped kernel many times, then a lagging copy
(scripts/lagging_copy.py) in which, row by row in turn, one warp sleeps
~80 us before the stage wait, another before it reads the carried rows,
another before the dirty mode's second read of them, another before it
writes its row into the carry, another before it publishes to and another
before it reads from the partial-depth exchange row, another before it
reads its entries of the row's lists, and thread 0 before it re-arms the
next stage and, for some rows, between the row's own copies and its
lists' copies, with the stage barrier's assertion cut to ~2 s
of the SM's cycles; and holds the first, the last and every `--every`-th
result (field, dirty table, flag, rows walked) against the plain version,
bit for bit. Inputs: a 256 x 1,024 terrain with 128 lanes (eight-warp
blocks, rows staged by TMA): a forced down pass from the seeds, an up pass
from its result, and a dirty-table pass with every row dirty on the
converged field; the same three in bf16; a partial-depth (5 steps)
dirty-driven down pass, in f32 and bf16, a deferring down pass and an
unskipped up pass, on the same terrain; extended lanes of all three kinds
on random 64-row fields of 1,024 columns (staged, two carried rows) and
2,048 columns (eight columns a thread, rows from device memory), forced
and dirty-driven, and at 1,024 columns with partial depth (three rows in
shared memory: rows from device memory), with lanes that have an edge at
~70% of their slots (rows far past the lists' staged cap) and at ~1% (an
irregular plan's density: rows within it).

Run from the tree's root on a machine with the card:

    python3 scripts/banded_pass_stress.py [--launches N] [--copy-launches M] [--every K]

Prints one JSON line; exits 1 on a mismatch or a failed launch.
"""
import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import lagging_copy as lc  # noqa: E402
from mesh_navigation_torch.mesh import synthetic  # noqa: E402
from mesh_navigation_torch.mesh.arrays import build_mesh, host_array  # noqa: E402
from mesh_navigation_torch.ops import banded_gpu as bg  # noqa: E402
from mesh_navigation_torch.ops import sweeps  # noqa: E402

ATOL, RTOL = 1e-4, 2e-3
XLANES = ((2, 0), (2, -1), (1, 2), (1, -2), (0, -3), (0, 2), (0, 4), (0, -4))
PATCHES = [
    ("      if constexpr (XL) wait_slot(slot);", "      " + lc.lag("((warp + r) & 7) == 3")),
    ("      if constexpr (!XL) wait_slot(slot);", "      " + lc.lag("((warp + r) & 7) == 3")),
    ("      if (pre && tid == 0) {\n        bulk_wait_read<1>();",
     "      " + lc.lag("tid == 0 && (r & 3) == 1")),
    ("    // cand, row0 and the flags", "    " + lc.lag("((warp + r) & 7) == 5")),
    ("      if (thr_ok) {\n        char* sd = reinterpret_cast<char*>(stage + slot * slot_f);",
     "      " + lc.lag("((warp + r) & 7) == 6")),
    ("        int simp = 0;", "        " + lc.lag("((warp + r) & 7) == 2")),
    ("        float4* nx4 = two_rows ? prev2_4 : prev4;\n        #pragma unroll",
     "        " + lc.lag("((warp + r) & 7) == 6")),
    ("    if (staged_row >= 0) wait_slot(slot);   // a prefetch no row took",
     "    " + lc.lag("(warp & 1) == 1")),
    ("        if (thr_ok) {\n          #pragma unroll\n          for (int i = 0; i < CPT; ++i) {\n"
     "            xb4[", "        " + lc.lag("((warp + r + s) & 7) == 4")),
    ("        const int k = dir == 0 ? -(1 << s) : (1 << s);",
     "        " + lc.lag("((warp + r + s) & 7) == 1")),
    ("      // the row's extended-lane lists: header, then its first xn entries",
     "      " + lc.lag("tid == 0 && (r & 3) == 2")),
    ("      if (thr_ok) {   // this thread's entries of the row's list",
     "      " + lc.lag("((warp + r) & 7) == 1")),
]
REPLACE = [("clock64() - t0 <= 40000000000LL", "clock64() - t0 <= 4000000000LL")]


def pass_case(d_in, cross, prob, *, dirty=None, xcross=None, xlanes=(), **kw):
    """(launch, same, the plain result) of one pass on copies of d_in (and
    of the dirty table)."""
    dev = d_in.device
    xlist = bg.xlane_list_from_dense(xcross, xlanes) if xlanes else None
    kw = dict(atol=ATOL, rtol=RTOL, xcross=xcross, xlanes=xlanes, xlist=xlist, **kw)
    d_p = d_in.clone()
    dirty_p = None if dirty is None else dirty.clone()
    wp = torch.zeros(1, dtype=torch.int64, device=dev)
    chg_p = bg.directional_pass_plain(d_p, cross, prob.a_fwd, prob.a_bwd, bb=8, dirty=dirty_p,
                                      rows_walked=wp, **kw)

    def launch():
        d = d_in.clone()
        dt = None if dirty is None else dirty.clone()
        wk = torch.zeros(1, dtype=torch.int32, device=dev)
        chg = bg.directional_pass(d, cross, prob.a_fwd, prob.a_bwd, dirty=dt, rows_walked=wk, **kw)
        return d, dt, chg, wk

    def same(got):
        d, dt, chg, wk = got
        return (torch.equal(d, d_p) and (dt is None or torch.equal(dt, dirty_p))
                and bool(chg.item()) == bool(chg_p.item()) and int(wk.item()) == int(wp.item()))

    return launch, same, d_p, dirty_p


def terrain_cases(device, dtype=torch.float32):
    v, f = synthetic.terrain_mesh(256, 1024, spacing=0.5, hills=2.0, roughness=0.01, seed=0)
    mesh = build_mesh(v, f, device=device)
    costs = np.arccos(np.clip(host_array(mesh, "vertex_normals")[:, 2], -1.0, 1.0))
    W = sweeps.slot_weights_np(mesh, costs.astype(np.float32), cost_limit=2.0,
                               edge_cost_factor=1.0)
    plan = bg.build_banded_kernel_plan(mesh, W)
    seeds = torch.from_numpy(np.random.default_rng(3).integers(0, plan.num_vertices, 128))
    seeds = seeds.to(device)
    prob = bg.prepare_padded(plan, seeds, dtype=dtype)
    tag = "terrain256x1024x128" + ("_bf16" if dtype == torch.bfloat16 else "")
    launch, same, d_down, _ = pass_case(prob.d0, prob.down, prob, reverse=False, force=True)
    yield f"{tag}_down_forced", launch, same
    launch, same, _, _ = pass_case(d_down, prob.up, prob, reverse=True)
    yield f"{tag}_up", launch, same
    d_conv = bg.banded_solve_padded(plan, seeds, atol=ATOL, rtol=RTOL, converge="check",
                                    dtype=dtype).d_pad
    every_row = torch.ones((d_conv.shape[2] // bg.PASS_LANES, d_conv.shape[0]),
                           dtype=torch.int32, device=device)
    launch, same, _, _ = pass_case(d_conv, prob.down, prob, reverse=False, dirty=every_row)
    yield f"{tag}_dirty_every_row", launch, same
    clean = torch.zeros_like(every_row)
    launch, same, _, _ = pass_case(prob.d0, prob.down, prob, reverse=False, force=True,
                                   dirty=clean, scan_steps=5)
    yield f"{tag}_partial5_down_forced", launch, same
    if dtype == torch.float32:
        launch, same, _, _ = pass_case(d_down, prob.down, prob, reverse=False, dirty=clean,
                                       defer=True)
        yield f"{tag}_defer_down", launch, same
        launch, same, _, _ = pass_case(d_down, prob.up, prob, reverse=True, skip=False)
        yield f"{tag}_noskip_up", launch, same


class _Chains:
    def __init__(self, a_fwd, a_bwd):
        self.a_fwd, self.a_bwd = a_fwd, a_bwd


def xl_problem(Rp, Cp, Bp, device, seed, p_lane_inf=0.3):
    """Random pass inputs with the extended lanes XLANES: weights in [0.5,
    1.5] (the lanes' in [1, 3], +inf at a share `p_lane_inf` of their
    slots) with some +inf, chain weights from random laterals, and a field
    of +inf with two zero seeds a lane and some loose upper bounds."""
    gen = torch.Generator().manual_seed(seed)

    def w(shape, lo, hi, p_inf):
        x = torch.rand(shape, generator=gen) * (hi - lo) + lo
        return torch.where(torch.rand(shape, generator=gen) < p_inf, torch.inf, x)

    lat_f, lat_b = w((Rp, Cp), 0.5, 1.5, 0.05), w((Rp, Cp), 0.5, 1.5, 0.05)
    a_fwd, a_bwd = bg._chain_weights(lat_f, lat_b, max(1, int(np.ceil(np.log2(max(Cp, 2))))))
    d = torch.full((Rp, Cp, Bp), torch.inf)
    for b in range(Bp):
        d[torch.randint(0, Rp, (2,), generator=gen), torch.randint(0, Cp, (2,), generator=gen),
          b] = 0.0
    far = torch.rand(d.shape, generator=gen) * 50 + 30
    d = torch.where(torch.rand(d.shape, generator=gen) < 0.1, far, d)
    L = len(XLANES)
    out = (d, w((Rp, 3, Cp), 0.5, 1.5, 0.1), w((Rp, 3, Cp), 0.5, 1.5, 0.1), a_fwd, a_bwd,
           w((Rp, L, Cp), 1.0, 3.0, p_lane_inf), w((Rp, L, Cp), 1.0, 3.0, p_lane_inf))
    return tuple(t.contiguous().to(device) for t in out)


def xl_cases(device):
    for Cp, p_lane_inf, tag in ((1024, 0.3, ""), (2048, 0.3, ""), (1024, 0.99, "_sparse")):
        Rp, Bp = 64, 64
        d, down, up, a_fwd, a_bwd, xdown, xup = xl_problem(Rp, Cp, Bp, device, seed=Cp,
                                                           p_lane_inf=p_lane_inf)
        prob = _Chains(a_fwd, a_bwd)
        name = f"xlanes{Rp}x{Cp}x{Bp}{tag}"
        launch, same, d_down, _ = pass_case(d, down, prob, reverse=False, force=True,
                                            xcross=xdown, xlanes=XLANES)
        yield f"{name}_down_forced", launch, same
        dirty = torch.zeros((Bp // bg.PASS_LANES, Rp), dtype=torch.int32, device=device)
        _, _, d1, dirty1 = pass_case(d, down, prob, reverse=False, force=True, dirty=dirty,
                                     xcross=xdown, xlanes=XLANES)
        launch, same, _, _ = pass_case(d1, up, prob, reverse=True, dirty=dirty1, xcross=xup,
                                       xlanes=XLANES)
        yield f"{name}_up_dirty", launch, same
        if Cp == 1024 and not tag:
            launch, same, _, _ = pass_case(d1, up, prob, reverse=True, dirty=dirty1,
                                           xcross=xup, xlanes=XLANES, scan_steps=5)
            yield f"{name}_up_dirty_partial5", launch, same


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--launches", type=int, default=500)
    ap.add_argument("--copy-launches", type=int, default=40)
    ap.add_argument("--every", type=int, default=7)
    a = ap.parse_args()

    def run(out):
        dev = torch.device("cuda")
        all_cases = [*terrain_cases(dev), *terrain_cases(dev, torch.bfloat16), *xl_cases(dev)]
        for name, launch, same in all_cases:
            out[name] = {"shipped": lc.run_launches(launch, same, a.launches, a.every)}
        copy = lc.build("banded_pass", PATCHES, REPLACE)
        with lc.swapped("banded_pass", copy):
            for name, launch, same in all_cases:
                out[name]["lagging_copy"] = lc.run_launches(launch, same, a.copy_launches, 1)

    return lc.main("banded_pass", run)


if __name__ == "__main__":
    sys.exit(main())
