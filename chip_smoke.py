#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mesh_navigation_torch) on one NVIDIA card.

Run from the repository root: `python3 chip_smoke.py`. It needs a CUDA
device and `nvcc`; without them it exits non-zero and prints no result.
Phases, each printed as one JSON line on standard output:

1. device: the card, `nvidia-smi`'s name and power limit, kernel build time
   (every csrc/*.cu is compiled by its own nvcc, all at once).
2. kernel_check: on a 128x128 terrain with 64 lanes, the pass kernel against
   its plain PyTorch version (one forced down pass, one up pass; fields bit
   for bit, flags equal), the class-pred kernel against its plain version
   on the same fields (int8 class and int32 id tables identical, with and
   without the certificate; flags equal), the
   check kernel against its plain version on a converged field and on it with
   one element lowered and one raised (flags equal), and the pass kernel in
   its warm modes (dirty table + warm cut) against its plain version from a
   converged field with a raised patch (fields bit for bit, dirty tables,
   flags and rows walked equal); the same pass checks on 8-row terrains of
   1,500 and 3,000 columns (rows past 1,024 columns, 16 lanes).
   eik_kernel_check: on a 40x36 terrain with 16 lanes, the eikonal pass
   kernel against its plain version at the default strip width and at a
   narrow one (4 columns), each of the four orderings forced and then
   driven by the forced pass's dirty table (fields bit for bit where
   reached, else within atol + rtol*|d|; dirty tables and flags equal), and
   the plain version's time at this shape.
   sweep_kernel_check: the fused sweep kernel against its plain version, bit
   for bit, at tile 256 (n_inner 1, 2, 3; offsets of +-tile; 8, 24 and 128
   lanes; vertex counts that are not multiples of the tile) and at the 1M
   terrain's tile and offsets on a small matrix.
3. main_path: the headline pipeline at full width — 1024x1024 terrain
   (V = 1,048,576), 1024 lanes, f32, atol 1e-4 / rtol 2e-3: steepness costs
   -> slot weights -> banded plan -> DijkstraPlanner.plan_batch_banded ->
   MeshController.compute_velocity_banded. One warm-up, then timed
   iterations: solves/s, rounds, per-stage device times, kernel launches;
   then one more iteration under torch.profiler for the device's idle share.
4. oracle: two lanes against the native heap Dijkstra; the error must stay
   below 1%.
5. kernels at the main path's shapes: each kernel against its plain version
   on the main path's own field, with its time, the plain version's time and
   the bound; the class-pred kernel in both modes (int8 classes with the
   certificate, int32 ids); the walk kernel on the class table, starts and
   goals of one more plan_batch_banded call on the warm-up draw, launched
   twice and against its plain loop (path and valid equal), with its time,
   the loop's and the bound (walk_check).
6. banded_full: the full banded plan result at full width on the same mesh
   and plan — 128 lanes (scenarios from the seed), one warm-up, then ITERS
   timed DijkstraPlanner.plan_batch_banded(light=False) calls (a quiet-round
   solve, the int32 predecessor table of the class-pred kernel's id mode,
   the [B, V, 3] vector map, the walk), each followed by one
   MeshController.compute_velocity cycle: solves/s, rounds and `converged`
   per solve (gated), per-stage device times, launches, peak memory, one
   traced iteration for the idle share. Then, not counted for the path,
   `full_result_roll`: the reference's full-result route,
   ops/banded_gpu.batched_field_banded_pallas (the pass kernel, then the
   roll-based predecessors_banded in plain torch), on the warm-up draw's
   goals, one warm-up and one timed call: solve, unpad and recovery ms,
   rounds, launches in the call (the pass kernel > 0, class_pred none), the
   recovery's ms and peak memory alone; gated: converged, the field bit for
   bit banded_solve_padded's from the same goals and settings (the field
   phase 8 reads), the card's table equal to the same code's on a CPU copy
   of two lanes, every non-self predecessor explaining its label through
   the plan's class planes or residual list, and where it differs from the
   id kernel's table on that field, both of equal cost.
7. banded_full_oracle: two lanes of the warm-up solve against the native
   heap Dijkstra: the field's largest relative error and the path cost
   against the native predecessor chain's, both below 1%.
8. kernels at the banded_full shapes: the id-mode kernel on the path's own
   field against its plain version (both modes, bit for bit), its time, the
   plain version's and the bound, and the roll-based recovery's time
   against it.
9. replan: the live-replan cascade at full width (bench.py:367-445) on the
   same mesh — layers steepness + obstacle + inflation + max combination,
   128 lanes, one cold base solve, a warm-up step, then the jump / drift /
   clear pattern of 512-point clouds, timed ITERS times: ms and Hz per update,
   rounds per pattern, per-stage device times, launches per step, one traced
   step for the idle share. Gates: every step's warm field against a cold
   solve on that step's planes (same finite set, max relative difference
   below 1%), `converged` after every step, two lanes of the last field
   against the native heap Dijkstra on its costs (below 1%), and the check
   and warm-mode pass kernels launched.
10. kernels at the replan shapes: the warm resolve of the last update pass by
   pass (warm pass ms per launch against its bound, the share of the blocks'
   rows each pass walked and the share it leaves unchanged), the check
   kernel against its plain version with its time and bound.
11. cvp: the CVP planner at full width (bench.py:451-554) on the same mesh
   and costs — side lengths = edge weights, the eikonal plan with its
   Dijkstra warm plan, 128 lanes with starts and goals on vertices, one
   warm-up, then ITERS timed CVPPlanner.plan_batch_banded calls, each
   followed by one MeshController.compute_velocity_cvp cycle: solves/s,
   rounds and `converged` per solve (gated), per-stage device times,
   launches per solve, peak memory, one traced iteration for the idle share.
12. cvp_oracle: two lanes of the warm-up solve against the native CVP fast
   marching, the 99.9th-percentile relative error below 1%, and each
   lane's walked cost within 1% + 1e-2 of the same descent walked on the
   oracle's field (the vertex descent walks along edges, so the oracle's
   distance itself is no bound on it; the ratio is printed).
13. kernels at the CVP shapes: each eikonal pass of one more solve timed by
   its own event pair against its bound (from the strip-rows it computed),
   the launch's strip width, lane block, grid and the SMs its blocks ran
   on; its first forced pass launched twice (bit for bit equal) and timed
   at strip widths 4, 8 and 16; that pass and the first dirty-driven pass
   held against the plain version on a 4-row slab of their own input at
   the full width, lanes and classes (fields bit for bit, dirty tables and
   flags equal).
14. structured: the structured Dijkstra tier at full width on the same mesh
   and costs — the host offset classification (timed; offsets, coverage,
   the port's tile and n_inner printed), 128 lanes with starts and goals on
   vertices, one warm-up, then ITERS timed
   DijkstraPlanner.plan_batch_structured calls (fused offset-shift sweeps,
   the full result with its [B, V, 3] vector map), each followed by one
   MeshController.compute_velocity cycle: solves/s, sweeps and `converged`
   per solve (gated), per-stage device times, fused-sweep launches per
   solve, peak memory, one traced iteration for the idle share.
15. structured_oracle: two lanes of the warm-up solve against the native
   heap Dijkstra: the field's largest relative error and the path cost
   against the native predecessor chain's, both below 1%.
16. kernels at the structured shapes: the fused sweep on the path's own
   field after 64 sweeps, one launch against the plain version bit for bit,
   its time against its bound and the plain version's time.
17. irregular: the irregular-mesh stage at full width (bench.py:559-614) —
   a jittered-Delaunay 1024x1024 terrain (seed 1), band-reordered, steepness
   costs, the banded plan with residual edges and extended lanes (its
   n_cols, coverage, residual edges, residual destinations and lanes
   printed), 512 lanes, atol 1e-3 / rtol 2e-3, one warm-up, then ITERS
   timed DijkstraPlanner.plan_batch_banded calls (light: a quiet-round
   solve with the residual scatter-min, the residual class table, the
   class-9 walk), each followed by one compute_velocity_banded cycle:
   solves/s, rounds and `converged` per solve (gated), per-stage device
   times, launches, peak memory, one traced iteration for the idle share.
18. irregular_oracle: eight lanes of the warm-up solve against the native
   heap Dijkstra: the larger of the start vertex's relative error and the
   field's 99.9th-percentile one, below 1%.
19. kernels at the irregular shapes: one more solve of the warm-up draw,
   each pass launch timed against its bound with the rows its blocks
   walked, each residual scatter-min timed; its first forced down pass and
   first label-changing dirty-driven up pass held against the plain
   version on a 48-row slab of their own input (bit for bit, dirty tables,
   flags and rows walked equal); the class-pred kernel on the solve's field
   against its plain version (both modes), its time and bound; the walk
   kernel's class-9 decode on the tables of one more call on the warm-up
   draw (walk_check). Then the `{"kernels": [...]}` line with the five
   ported kernels and the port's own `walk` (`class_pred` with its id
   mode's time, bound and launches beside the main mode's; `banded_pass`,
   `class_pred` and `walk` with their irregular-path launches, time and
   bound;
   `banded_pass` and `eik_pass` with their `server_launches`; `banded_pass`,
   `eik_pass`, `class_pred` and `check` with their
   `server_layers_launches`, from phase 22; `banded_pass` and `class_pred`
   with their `scanned_map_launches`, from phase 23).
20. server_cvp: the navigation server's CVP kind (the reference's default)
   at full width on the main path's terrain with the replan phase's
   layers: set-up, one warm-up and ITERS timed get_path_batch calls of 128
   lanes (solves/s, rounds, stages, launches, idle share, peak memory),
   then the replan phase's first jump cloud through update_point_cloud and
   one more get_path_batch, which rebuilds the plan the update marked
   stale (its seconds printed). Gates: converged everywhere, `eik_pass` and
   `banded_pass` launched, two lanes against the native fast marching on
   the server's current costs before and after the update, the
   post-update result bit for bit equal to plan_batch_banded on a plan
   built afresh from the server's edge weights and costs (and its field
   unlike the pre-update one near the obstacle), and the post-update
   solve's first forced `eik_pass` held against the plain pass on a 4-row
   slab.
21. server_single: one robot on the same map through both server kinds
   (the CVP server of phase 20, the replan phase's Dijkstra server): the
   single GetPath of each (gather sweeps; sweeps and ms printed) against
   its native oracle at the start vertex and the 99.9th percentile (<1%),
   one setPlan / ExePath / goal check, and navigate on two seeded pairs 25 m
   apart (NAV_PAIRS; the first under the card's trace): outcome, cycles,
   recoveries, wall s and the host's share; gated on the reference loop's
   outcome on each pair, and on the first within the goal tolerance of the
   plan's goal pose.
22. server_layers: the layered costmap behind the server at full width
   (configuration full_stack: height_diff, roughness and ridge at radius
   1.0 m, steepness, border, clearance, obstacle, inflation over obstacle +
   border + clearance with its repulsive field, their max), on the same
   terrain: set-up (the radius table's K, the 3-D face grid's dims and
   largest bucket with their build times, each layer's card time, lethal
   share and mean cost, the repulsive field's sweeps, the eikonal plan's
   build time); the five new layers, the radius table and the repulsive
   field against the same functions on host copies (tables and lethal
   masks equal, costs and vectors within 1e-5, equal support; the CPU
   side's seconds printed); raycast_grid against raycast_bruteforce for
   4,096 seeded rays (faces equal and t within 1e-5 within the grid's
   reach) and the two clearance routes on 4,096 vertices (equal); one
   warm-up and ITERS timed get_path_batch calls of 128 lanes (solves/s,
   rounds, stages, launches, idle share, peak memory; converged, eik_pass
   and banded_pass launched, two lanes against the native fast marching);
   the replan phase's first jump cloud through update_point_cloud and one
   more get_path_batch (bit for bit a fresh plan's, the oracle after it,
   the repulsive field non-zero around the obstacle); one CVP get_path on
   server_single's first pair with the layers' field blended in (its
   oracle gate; its smallest distance to the inflation's lethal set,
   length and time beside the same plan without the field); a
   Dijkstra-kind server with the same stack: make_replan_step("obst"), a
   warm-up, then jump / drift / clear once each (ms per update; warm
   against cold, converged, check and the warm pass launched), and one
   get_path_batch (converged, two lanes against the native heap
   Dijkstra).
23. scanned_map: maps from files at full width. (a) The irregular phase's
   jittered-Delaunay terrain with its vertex ids permuted by a seeded
   permutation (a scan's native order), written as a binary PLY and loaded
   by mesh/io.read_map (import and build timed), behind a Dijkstra server
   on the steepness layer with the default PlannerConfig: no banded plan
   and offset coverage <= 0.5 (asserted), so get_path_batch takes
   plan_batch's hybrid solve. Set-up, one warm-up and two timed batches
   of 128 lanes (sweeps, stages, peak memory; timed at ordered_rounds 2
   where the warm-up took more than 20 s) and one solve at ordered_rounds
   2; gates: converged, two lanes against the native heap Dijkstra (the
   field's largest, the start vertex's and the 99.9th-percentile relative
   error and the path cost against the native chain's, below 1%),
   SUCCESS where the oracle reaches the start. (b) The CLI (`python -m
   mesh_navigation_torch --mesh grid.ply --planner dijkstra --layers
   steepness,border --out DIR`) on the main path's terrain written as a
   PLY, as a subprocess: exit 0, SUCCESS, four exports; then the same PLY
   through read_map into a Dijkstra server and one banded get_path_batch
   of 128 lanes, whose banded_pass and class_pred launches are the
   kernels line's `scanned_map_launches`.
24. banded_walks (after phase 8): on banded_full's own field and int32
   id table (its warm-up draw, 128 lanes), extract_paths_vb over the
   lane-minor table gives the path's walk's vertex ids lane for lane, and
   descend_paths (the greedy descent of the [B, V] field, no table) walks
   within 1% of its length wherever both reach the goal (walk ms
   printed); then the row-scan solver ops/banded.batched_field_banded
   (plain torch, a loop over rows) on the main terrain with 16 lanes:
   rounds, ms, `converged`, two lanes against the native heap Dijkstra
   (<1%). A solve over 60 s moves to a 512 x 512 terrain and says so.
25. replan_window (after phase 10): the replan phase's server with
   make_replan_step("obst", warm_window=384) and the same step without the
   window, in turns on the same jump / drift / clear clouds, for the
   replan draw's 128 lanes and its first 8: per pattern and cohort the ms
   an update with the window on and off, the share of steps where it fit,
   its slab rounds, seam aborts and slabs that certified alone, and the
   banded_pass and check launches. Gates: every step converged and against
   a cold solve (<1%), two lanes of each cohort's last windowed field
   against the native heap Dijkstra (<1%).
26. cvp_hybrid (after phase 13): the CVP phase's plan, warm-up draw and
   128 lanes; eikonal_solve_padded with and without graph_plan (the CVP
   planner's Dijkstra warm plan), cold at orderings 4 and in the planner's
   own setting (its warm start, orderings 2): rounds, ms, eik_pass and
   banded_pass launches of each. Gates: converged, and each hybrid field
   by cvp_oracle_gate (two lanes, 1%).
27. sharded (after phase 19): mesh_navigation_torch/parallel on
   torch.distributed. The main terrain's plan (atol = rtol = 0, the
   reference's default) and the irregular phase's plan (its tolerance),
   128 lanes from the seed each, cut into 4 row shards (G ghost rows a
   side: 1 on the grid, 4 on the irregular plan, whose far residuals ride
   an all-reduced table). 4 ranks are spawned with gloo, all on this card
   (each rank's shard and its pass launches on the card, the exchange
   staged through pinned host buffers); where the machine has 4 cards,
   again with NCCL, one rank a card. Each rank runs the gather tiers at
   the reference dry run's 320 x 320 (parallel/dryrun.dryrun_multichip:
   layers, partitioned_field_solve on a (2, 2) grid, one controller
   cycle, the banded solve on row shards of that terrain's plan and of a
   96 x 96 irregular plan, each against the native heap Dijkstra within
   1e-3; then sharded_field_solve on a (2, 2) grid, the same gate), then
   both 1M sharded solves, rank 0 holding its first forced down pass
   against the plain pass on the same shard input (bit for bit, dirty
   tables and flags equal). Gates: every rank exits 0; converged; the
   grid's reachability that of the single-device solve at the same
   tolerance and its fields within 1e-4 relative; two lanes (grid) and
   eight (irregular) below 1% of the native heap Dijkstra. Printed per
   backend: ranks, cards, rounds against the single-device solve's, ms a
   round, bytes a rank sends a round, peak memory a rank, G, the usable
   near residuals a shard and the far table's size.
28. solve_modes (after phase 19): the solvers' opt-in options at full
   width. The main pipeline of phase 3 (its draw, 1,024 lanes) with
   dtype=bfloat16 (the controller at tol 1e-2) and with scan_steps=5 in
   f32, one warm-up and one timed iteration each: solves/s, stages,
   rounds, `converged`, pass launches; two lanes against the native heap
   Dijkstra, gated at 1% at partial depth and printed, not gated, in
   bfloat16 (the reference's bf16 fields err by up to 63% at 1M), whose
   gates are no NaN and the f32 field's finite support. The exact modes
   on the grid with 128 lanes (converge "round") at the main path's
   tolerance: the default and skip_rows=False (within twice the stopping
   tolerance of the default), each 1% on 2 lanes; scan_dirs="up" and
   scan_steps=5 read there (they drop sub-tolerance gains and can stop
   several tolerances above the fixed point, as the reference's do) and
   gated at 1% again at atol = rtol = 1e-5. four_dir on the irregular plan, 128
   lanes: transpose_banded_plan (timed; its lanes and those it leaves
   out), two-direction and four-direction rounds, ms and the transposes'
   ms, each 1% on 2 lanes. The structured tier in bfloat16, 128 lanes:
   sweeps, ms, solves/s beside phase 14's, its oracle reading. Then each
   new kernel mode held against its plain version bit for bit on the
   phase's own inputs (the pass on 48-row slabs of a bf16 main-mode, a
   bf16 dirty-mode, a partial-depth, a deferring, an unskipped and a
   transposed-field launch; class_pred and check on the bf16 main field;
   the bf16 fused sweep on the structured matrix), each timed against its
   bound; the phase's wall time.
Then a line with the script's total wall time.

Kernel launches are counted per path: the counts are set to 0 just before
the main path, the banded_full path, the replan path, the windowed replan
steps, the CVP path, the hybrid CVP solves, the structured path, the
irregular path, the server_cvp path, the server_single path, the
server_layers path (from its first batch GetPath), the scanned_map
phase's banded batch, the solve_modes phase's drives and, in each rank,
each of the sharded phase's 1M solves, and read just after each; launches made to hold a kernel against
its plain version, the gates' own solves, and the windowless steps and
plain solves the new paths are compared with, are not counted. The
kernels line's `banded_pass` and `check` carry `replan_window_launches`,
`banded_pass` and `eik_pass` carry `cvp_hybrid_launches`, and
`banded_pass` carries `sharded_launches` (the gloo run's, summed over
its ranks); `banded_pass`, `class_pred`, `check` and `fused_sweep` carry
`solve_modes` (each new mode's ms, bound, plain ms where timed and
max_abs_err, and the phase's launches by mode).

The line before the last is `nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`; the last is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failed check raises, and the script exits non-zero.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
F32_OPS_PER_S = 67e12       # H100 SXM f32 outside the tensor cores
MESH_N = 1024
BATCH = 1024
ITERS = 3
ATOL, RTOL = 1e-4, 2e-3     # the headline stopping tolerance (bench.py:276-278)
SEED = 0
# operations per field element, counted from the kernels' sources
PASS_OPS = 14   # 3 add + 3 min (cross), 1 min, flag mul+add+cmp, 2 x (add+min) scans
PRED_OPS = 26   # 8 x (add+cmp+select), has: mul+add+3 cmp, flag: mul+add+cmp
CHECK_OPS = 19  # 8 add + 7 min (best), flag: mul+add+cmp, or
# the walk's dependent loads, assumed floors (not readings): one that
# misses to device memory, and one that hits the SM's L1 (~30 cycles)
WALK_MISS_S = 0.4e-6
WALK_HIT_S = 15e-9
WALK_LINE_LANES = 128       # the lanes of one 128-byte line of the int8 class table
REPLAN_BATCH = 128          # lanes per update (bench.py:395)
# the kernels each path runs; each must launch at least once on its path
MAIN_PATH_KERNELS = ("banded_pass", "class_pred", "walk")
REPLAN_KERNELS = ("banded_pass", "banded_pass_dirty", "check")
CVP_KERNELS = ("banded_pass", "eik_pass")
CVP_BATCH = 128             # lanes per solve (bench.py:457-460)
CVP_ATOL, CVP_RTOL = 1e-4, 1e-3   # the CVP solve's stopping tolerance (planners/cvp.py)
# operations of one unfold() in csrc/eik_pass.cu as written (compares,
# selects, clamps, 3 divisions, 2 square roots) and its min into the best
# value, per class and element; of side_terms() (2 divisions, 1 square
# root), per class and column of a lane block; per element the imp and lt
# flags
EIK_UNFOLD_OPS = 53
EIK_SIDE_OPS = 39
EIK_ELEM_OPS = 6
EIK_NARROW_WIDTH = 4        # the narrow strip width held against the plain pass
EIK_TUNE_WIDTHS = (4, 8, 16)  # strip widths timed on the CVP path's first forced pass
EIK_SLAB_ROWS = 4   # rows of a CVP-path pass's own input held against the plain pass
STRUCTURED_KERNELS = ("fused_sweep",)
FULL_PATH_KERNELS = ("banded_pass", "class_pred_ids")
FULL_BATCH = 128            # lanes per banded_full solve
WIDE_PASS_COLS = (1500, 3000)   # row widths past 1,024 held against the plain pass
STRUCTURED_BATCH = 128      # lanes per structured solve
STRUCTURED_WAVE_SWEEPS = 64  # sweeps of the path's own solve before the full-shape check
IRREGULAR_BATCH = 512       # lanes per irregular solve (bench.py:580-582)
IRREGULAR_ATOL, IRREGULAR_RTOL = 1e-3, 2e-3   # the irregular stage's tolerance (bench.py:583-584)
IRREGULAR_KERNELS = ("banded_pass", "banded_pass_dirty", "class_pred", "walk")
IRREGULAR_ORACLE_LANES = 8  # lanes held against the native heap Dijkstra (bench.py:588-594)
IRREGULAR_SLAB_ROWS = 48    # rows of an irregular-path pass's own input held against the plain pass
XLANE_OPS = 2               # an extended lane's edge: one add and one min a batch lane


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def time_ms(fn, device, reps: int = 1, setup=None) -> float:
    """Mean time of fn() over reps; device time by CUDA events on a card,
    `setup()` (outside the timed region) before each repetition."""
    import torch

    total = 0.0
    for _ in range(reps):
        if setup is not None:
            setup()
        if torch.device(device).type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            total += a.elapsed_time(b)
        else:
            t0 = time.perf_counter()
            fn()
            total += (time.perf_counter() - t0) * 1e3
    return total / reps


def xlist_size(xlist, Cp: int) -> tuple[int, int]:
    """(bytes, edges) of an extended-lane list (banded_gpu.XLaneList) of
    rows of Cp columns a pass reads: its row headers and its rows' entries
    (meta and weight); (0, 0) for None. One host read."""
    if xlist is None:
        return 0, 0
    edges = int(xlist.row_counts(Cp).sum())
    return xlist.goff.numel() * 4 + edges * 8, edges


class kernel_trace:
    """Inside the block, torch.profiler traces the card's kernels:
    `events` then holds (start_ns, end_ns, name) of each, in start order.
    Empty on the CPU, or where the trace shows no device time."""

    def __init__(self, device):
        import torch

        self.cuda = torch.device(device).type == "cuda"
        self.device, self.events, self.prof = device, [], None

    def __enter__(self):
        if self.cuda:
            from torch.profiler import ProfilerActivity, profile

            sync(self.device)
            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self.prof is not None:
            from torch.autograd import DeviceType

            sync(self.device)
            self.prof.__exit__(*exc)
            self.events = sorted((e.start_ns(), e.end_ns(), e.name())
                                 for e in self.prof.profiler.kineto_results.events()
                                 if e.device_type() == DeviceType.CUDA)
        return False

    def ms(self, part: str) -> list:
        """Device ms of each traced kernel whose name holds `part`, in order."""
        return [(b - a) / 1e6 for a, b, name in self.events if part in name]


def device_busy(fn, device) -> dict:
    """Run fn() once under torch.profiler tracing the card's activity, and
    read the kernels' intervals from the raw trace events (no event tree is
    built, so a run of some 10^6 launches stays cheap to read): the
    device's busy time is the union of the intervals, its idle share the
    rest of the host's wall time (which the tracing's own cost lengthens).
    On the CPU the trace holds no kernel and the share is None."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    sync(device)
    with profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        fn()
        sync(device)
        wall_ns = (time.perf_counter() - t0) * 1e9
    kern = [(e.start_ns(), e.end_ns(), e.name()) for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA]
    busy, end = 0, float("-inf")
    for a, b, _ in sorted(kern):
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name: dict[str, float] = {}
    for a, b, name in kern:
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"traced_wall_ms": wall_ns / 1e6, "device_busy_ms": busy / 1e6,
            "kernels_traced": len(kern),
            "idle_share": 1.0 - busy / wall_ns if kern else None,
            "top_kernels_ms": {k[:60]: v for k, v in top}}


def steepness_weights(mesh, cost_limit: float = 2.0):
    """Steepness costs of a mesh (the steepness layer) and their slot
    weights for the banded plan: (costs_np, costs, W)."""
    from mesh_navigation_torch.config import LayerConfig
    from mesh_navigation_torch.layers.local import make_steepness
    from mesh_navigation_torch.ops import sweeps

    steep = make_steepness(LayerConfig(name="steep", kind="steepness", params=(("threshold", 2.0),)))
    costs = steep(mesh, {}, {}).costs
    costs_np = costs.cpu().numpy()
    W = sweeps.slot_weights_np(mesh, costs_np, cost_limit=cost_limit, edge_cost_factor=1.0)
    return costs_np, costs, W


def steepness_setup(mesh_n, device, cost_limit: float = 2.0):
    """Terrain (mesh_n x mesh_n, or the (nx, ny) of a pair) -> mesh ->
    steepness costs (the steepness layer) -> slot weights for the banded
    plan."""
    from mesh_navigation_torch.mesh import synthetic
    from mesh_navigation_torch.mesh.arrays import build_mesh

    nx, ny = mesh_n if isinstance(mesh_n, tuple) else (mesh_n, mesh_n)
    v, f = synthetic.terrain_mesh(nx, ny, spacing=0.5, hills=2.0, roughness=0.01, seed=0)
    mesh = build_mesh(v, f, device=device)
    costs_np, costs, W = steepness_weights(mesh, cost_limit)
    return v, f, mesh, costs_np, costs, W


def sample_scenarios(rng, mesh_n: int, batch: int):
    """Start/goal positions over the terrain's extent (bench.py:159-166)."""
    extent = mesh_n * 0.5 - 1.0
    s = rng.uniform(1, extent, size=(batch, 3)).astype(np.float32)
    g = rng.uniform(1, extent, size=(batch, 3)).astype(np.float32)
    s[:, 2] = 0.0
    g[:, 2] = 0.0
    q = np.tile(np.asarray([0, 0, 0, 1], np.float32), (batch, 1))
    return s, g, q


def compare_fields(kern, plain, atol, rtol) -> dict:
    import torch

    fin_k, fin_p = torch.isfinite(kern), torch.isfinite(plain)
    same_support = bool(torch.equal(fin_k, fin_p))
    diff = torch.where(fin_p, (kern - plain).abs(), torch.zeros_like(plain))
    bound = atol + rtol * torch.where(fin_p, plain.abs(), torch.zeros_like(plain))
    rel = diff / torch.clamp(torch.where(fin_p, plain.abs(), torch.ones_like(plain)), min=1e-6)
    return {
        "bitwise": bool(torch.equal(kern, plain)),
        "same_finite_support": same_support,
        "max_abs_err": float(diff.max()),
        "max_rel_err": float(rel.max()),
        "within_tol": same_support and bool((diff <= bound).all()),
        "tol": f"|kernel - plain| <= {atol} + {rtol} * |plain|",
    }


def check_pass_pair(prob, device, atol, rtol) -> dict:
    """Forced down pass then up pass, kernel vs plain, from prob.d0: fields
    bit for bit (the plain pass sums in the kernel's order), flags equal."""
    from mesh_navigation_torch.ops import banded_gpu as bg

    d_k = prob.d0.clone()
    d_p = prob.d0.clone()
    out = {}
    for name, reverse, force, cross in (
        ("down", False, True, prob.down), ("up", True, False, prob.up),
    ):
        chg_k = bg.directional_pass(d_k, cross, prob.a_fwd, prob.a_bwd, reverse=reverse,
                                    atol=atol, rtol=rtol, force=force)
        chg_p = bg.directional_pass_plain(d_p, cross, prob.a_fwd, prob.a_bwd, reverse=reverse,
                                          bb=prob.bb, atol=atol, rtol=rtol, force=force)
        cmp = compare_fields(d_k, d_p, atol, rtol)
        cmp["flags_equal"] = bool(chg_k.item()) == bool(chg_p.item())
        out[name] = cmp
        if not (cmp["bitwise"] and cmp["flags_equal"]):
            raise AssertionError(f"pass kernel disagrees with its plain version: {name} {cmp}")
    del d_k, d_p
    return out


def check_pred_pair(plan, d_pad, atol, rtol, tol=None) -> dict:
    """Class-pred kernel vs plain on one field, in both modes (int8 classes,
    int32 real ids), each with and without the certificate: identical
    tables, equal flags. max_abs_err is the largest table difference over
    all four (0 when they are identical)."""
    import torch
    from mesh_navigation_torch.ops import banded_gpu as bg

    w8 = bg._w8_planes(plan, d_pad.shape[0])
    kw = dict(R=plan.n_rows, C=plan.n_cols, V=plan.num_vertices,
              tol=max(atol, 3.0 * rtol) if tol is None else tol)
    modes, flags = {}, []
    for as_class, mode in ((True, "classes"), (False, "ids")):
        for check in (None, (atol, rtol)):
            tk, fk = bg.class_pred(d_pad, w8, **kw, check=check, as_class=as_class)
            tp, fp = bg.class_pred_plain(d_pad, w8, **kw, check=check, as_class=as_class)
            bad = tk != tp
            n_bad = int(bad.sum())
            r = {"identical": n_bad == 0, "n_mismatch": n_bad,
                 "max_abs_err": int((tk[bad].long() - tp[bad].long()).abs().max()) if n_bad else 0}
            if check is not None:
                r["flags_equal"] = bool(fk.any()) == bool(fp)
                flags.append(bool(fp))
            modes[mode + ("_check" if check is not None else "")] = r
            del tk, tp, bad
    res = {
        "modes": modes,
        "tables_identical": all(m["identical"] for m in modes.values()),
        "flags_equal": all(m.get("flags_equal", True) for m in modes.values())
        and len(set(flags)) == 1,
        "max_abs_err": max(m["max_abs_err"] for m in modes.values()),
        "violation": flags[0],
    }
    if not (res["tables_identical"] and res["flags_equal"]):
        raise AssertionError(f"pred kernel disagrees with its plain version: {res}")
    return res


class uncounted:
    """Launches inside this block (kernel-vs-plain comparisons, gates) leave
    the path's launch counts as they were."""

    def __enter__(self):
        from mesh_navigation_torch.ops import kernels

        self.saved = dict(kernels.LAUNCHES)

    def __exit__(self, *exc):
        from mesh_navigation_torch.ops import kernels

        kernels.LAUNCHES.update(self.saved)
        return False


def check_flag_pair(d, w8, atol, rtol) -> dict:
    """Check kernel vs plain on one field: the violation flags must agree
    (abs_err, the difference of the two flags as 0/1, must be 0)."""
    from mesh_navigation_torch.ops import banded_gpu as bg

    k = int(bg.check(d, w8, atol=atol, rtol=rtol).item() != 0)
    p = int(bool(bg.check_plain(d, w8, atol=atol, rtol=rtol)))
    if k != p:
        raise AssertionError(f"check kernel disagrees with its plain version: {k} vs {p}")
    return {"violation": bool(p), "abs_err": abs(k - p)}


def check_cases(d, plan, atol, rtol) -> dict:
    """The check kernel on a converged field, and on it with one element
    lowered and one raised: the flag must flip to a violation."""
    import torch
    from mesh_navigation_torch.ops import banded_gpu as bg

    w8 = bg._w8_planes(plan, d.shape[0])
    out = {"converged": check_flag_pair(d, w8, atol, rtol)}
    fin = torch.nonzero(torch.isfinite(d[: plan.n_rows, : plan.n_cols, :1]))
    r, c, b = fin[len(fin) // 2].tolist()
    for name, new in (("lowered", torch.clamp(d[r, c, b] - 1.0, min=0.0) * 0.5),
                      ("raised", d[r, c, b] * 1.5 + 1.0)):
        old = d[r, c, b].clone()
        d[r, c, b] = new
        out[name] = check_flag_pair(d, w8, atol, rtol)
        d[r, c, b] = old
    if out["converged"]["violation"] or not (out["lowered"]["violation"]
                                             and out["raised"]["violation"]):
        raise AssertionError(f"check flags do not flip as they should: {out}")
    return out


def warm_inputs(plan, mesh, costs, seeds, raise_rows, raise_cols, atol, rtol):
    """A converged field on `costs`, then new costs with a raised patch:
    the warm resolve's first-pass inputs (pallas_banded.py:1686-1789)."""
    import torch
    from mesh_navigation_torch.ops import banded_gpu as bg

    C = plan.n_cols
    new = costs.clone()
    for r in raise_rows:
        new[r * C + raise_cols] = torch.inf
    kw = dict(edge_cost_factor=1.0, cost_limit=2.0)
    plan0 = bg.refresh_banded_planes_from_costs(plan, costs, **kw)
    plan1 = bg.refresh_banded_planes_from_costs(plan, new, **kw)
    d_prev = bg.banded_solve_padded(plan0, seeds, atol=atol, rtol=rtol).d_pad
    changed = bg.changed_plane_from_costs(plan, costs, new)
    raised = bg.raised_plane_from_costs(plan, costs, new)
    return plan1, d_prev, changed, raised, bg.position_planes(plan, mesh)


def check_warm_pass_pair(plan1, seeds, d_prev, changed, raised, pos, atol, rtol) -> dict:
    """The pass kernel in its warm modes against its plain version: the cut
    + dirty down pass, then the dirty up pass, from the same inputs: fields
    bit for bit, dirty tables, flags and rows walked equal."""
    import torch
    from mesh_navigation_torch.ops import banded_gpu as bg

    Rp = d_prev.shape[0]
    d_k, dirty_k, cut = bg._warm_start(plan1, seeds, d_prev, changed, raised, pos,
                                       Rp=Rp, bb=bg.PASS_LANES, atol=atol, rtol=rtol)
    d_p, dirty_p = d_k.clone(), dirty_k.clone()
    prob = bg.prepare_padded(plan1, seeds, seeded=False)
    out = {}
    for name, reverse, cross, wc in (("down_cut", False, prob.down, cut),
                                     ("up", True, prob.up, None)):
        wk = torch.zeros(1, dtype=torch.int32, device=d_k.device)
        wp = torch.zeros(1, dtype=torch.int64, device=d_k.device)
        ck = bg.directional_pass(d_k, cross, prob.a_fwd, prob.a_bwd, reverse=reverse,
                                 atol=atol, rtol=rtol, dirty=dirty_k, warm_cut=wc,
                                 rows_walked=wk)
        cp = bg.directional_pass_plain(d_p, cross, prob.a_fwd, prob.a_bwd, reverse=reverse,
                                       bb=prob.bb, atol=atol, rtol=rtol, dirty=dirty_p,
                                       warm_cut=wc, rows_walked=wp)
        cmp = compare_fields(d_k, d_p, atol, rtol)
        cmp["flags_equal"] = bool(ck.item()) == bool(cp.item())
        cmp["dirty_equal"] = bool((dirty_k == dirty_p).all())
        cmp["dirty_rows"] = int(dirty_p.sum())
        cmp["rows_walked"] = int(wk.item())
        cmp["rows_walked_equal"] = int(wk.item()) == int(wp.item())
        out[name] = cmp
        if not (cmp["bitwise"] and cmp["flags_equal"] and cmp["dirty_equal"]
                and cmp["rows_walked_equal"]):
            raise AssertionError(f"warm pass kernel disagrees with its plain version: {name} {cmp}")
        d_k.copy_(d_p)
    return out


def kernel_check(device, mesh_n: int = 128, batch: int = 64) -> dict:
    """Phase 2: every kernel against its plain version at a small size."""
    import torch
    from mesh_navigation_torch.ops import banded_gpu as bg

    _, _, mesh, _, costs, W = steepness_setup(mesh_n, device)
    plan = bg.build_banded_kernel_plan(mesh, W)
    rng = np.random.default_rng(SEED + 1)
    seeds = torch.from_numpy(rng.integers(0, mesh.num_vertices, batch)).to(device)
    prob = bg.prepare_padded(plan, seeds)
    passes = check_pass_pair(prob, device, ATOL, RTOL)
    one = bg.banded_solve_padded(plan, seeds, atol=ATOL, rtol=RTOL, max_rounds=1)
    pred_partial = check_pred_pair(plan, one.d_pad, ATOL, RTOL)
    full = bg.banded_solve_padded(plan, seeds, atol=ATOL, rtol=RTOL, converge="pred")
    pred_conv = check_pred_pair(plan, full.d_pad, ATOL, RTOL)
    if not full.converged or pred_conv["violation"]:
        raise AssertionError("small solve did not converge")
    checks = check_cases(full.d_pad, plan, ATOL, RTOL)
    mid = mesh_n // 2
    plan1, *inputs = warm_inputs(plan, mesh, costs, seeds, range(mid - 2, mid + 3),
                                 torch.arange(mid - 2, mid + 3, device=device), ATOL, RTOL)
    warm = check_warm_pass_pair(plan1, seeds, *inputs, ATOL, RTOL)
    wide = {ny: wide_pass_check(device, ny) for ny in WIDE_PASS_COLS}
    return {"phase": "kernel_check", "mesh": f"{mesh_n}x{mesh_n}", "lanes": batch,
            "pass": passes, "pred_after_one_round": pred_partial,
            "pred_converged": pred_conv, "rounds": full.rounds, "check": checks,
            "warm_pass": warm, "wide_pass": wide}


def wide_pass_check(device, ny: int, nx: int = 8, batch: int = 16) -> dict:
    """The pass kernel on rows past 1,024 columns (an nx x ny terrain): the
    main mode's forced down and up pass, then a warm resolve's cut and dirty
    passes from a raised patch, each against the plain version bit for bit."""
    import torch
    from mesh_navigation_torch.ops import banded_gpu as bg

    _, _, mesh, _, costs, W = steepness_setup((nx, ny), device)
    plan = bg.build_banded_kernel_plan(mesh, W)
    rng = np.random.default_rng(SEED + ny)
    seeds = torch.from_numpy(rng.integers(0, mesh.num_vertices, batch)).to(device)
    passes = check_pass_pair(bg.prepare_padded(plan, seeds), device, ATOL, RTOL)
    plan1, *inputs = warm_inputs(plan, mesh, costs, seeds, range(nx // 2 - 1, nx // 2 + 1),
                                 torch.arange(ny // 3, ny // 3 + 40, device=device), ATOL, RTOL)
    warm = check_warm_pass_pair(plan1, seeds, *inputs, ATOL, RTOL)
    return {"field": [plan.n_rows, plan.n_cols_pad, batch],
            "cols_per_thread": bg.pass_cols_per_thread(plan.n_cols_pad),
            "pass": passes, "warm_pass": warm,
            "max_abs_err": max(c["max_abs_err"] for c in (*passes.values(), *warm.values()))}


def main_path(device, mesh_n: int, batch: int, iters: int) -> dict:
    """Phase 3: the headline pipeline through the port's entry points."""
    import torch
    from mesh_navigation_torch.config import ControllerConfig, PlannerConfig
    from mesh_navigation_torch.control import MeshController
    from mesh_navigation_torch.control.controller import initial_state
    from mesh_navigation_torch.ops import kernels
    from mesh_navigation_torch.planners import DijkstraPlanner
    from mesh_navigation_torch.utils.timing import StageTimer

    t0 = time.perf_counter()
    v, f, mesh, costs_np, costs, W = steepness_setup(mesh_n, device)
    t_mesh = time.perf_counter() - t0
    planner = DijkstraPlanner(
        mesh, PlannerConfig(cost_limit=2.0), max_path_len=max(2048, 3 * mesh_n),
        device=device,
    )
    ctrl = MeshController(mesh, ControllerConfig(), grid=planner.grid, device=device)
    kplan = planner.prepare_banded_plan(W)
    if kplan is None:
        raise RuntimeError("no banded plan for the terrain mesh")
    sync(device)
    t_setup = time.perf_counter() - t0
    log(f"# main path set-up {t_setup:.1f} s (mesh {t_mesh:.1f} s), coverage {kplan.coverage}")
    rng = np.random.default_rng(SEED)

    def step(s, g, q, timer=None):
        st = initial_state(torch.from_numpy(g).to(device), torch.tensor([1.0, 0.0, 0.0]))
        res = planner.plan_batch_banded(
            kplan, torch.from_numpy(s), torch.from_numpy(g), atol=ATOL, rtol=RTOL, timer=timer,
        )
        cmds, _ = ctrl.compute_velocity_banded(
            kplan, res.d_pad.reshape(-1, res.d_pad.shape[-1]), costs,
            torch.from_numpy(s), torch.from_numpy(q), st, tol=1e-5,
            lane_map=res.lane_map, timer=timer,
        )
        return res, cmds

    kernels.reset_launches()
    warm = sample_scenarios(rng, mesh_n, batch)
    tw = time.perf_counter()
    res, cmds = step(*warm)
    sync(device)
    t_warm = time.perf_counter() - tw
    warm_res = res
    timer = StageTimer(device)
    rounds = []
    t1 = time.perf_counter()
    for _ in range(iters):
        res = cmds = None
        res, cmds = step(*sample_scenarios(rng, mesh_n, batch), timer=timer)
        rounds.append(res.rounds)
    sync(device)
    dt = time.perf_counter() - t1
    launches = {name: kernels.LAUNCHES[name] for name in MAIN_PATH_KERNELS}
    for name, n in launches.items():
        if n <= 0 and torch.device(device).type == "cuda":
            raise AssertionError(f"kernel {name} was not launched on the main path")
    # the outputs are sane: shapes, finite costs where a path exists, codes
    B = batch
    ok_lanes = res.outcome == 0
    checks = {
        "shapes": list(res.path_positions.shape) == [B, planner.max_path_len, 3]
        and list(cmds.linear.shape) == [B],
        "converged": bool(res.converged),
        "reach_rate": float(ok_lanes.float().mean()),
        "costs_finite_where_reached": bool(torch.isfinite(res.cost[ok_lanes]).all()),
        "commands_finite": bool(torch.isfinite(cmds.linear).all() and torch.isfinite(cmds.angular).all()),
        "control_success_rate": float((cmds.outcome == 0).float().mean()),
    }
    if not (checks["shapes"] and checks["converged"] and checks["costs_finite_where_reached"]
            and checks["commands_finite"] and checks["reach_rate"] > 0.5):
        raise AssertionError(f"main path output check failed: {checks}")
    stages = {k: v / iters for k, v in timer.totals().items()}
    trace = device_busy(lambda: step(*sample_scenarios(rng, mesh_n, batch)), device)
    out = {
        "phase": "main_path", "mesh": f"{mesh_n}x{mesh_n}", "V": mesh.num_vertices,
        "lanes": B, "dtype": "float32", "atol": ATOL, "rtol": RTOL,
        "setup_s": t_setup, "warmup_s": t_warm, "iters": iters,
        "solves_per_s": B * iters / dt, "ms_per_iter": dt * 1e3 / iters,
        "rounds": rounds, "stage_ms_per_iter": stages,
        "launches": launches, "launches_per_iter": {k: n / (iters + 1) for k, n in launches.items()},
        "checks": checks, "trace": trace,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9 if torch.device(device).type == "cuda" else None,
    }
    return out, dict(v=v, f=f, mesh=mesh, costs_np=costs_np, kplan=kplan, planner=planner,
                     warm=warm, warm_res=warm_res, res=res, rounds=rounds)


def native_fields(v, f, costs_np, sources, cost_limit: float = 2.0) -> list:
    """(dist, pred) of the native heap Dijkstra from each source vertex,
    over edge weights dist * (1 + (c1 + c2) / 2) (edge_cost_factor 1.0)."""
    from mesh_navigation_torch.native import NativeMesh

    nm = NativeMesh(v, f)
    try:
        edges = nm.tables()["edges"]
        dist = np.linalg.norm(v[edges[:, 1]] - v[edges[:, 0]], axis=1).astype(np.float32)
        c1, c2 = costs_np[edges[:, 0]], costs_np[edges[:, 1]]
        ew = np.where(np.isfinite(c1) & np.isfinite(c2),
                      dist + dist * (c1 + c2) * 0.5, np.inf).astype(np.float32)
        return [nm.dijkstra(ew, costs_np, int(s), cost_limit) for s in sources]
    finally:
        nm.close()


def percentile_rel_err(got, ref) -> float:
    """99.9th percentile of |got - ref| / max(ref, 1e-3) where ref is finite
    (bench.py:169-204)."""
    fin = np.isfinite(ref)
    return float(np.percentile(np.abs(got[fin] - ref[fin]) / np.maximum(ref[fin], 1e-3), 99.9))


def oracle_gate(ctx, n_lanes: int = 2, phase: str = "oracle") -> dict:
    """Phase 4: path-cost parity against the native heap Dijkstra
    (bench.py:169-204), gated at 1%: the larger of the start vertex's
    relative error and the field's 99.9th-percentile one, over the first
    n_lanes lanes of the warm-up draw."""
    import torch
    from mesh_navigation_torch.mesh import query
    from mesh_navigation_torch.planners.dijkstra import potential_lanes

    planner, kplan, mesh = ctx["planner"], ctx["kplan"], ctx["mesh"]
    s, g, _ = ctx["warm"]
    dev = planner.device
    sv = query.nearest_vertex_batch(mesh, planner.grid, torch.from_numpy(s[:n_lanes]).to(dev))[0].cpu().numpy()
    gv = query.nearest_vertex_batch(mesh, planner.grid, torch.from_numpy(g[:n_lanes]).to(dev))[0].cpu().numpy()
    res = ctx["warm_res"]
    pot = potential_lanes(kplan, res.d_pad, res.lane_map, list(range(n_lanes)))
    errs = []
    fields = native_fields(ctx["v"], ctx["f"], ctx["costs_np"], gv[:n_lanes])
    for b, (od, _) in enumerate(fields):
        ref, got = od[sv[b]], pot[b, sv[b]]
        if np.isfinite(ref) and ref > 0:
            errs.append(abs(got - ref) / ref)
        errs.append(percentile_rel_err(pot[b], od))
    err = float(np.max(errs))
    if not err < 0.01:
        raise AssertionError(f"{phase} parity {err:.3e} exceeds the 1% budget")
    return {"phase": phase, "lanes": n_lanes, "max_rel_err": err, "budget": 0.01}


def walk_check(planner, kplan, s, g, atol: float, rtol: float, device) -> dict:
    """The walk kernel against its plain loop on the inputs of the walk of
    one more planner.plan_batch_banded(light=True) call on (s, g): the class
    table the call built (with its residual tables on an irregular plan),
    its grouped starts and goals, its max_len. Two launches back to back and
    the plain loop (ops/banded_gpu.extract_paths_cls_plain): path and valid
    equal (torch.equal), else it raises. The kernel's ms (CUDA events, five
    launches after one), the loop's (one run) and the bound: the longer of
    the slowest lane's chain of dependent loads and the bytes. A lane loads
    a class at each step that leaves a vertex other than its goal, and two
    more at a class-9 step (the choice, then the jump). A class load is a
    first touch where no lane of its 128-lane line of the table read that
    vertex at an earlier step: it costs WALK_MISS_S, every other load
    WALK_HIT_S. The bytes: path and valid written, and a 32-byte sector
    read a first touch, at HBM_BYTES_PER_S. Not counted for the path."""
    import torch
    from mesh_navigation_torch.ops import banded_gpu as bg

    cap = {}
    orig = bg.extract_paths_cls

    def grab(*a, **kw):
        cap["a"], cap["kw"] = a, {k: v for k, v in kw.items() if k != "timer"}
        return orig(*a, **kw)

    bg.extract_paths_cls = grab
    try:
        with uncounted():
            planner.plan_batch_banded(kplan, torch.from_numpy(s), torch.from_numpy(g),
                                      atol=atol, rtol=rtol)
    finally:
        bg.extract_paths_cls = orig
    a, kw = cap["a"], cap["kw"]
    cls, start_v, goal_v, max_len, _ = a
    residual = kw.get("res_row_map") is not None
    with uncounted():
        path, valid = bg.extract_paths_cls(*a, **kw)
        again = bg.extract_paths_cls(*a, **kw)
        time_ms(lambda: bg.extract_paths_cls(*a, **kw), device)          # warm
        ms = time_ms(lambda: bg.extract_paths_cls(*a, **kw), device, reps=5)
        got = []
        plain_ms = time_ms(lambda: got.append(bg.extract_paths_cls_plain(*a, **kw)), device)
    checks = {"path_equal": torch.equal(path, got[0][0]),
              "valid_equal": torch.equal(valid, got[0][1]),
              "launches_agree": torch.equal(path, again[0]) and torch.equal(valid, again[1])}
    if not all(checks.values()):
        raise AssertionError(f"the walk kernel differs from its plain loop: {checks}")
    del again, got
    B, dev = start_v.shape[0], path.device
    lanes = torch.arange(B, device=dev)[:, None]
    loads = valid & (path != goal_v.to(torch.int64)[:, None])       # steps that read a class
    class9 = loads & (cls[path, lanes] == 9) if residual else torch.zeros_like(loads)
    # first touches: the earliest step at which a (line, vertex) is read
    step = torch.arange(max_len, device=dev).expand(B, max_len)[loads]
    key = ((lanes // WALK_LINE_LANES) * cls.shape[0] + path)[loads]
    _, inv = torch.unique(key, return_inverse=True)
    first = torch.full((int(inv.max()) + 1 if inv.numel() else 0,), max_len,
                       dtype=step.dtype, device=dev).scatter_reduce_(0, inv, step, "amin")
    miss = torch.zeros_like(loads)
    miss[loads] = step == first[inv]
    del step, key, inv, first
    n_miss = miss.sum(1)
    n_hit = loads.sum(1) - n_miss + 2 * class9.sum(1)
    chain_s = n_miss * WALK_MISS_S + n_hit * WALK_HIT_S
    slow = int(chain_s.argmax())
    written = max_len * B * (8 + 1)
    latency_s = float(chain_s[slow])
    bytes_s = (written + 32 * int(n_miss.sum())) / HBM_BYTES_PER_S
    return {"lanes": B, "max_len": max_len, "class_table": list(cls.shape),
            "residual": residual, "checks": checks, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(latency_s, bytes_s) * 1e3,
            "bound_by": "dependent loads" if latency_s >= bytes_s else "bytes",
            "longest_chain_loads": int((loads.sum(1) + 2 * class9.sum(1)).max()),
            "bound_lane_misses": int(n_miss[slow]), "bound_lane_hits": int(n_hit[slow]),
            "longest_lane_steps": int(valid.sum(1).max()),
            "first_touch_share": float(n_miss.sum()) / max(int(loads.sum()), 1),
            "class9_steps": int(class9.sum()), "lanes_cut": int(valid[:, -1].sum()),
            "bytes_written": written}


def kernels_at_main_shapes(ctx, device) -> tuple[dict, list]:
    """Phase 5: each kernel against its plain version on the main path's own
    inputs, with times and bounds. These launches are not counted for the
    main path (its counts were read already)."""
    import torch
    from mesh_navigation_torch.ops import banded_gpu as bg

    from mesh_navigation_torch.mesh import query

    kplan, planner = ctx["kplan"], ctx["planner"]
    _, g, _ = ctx["warm"]
    goal_v = query.nearest_vertex_batch(planner.mesh, planner.grid, torch.from_numpy(g).to(device))[0]
    order, _ = bg.group_lanes(goal_v, kplan.num_vertices)
    prob = bg.prepare_padded(kplan, goal_v[order])
    Rp, Cp, Bp = prob.d0.shape
    N = Rp * Cp * Bp

    pass_cmp = check_pass_pair(prob, device, ATOL, RTOL)
    # kernel time along a real solve: every pass of `rounds` rounds, each
    # launch timed by its own event pair. The bound of a pass counts what
    # this data needs: one read of the field and the planes it reads
    # (cross and level 0 of a_fwd / a_bwd), and one write of each element
    # the pass changed.
    work = prob.d0.clone()
    times, bounds_by_bytes = [], []
    n_rounds = max(ctx["rounds"])
    for r in range(n_rounds):
        for reverse, cross in ((False, prob.down), (True, prob.up)):
            before = work.clone()
            times.append(time_ms(
                lambda: bg.directional_pass(work, cross, prob.a_fwd, prob.a_bwd,
                                            reverse=reverse, atol=ATOL, rtol=RTOL,
                                            force=(r == 0 and not reverse)), device))
            n_written = int((work != before).sum())
            del before
            bounds_by_bytes.append((N + 5 * Rp * Cp + n_written) * 4 / HBM_BYTES_PER_S)
    pass_ms = float(np.mean(times))
    work.copy_(prob.d0)
    plain_pass_ms = time_ms(lambda: bg.directional_pass_plain(
        work, prob.down, prob.a_fwd, prob.a_bwd, reverse=False, bb=prob.bb,
        atol=ATOL, rtol=RTOL, force=True), device)
    del work
    pass_bytes_s = float(np.mean(bounds_by_bytes))
    pass_ops_s = PASS_OPS * N / F32_OPS_PER_S
    pass_bound = max(pass_bytes_s, pass_ops_s) * 1e3

    d_conv = ctx["res"].d_pad
    pred_cmp = check_pred_pair(kplan, d_conv, ATOL, RTOL)
    w8 = bg._w8_planes(kplan, Rp)
    kw = dict(R=kplan.n_rows, C=kplan.n_cols, V=kplan.num_vertices,
              tol=max(ATOL, 3.0 * RTOL), check=(ATOL, RTOL))
    ids_kw = dict(kw, check=None, as_class=False)

    def kernel_ms(**extra):
        time_ms(lambda: bg.class_pred(d_conv, w8, **extra), device)        # warm
        return time_ms(lambda: bg.class_pred(d_conv, w8, **extra), device, reps=5)

    pred_ms = kernel_ms(**kw)
    ids_ms = kernel_ms(**ids_kw)
    plain_pred_ms = time_ms(lambda: bg.class_pred_plain(d_conv, w8, **kw), device)
    V = kplan.num_vertices
    pred_bytes = N * 4 + V * Bp + 8 * Rp * Cp * 4
    ids_bytes = N * 4 + V * Bp * 4 + 8 * Rp * Cp * 4
    pred_bound = max(pred_bytes / HBM_BYTES_PER_S, PRED_OPS * N / F32_OPS_PER_S) * 1e3
    ids_bound = max(ids_bytes / HBM_BYTES_PER_S, PRED_OPS * N / F32_OPS_PER_S) * 1e3
    s, g, _ = ctx["warm"]
    walk = walk_check(planner, kplan, s, g, ATOL, RTOL, device)

    detail = {"phase": "kernels_at_main_shapes", "field": [Rp, Cp, Bp],
              "pass": pass_cmp, "pass_launch_ms": times,
              "pass_bound_ms": [b * 1e3 for b in bounds_by_bytes], "pred": pred_cmp,
              "pred_ms": pred_ms, "pred_ids_ms": ids_ms,
              "pred_bound_ms": pred_bound, "pred_ids_bound_ms": ids_bound, "walk": walk}
    launches = ctx["launches"]
    line = [
        {"name": "banded_pass", "route": "cuda",
         "source": "mesh_navigation_torch/csrc/banded_pass.cu",
         "replaces": "mesh_navigation_tpu/ops/pallas_banded.py:827",
         "launches": launches["banded_pass"],
         "max_abs_err": max(c["max_abs_err"] for c in pass_cmp.values()),
         "ms": pass_ms, "plain_ms": plain_pass_ms, "bound_ms": pass_bound,
         "bound_by": "bytes" if pass_bytes_s >= pass_ops_s else "operations",
         "library_ms": None},
        {"name": "class_pred", "route": "cuda",
         "source": "mesh_navigation_torch/csrc/class_pred.cu",
         "replaces": "mesh_navigation_tpu/ops/pallas_banded.py:2177",
         "launches": launches["class_pred"],
         "max_abs_err": float(pred_cmp["max_abs_err"]),
         "ms": pred_ms, "plain_ms": plain_pred_ms, "bound_ms": pred_bound,
         "bound_by": "bytes" if pred_bytes / HBM_BYTES_PER_S >= PRED_OPS * N / F32_OPS_PER_S
         else "operations",
         "library_ms": None, "ids_ms": ids_ms, "ids_bound_ms": ids_bound},
        {"name": "walk", "route": "cuda",
         "source": "mesh_navigation_torch/csrc/walk.cu",
         "replaces": None, "replaces_note": "no TPU kernel: the JAX package walks with a "
         "lax.scan (mesh_navigation_tpu/ops/pallas_banded.py:2644, XLA code)",
         "launches": launches["walk"], "max_abs_err": 0,
         "ms": walk["ms"], "plain_ms": walk["plain_ms"], "bound_ms": walk["bound_ms"],
         "bound_by": walk["bound_by"], "longest_chain_loads": walk["longest_chain_loads"],
         "first_touch_share": walk["first_touch_share"],
         "library_ms": None,
         "library_note": "no single PyTorch call walks a predecessor chain"},
    ]
    return detail, line


def banded_full(device, ctx, iters: int, batch: int = FULL_BATCH) -> tuple[dict, dict]:
    """Phase 6: the full banded plan result at full width on the main path's
    mesh, plan and costs: one warm-up and `iters` timed
    DijkstraPlanner.plan_batch_banded(light=False) calls with `batch` lanes
    (scenarios from the seed as on the main path), each followed by one
    MeshController.compute_velocity cycle on the result's vector map.
    Gates: converged on every solve, the pass and the id-mode class-pred
    kernels launched, sane outputs."""
    import torch
    from mesh_navigation_torch.config import ControllerConfig
    from mesh_navigation_torch.control import MeshController
    from mesh_navigation_torch.control.controller import initial_state
    from mesh_navigation_torch.ops import kernels
    from mesh_navigation_torch.utils.timing import StageTimer

    planner, kplan, mesh = ctx["planner"], ctx["kplan"], ctx["mesh"]
    mesh_n = int(round(np.sqrt(mesh.num_vertices)))
    V = mesh.num_vertices
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    costs = torch.from_numpy(ctx["costs_np"]).to(device)
    ctrl = MeshController(mesh, ControllerConfig(), grid=planner.grid, device=device)
    rng = np.random.default_rng(SEED + 6)

    def step(s, g, q, timer=None):
        res = planner.plan_batch_banded(kplan, torch.from_numpy(s), torch.from_numpy(g),
                                        light=False, atol=ATOL, rtol=RTOL, timer=timer)
        st = initial_state(torch.from_numpy(g).to(device), torch.tensor([1.0, 0.0, 0.0]))
        cmds, _ = ctrl.compute_velocity(res.vector_map, costs, torch.from_numpy(s),
                                        torch.from_numpy(q), st, timer=timer)
        return res, cmds

    kernels.reset_launches()
    warm = sample_scenarios(rng, mesh_n, batch)
    tw = time.perf_counter()
    res, cmds = step(*warm)
    sync(device)
    t_warm = time.perf_counter() - tw
    solves = [{"rounds": res.rounds, "converged": bool(res.converged)}]
    warm_small = {"potential": res.potential[:2].cpu().numpy(),
                  "pred": res.pred[:2].cpu().numpy(), "cost": res.cost[:2].cpu().numpy()}
    timer = StageTimer(device)
    t1 = time.perf_counter()
    for _ in range(iters):
        res = cmds = None
        res, cmds = step(*sample_scenarios(rng, mesh_n, batch), timer=timer)
        solves.append({"rounds": res.rounds, "converged": bool(res.converged)})
    sync(device)
    dt = time.perf_counter() - t1
    launches = {name: kernels.LAUNCHES[name] for name in FULL_PATH_KERNELS}
    for name, n in launches.items():
        if n <= 0 and cuda:
            raise AssertionError(f"kernel {name} was not launched on the banded_full path")
    if not all(x["converged"] for x in solves):
        raise AssertionError(f"a banded_full solve did not converge: {solves}")
    ok_lanes = res.outcome == 0
    checks = {
        "shapes": list(res.path_positions.shape) == [batch, planner.max_path_len, 3]
        and list(res.vector_map.shape) == [batch, V, 3] and list(res.pred.shape) == [batch, V]
        and list(res.potential.shape) == [batch, V] and list(cmds.linear.shape) == [batch],
        "pred_int32": res.pred.dtype == torch.int32,
        "reach_rate": float(ok_lanes.float().mean()),
        "costs_finite_where_reached": bool(torch.isfinite(res.cost[ok_lanes]).all()),
        "vector_map_finite": bool(torch.isfinite(res.vector_map).all()),
        "commands_finite": bool(torch.isfinite(cmds.linear).all()
                                and torch.isfinite(cmds.angular).all()),
        "control_success_rate": float((cmds.outcome == 0).float().mean()),
    }
    if not (checks["shapes"] and checks["pred_int32"] and checks["costs_finite_where_reached"]
            and checks["vector_map_finite"] and checks["commands_finite"]
            and checks["reach_rate"] > 0.5):
        raise AssertionError(f"banded_full output check failed: {checks}")
    stages = {k: val / iters for k, val in timer.totals().items()}
    peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
    res = cmds = None
    trace = device_busy(lambda: step(*sample_scenarios(rng, mesh_n, batch)), device)
    roll, d_full = full_result_roll(device, ctx, warm)
    out = {
        "phase": "banded_full", "mesh": f"{mesh_n}x{mesh_n}", "V": V, "lanes": batch,
        "dtype": "float32", "atol": ATOL, "rtol": RTOL, "pred_tol": max(ATOL, 1e-6),
        "warmup_s": t_warm, "iters": iters, "solves_per_s": batch * iters / dt,
        "ms_per_iter": dt * 1e3 / iters, "solves": solves, "stage_ms_per_iter": stages,
        "launches": launches, "launches_per_solve": {k: n / (iters + 1) for k, n in launches.items()},
        "checks": checks, "trace": trace, "peak_mem_gb": peak, "full_result_roll": roll,
    }
    return out, dict(warm=warm, warm_small=warm_small, launches=launches, d_full=d_full,
                     roll_recovery_ms=roll["recovery_ms"])


ROLL_COUNTED = ("banded_pass", "class_pred", "class_pred_ids", "check")


def pred_edge_costs(plan, dist_vb, pred_vb, lanes: int = 32):
    """[V, B] f32: d[p] + w(p -> v) for each predecessor p = pred[v] != v,
    the least weight over the plan's in-edges from p to v (the eight class
    planes, the residual list); +inf where p -> v is no edge, and d[v] where
    p = v. Lanes go in chunks."""
    import torch
    from mesh_navigation_torch.ops import banded_gpu as bg

    R, C, Cp = plan.n_rows, plan.n_cols, plan.n_cols_pad
    V, B = dist_vb.shape
    dev = dist_vb.device
    w8 = bg._w8_planes(plan, R)[:, :, :C]
    shifts = ((0, -1), (0, 1), (-1, -1), (-1, 0), (-1, 1), (1, -1), (1, 0), (1, 1))
    vid = torch.arange(V, device=dev)[:, None]
    dst, src, rw = bg._residual_edges(plan)
    dst_real = (dst // Cp) * C + dst % Cp
    src_real = (src // Cp) * C + src % Cp
    out = torch.empty((V, B), dtype=torch.float32, device=dev)
    for b0 in range(0, B, lanes):
        p = pred_vb[:, b0:b0 + lanes].long()
        d = dist_vb[:, b0:b0 + lanes]
        w = torch.full(p.shape, float("inf"), dtype=torch.float32, device=dev)
        for k, (dr, dc) in enumerate(shifts):
            wk = w8[:, k].reshape(R * C)[:V, None]
            w = torch.where(p == vid + (dr * C + dc), torch.minimum(w, wk), w)
        if dst_real.numel():
            hit = p.index_select(0, dst_real) == src_real[:, None]
            w.index_reduce_(0, dst_real, torch.where(hit, rw[:, None], float("inf")), "amin")
        cost = d.gather(0, p) + w
        out[:, b0:b0 + lanes] = torch.where(p == vid, d, cost)
    return out


def full_result_roll(device, ctx, warm) -> tuple[dict, "torch.Tensor"]:
    """banded_full's last step (not counted for the path): the reference's
    full-result route, ops/banded_gpu.batched_field_banded_pallas, on the
    warm-up draw's goals at the planner's max_rounds and ATOL / RTOL: one
    warm-up and one timed call (stages solve, unpad, pred), the launches in
    the timed call, then predecessors_banded alone on its field (ms, peak
    memory above what was allocated before it). Solves that field with
    banded_solve_padded from the same goals and settings, converge "round"
    (returned: kernels_at_full_shapes reads it). Raises unless converged,
    the pass kernel launched and no class_pred mode or check, dist bit for
    bit that field unpadded, the table on two lanes equal to the same code's
    on a CPU copy of the plan and field, every non-self predecessor
    explaining its label within the recovery's tol, and, where the table
    differs from the id kernel's on that field, neither side the vertex
    itself and both of equal cost."""
    import torch
    from mesh_navigation_torch import convert
    from mesh_navigation_torch.mesh import query
    from mesh_navigation_torch.ops import banded_gpu as bg
    from mesh_navigation_torch.ops import kernels
    from mesh_navigation_torch.utils.timing import StageTimer

    planner, kplan, mesh = ctx["planner"], ctx["kplan"], ctx["mesh"]
    cuda = torch.device(device).type == "cuda"
    R, C, V = kplan.n_rows, kplan.n_cols, kplan.num_vertices
    max_rounds = max(planner.config.max_sweeps // 2, 64)
    tol = max(ATOL, 1e-6)
    _, g, _ = warm
    got = []
    with uncounted():
        gv = query.nearest_vertex_batch(mesh, planner.grid, torch.from_numpy(g).to(device))[0]
        B = len(gv)

        def call(timer=None):
            return bg.batched_field_banded_pallas(mesh, None, kplan, gv, max_rounds=max_rounds,
                                                  atol=ATOL, rtol=RTOL, timer=timer)

        call()
        sync(device)
        before = dict(kernels.LAUNCHES)
        timer = StageTimer(device)
        call_ms = time_ms(lambda: got.append(call(timer)), device)
        launches = {k: kernels.LAUNCHES[k] - before[k] for k in ROLL_COUNTED}
        fr = got.pop()
        stages = timer.totals()
        dist_vb = fr.dist.T.contiguous()
        sync(device)
        base = torch.cuda.memory_allocated() if cuda else 0
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        rec_ms = time_ms(lambda: got.append(bg.predecessors_banded(kplan, dist_vb, tol=tol)),
                         device)
        peak = (torch.cuda.max_memory_allocated() - base) / 1e9 if cuda else None
        pred_vb = got.pop()
        d = bg.banded_solve_padded(kplan, gv, max_rounds=max_rounds, atol=ATOL, rtol=RTOL,
                                   converge="round").d_pad
        ids = bg.predecessors_banded_ids(kplan, d, tol=tol)[:, :B]
    if not fr.converged:
        raise AssertionError(f"full_result_roll did not converge in {fr.rounds} rounds")
    if cuda and (launches["banded_pass"] <= 0 or any(launches[k] for k in ROLL_COUNTED[1:])):
        raise AssertionError(f"full_result_roll launched {launches}")
    same_field = bool(torch.equal(dist_vb, d[:R, :C, :B].reshape(R * C, B)[:V]))
    same_table = bool(torch.equal(pred_vb, fr.pred.T))
    plan_c = convert.plan_from_numpy(
        {k: None if getattr(kplan, k) is None else getattr(kplan, k).cpu().numpy()
         for k in bg.PLAN_ARRAYS}, {k: getattr(kplan, k) for k in bg.PLAN_META}, device="cpu")
    cpu_two = bg.predecessors_banded(plan_c, dist_vb[:, :2].cpu().contiguous(), tol=tol)
    same_cpu = bool(torch.equal(cpu_two, pred_vb[:, :2].cpu()))
    vid = torch.arange(V, device=pred_vb.device)[:, None]
    non_self = pred_vb != vid
    cost = pred_edge_costs(kplan, dist_vb, pred_vb)
    unexplained = int((non_self & ~(cost <= dist_vb * (1.0 + tol) + tol)).sum())
    differ = ids != pred_vb
    cost_ids = pred_edge_costs(kplan, dist_vb, ids)
    bad_ties = int((differ & ((ids == vid) | ~non_self | (cost_ids != cost))).sum())
    out = {
        "lanes": B, "max_rounds": max_rounds, "pred_tol": tol, "rounds": fr.rounds,
        "converged": bool(fr.converged), "call_ms": call_ms,
        "stage_ms": {k: stages.get(k) for k in ("solve", "unpad", "pred")},
        "recovery_ms": rec_ms, "recovery_peak_mem_gb": peak, "launches": launches,
        "dist_bitwise_vs_banded_solve_padded": same_field,
        "pred_equal_to_call": same_table, "pred_card_vs_cpu_two_lanes": same_cpu,
        "non_self_share": float(non_self.float().mean()), "unexplained": unexplained,
        "differ_from_ids": int(differ.sum()), "differ_not_equal_cost": bad_ties,
    }
    if not (same_field and same_table and same_cpu and unexplained == 0 and bad_ties == 0):
        raise AssertionError(f"full_result_roll check failed: {out}")
    del fr, got, dist_vb, pred_vb, ids, cost, cost_ids, differ, non_self
    return out, d


def banded_full_oracle_gate(ctx, bctx, n_lanes: int = 2) -> dict:
    """Phase 7: two lanes of the banded_full warm-up solve against the native
    heap Dijkstra, as the structured phase's gate: the field's largest
    relative error and the path cost against the native predecessor chain's,
    both below 1%."""
    s, g, _ = (x[:n_lanes] for x in bctx["warm"])
    return full_result_gate("banded_full_oracle",
                            full_result_oracle(ctx, ctx["planner"], s, g, bctx["warm_small"]))


def kernels_at_full_shapes(ctx, bctx, device) -> tuple[dict, dict]:
    """Phase 8: the id-mode class-pred kernel on the banded_full path's own
    field (the warm-up draw's goals, solved as the path solves them, by
    full_result_roll), held against its plain version in both modes, and
    its time at this shape beside the roll-based recovery's. Not counted
    for the path."""
    from mesh_navigation_torch.ops import banded_gpu as bg

    kplan = ctx["kplan"]
    d = bctx.pop("d_full")
    with uncounted():
        tol = max(ATOL, 1e-6)
        pair = check_pred_pair(kplan, d, ATOL, RTOL, tol=tol)
        w8 = bg._w8_planes(kplan, d.shape[0])
        kw = dict(R=kplan.n_rows, C=kplan.n_cols, V=kplan.num_vertices, tol=tol, as_class=False)
        time_ms(lambda: bg.class_pred(d, w8, **kw), device)                  # warm
        ms = time_ms(lambda: bg.class_pred(d, w8, **kw), device, reps=5)
        plain_ms = time_ms(lambda: bg.class_pred_plain(d, w8, **kw), device)
    Rp, Cp, Bp = d.shape
    N = Rp * Cp * Bp
    bytes_s = (N * 4 + kplan.num_vertices * Bp * 4 + 8 * Rp * Cp * 4) / HBM_BYTES_PER_S
    bound = max(bytes_s, PRED_OPS * N / F32_OPS_PER_S) * 1e3
    detail = {"phase": "kernels_at_full_shapes", "field": [Rp, Cp, Bp], "pred": pair,
              "ids_ms": ms, "ids_plain_ms": plain_ms, "ids_bound_ms": bound,
              "roll_recovery_ms": bctx["roll_recovery_ms"],
              "roll_recovery_over_ids": bctx["roll_recovery_ms"] / ms}
    return detail, {"ids_ms_full_shape": ms, "ids_bound_ms_full_shape": bound,
                    "ids_plain_ms_full_shape": plain_ms, "max_abs_err": pair["max_abs_err"]}


def replan_config():
    """The replan configuration of bench.py:367-380."""
    from mesh_navigation_torch.config import LayerConfig, MeshMapConfig, NavConfig, PlannerConfig

    return NavConfig(
        mesh_map=MeshMapConfig(default_layer="combine", edge_cost_factor=1.0),
        planner=PlannerConfig(cost_limit=2.0),
        layers=(
            LayerConfig(name="steep", kind="steepness", params=(("threshold", 2.0),)),
            LayerConfig(name="obst", kind="obstacle"),
            LayerConfig(name="infl", kind="inflation", inputs=("obst",),
                        params=(("repulsive_field", 0.0),)),
            LayerConfig(name="combine", kind="max_combination",
                        inputs=("steep", "obst", "infl")),
        ),
    )


def update_clouds(rng, v, mesh_n: int, n_pts: int = 512):
    """bench.py:401-422: points hovering 0.3 above a +-2-row/col patch of
    vertices, in the pattern jump (a random centre) / drift (+3 rows, +3
    cols) / clear (z_off 1e4: every ray misses)."""
    V = len(v)

    def cloud(center, z_off=0.3):
        ids = np.clip(center + rng.integers(-2, 3, n_pts) * mesh_n
                      + rng.integers(-2, 3, n_pts), 0, V - 1)
        return (v[ids] + np.asarray([0, 0, z_off], np.float32)).astype(np.float32)

    c0 = int(rng.integers(0, V))
    drift = int(np.clip(c0 + 3 * mesh_n + 3, 0, V - 1))
    return [("jump", cloud(c0)), ("drift", cloud(drift)), ("clear", cloud(c0, z_off=1e4))]


def warm_vs_cold(step, seeds, d_warm) -> dict:
    """Gate 1: the warm field against a cold converge="round" solve on the
    step's own planes: the same finite set, max relative difference < 1%.
    Also reads (no gate) the largest difference in units of the stopping
    tolerance atol + rtol*|cold|, the measure the CPU tests hold at 2."""
    import torch
    from mesh_navigation_torch.ops import banded_gpu as bg

    cold = bg.banded_solve_padded(step.last["plan"], seeds, atol=ATOL, rtol=RTOL,
                                  converge="round").d_pad
    fin = torch.isfinite(cold)
    same = bool(torch.equal(fin, torch.isfinite(d_warm)))
    diff = (d_warm[fin] - cold[fin]).abs()
    rel = float((diff / cold[fin].abs().clamp(min=1e-3)).max())
    tol_ratio = float((diff / (ATOL + RTOL * cold[fin].abs())).max())
    nan = bool(torch.isnan(d_warm).any())
    if not (same and rel < 0.01 and not nan):
        raise AssertionError(f"warm field vs cold solve: same finite set {same}, "
                             f"max rel {rel:.3e}, nan {nan}")
    return {"same_finite_set": same, "max_rel_err": rel, "tol_ratio": tol_ratio}


def replan(device, ctx, iters: int) -> tuple[dict, dict]:
    """Phase 9: the live-replan cascade at full width through
    MeshNavServer.make_replan_step."""
    import torch
    from mesh_navigation_torch.api.server import MeshNavServer
    from mesh_navigation_torch.ops import banded_gpu as bg
    from mesh_navigation_torch.ops import kernels
    from mesh_navigation_torch.utils.timing import StageTimer

    mesh, v = ctx["mesh"], ctx["v"]
    mesh_n = int(round(np.sqrt(mesh.num_vertices)))
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    srv = MeshNavServer(mesh, replan_config(), planner_kind="dijkstra", grid=ctx["planner"].grid,
                        device=device)
    step = srv.make_replan_step("obst")
    sync(device)
    t_setup = time.perf_counter() - t0
    log(f"# replan server + step built in {t_setup:.1f} s")
    rng = np.random.default_rng(SEED + 2)
    seeds = torch.from_numpy(np.sort(rng.integers(0, mesh.num_vertices, REPLAN_BATCH))).to(device)

    kernels.reset_launches()
    tb = time.perf_counter()
    base = bg.banded_solve_padded(srv.banded_plan, seeds, atol=ATOL, rtol=RTOL)
    sync(device)
    base_ms = (time.perf_counter() - tb) * 1e3
    base_launches = {name: kernels.LAUNCHES[name] for name in REPLAN_KERNELS}
    costs, d = srv.vertex_costs, base.d_pad
    gates = {"warm_vs_cold": [], "converged": []}
    log_steps = []
    inputs = {}   # the newest update of each pattern: its inputs and planes

    def one(name, pts, timer=None):
        nonlocal costs, d
        d_in, costs_in = d, costs
        sync(device)
        t = time.perf_counter()
        costs, d, rounds = step(torch.from_numpy(pts).to(device), costs, d, seeds, timer=timer)
        sync(device)
        ms = (time.perf_counter() - t) * 1e3
        gates["converged"].append(bool(step.last["converged"]))
        if not step.last["converged"]:
            raise AssertionError(f"replan step {name} did not converge in {rounds} rounds")
        with uncounted():
            gates["warm_vs_cold"].append(warm_vs_cold(step, seeds, d))
        log_steps.append({"pattern": name, "ms": ms, "rounds": rounds,
                          "lethal": int(torch.isinf(costs).sum())})
        inputs[name] = dict(d_prev=d_in, costs_prev=costs_in, costs=costs,
                            plan=step.last["plan"])

    tw = time.perf_counter()
    one("warmup", update_clouds(rng, v, mesh_n)[0][1])
    warmup_s = time.perf_counter() - tw
    timers = {name: StageTimer(device) for name in ("jump", "drift", "clear")}
    n_steps = 0
    for _ in range(iters):
        for name, pts in update_clouds(rng, v, mesh_n):
            one(name, pts, timer=timers[name])
            n_steps += 1
    launches = {name: kernels.LAUNCHES[name] for name in REPLAN_KERNELS}
    for name, n in launches.items():
        if n <= 0 and torch.device(device).type == "cuda":
            raise AssertionError(f"kernel {name} was not launched on the replan path")
    timed = log_steps[1:]
    per_pattern = {}
    for name in ("jump", "drift", "clear"):
        ms = [x["ms"] for x in timed if x["pattern"] == name]
        per_pattern[name] = {"ms": ms, "rounds": [x["rounds"] for x in timed if x["pattern"] == name],
                             "lethal_vertices": [x["lethal"] for x in timed if x["pattern"] == name],
                             "mean_ms": float(np.mean(ms)),
                             "stage_ms": {k: val / len(ms) for k, val in timers[name].totals().items()}}
    ms_per_update = float(np.mean([x["ms"] for x in timed]))
    stages = {}
    for t in timers.values():
        for k, val in t.totals().items():
            stages[k] = stages.get(k, 0.0) + val / n_steps

    # gate 2: two lanes of the last field against the native heap Dijkstra
    with uncounted():
        costs_np = costs.cpu().numpy()
        R, C, V = srv.banded_plan.n_rows, srv.banded_plan.n_cols, mesh.num_vertices
        errs, same_sets = [], []
        src = seeds[:2].cpu().numpy()
        for b, (od, _) in enumerate(native_fields(v, ctx["f"], costs_np, src)):
            pot = d[:R, :C, b].reshape(-1)[:V].cpu().numpy()
            same_sets.append(bool(np.array_equal(np.isfinite(pot), np.isfinite(od))))
            errs.append(percentile_rel_err(pot, od))
        oracle = {"lanes": 2, "max_rel_err": float(np.max(errs)), "same_finite_set": same_sets,
                  "budget": 0.01}
        if not (oracle["max_rel_err"] < 0.01 and all(same_sets)):
            raise AssertionError(f"replan oracle parity failed: {oracle}")
    # one more jump update under the profiler: the step alone, no gate
    traced_pts = torch.from_numpy(update_clouds(rng, v, mesh_n)[0][1]).to(device)
    trace = device_busy(lambda: step(traced_pts, costs, d, seeds), device)
    out = {
        "phase": "replan", "mesh": f"{mesh_n}x{mesh_n}", "V": mesh.num_vertices,
        "lanes": REPLAN_BATCH, "atol": ATOL, "rtol": RTOL, "setup_s": t_setup,
        "base_solve_ms": base_ms, "base_rounds": base.rounds, "warmup_s": warmup_s,
        "iters": iters, "updates": n_steps, "ms_per_update": ms_per_update,
        "updates_per_s": 1e3 / ms_per_update, "per_pattern": per_pattern,
        "stage_ms_per_update": stages, "launches": launches,
        "launches_per_update": {k: (n - base_launches[k]) / (n_steps + 1)
                                for k, n in launches.items()},
        "gates": {"converged_every_step": all(gates["converged"]),
                  "warm_vs_cold_max_rel": max(g["max_rel_err"] for g in gates["warm_vs_cold"]),
                  "warm_vs_cold_tol_ratio": [g["tol_ratio"] for g in gates["warm_vs_cold"]],
                  "warm_vs_cold_same_finite_set": all(g["same_finite_set"]
                                                      for g in gates["warm_vs_cold"]),
                  "oracle": oracle},
        "trace": trace,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9
        if torch.device(device).type == "cuda" else None,
    }
    return out, dict(srv=srv, seeds=seeds, launches=launches, **inputs["jump"])


def kernels_at_replan_shapes(rctx, device) -> tuple[dict, dict]:
    """Phase 10: the warm resolve of the last timed jump update again, pass
    by pass, each launch timed by its own event pair; the check kernel
    against its plain version on the converged field. Not counted for the
    path."""
    import torch
    from mesh_navigation_torch.ops import banded_gpu as bg

    srv, seeds, plan = rctx["srv"], rctx["seeds"], rctx["plan"]
    costs_prev, d_prev, costs = rctx["costs_prev"], rctx["d_prev"], rctx["costs"]
    plan0 = srv.banded_plan
    changed = bg.changed_plane_from_costs(plan0, costs_prev, costs)
    raised = bg.raised_plane_from_costs(plan0, costs_prev, costs)
    pos = bg.position_planes(plan0, srv.mesh)
    Rp = d_prev.shape[0]
    warm_cmp = check_warm_pass_pair(plan, seeds, d_prev, changed, raised, pos, ATOL, RTOL)
    d, dirty, cut = bg._warm_start(plan, seeds, d_prev, changed, raised, pos,
                                   Rp=Rp, bb=bg.PASS_LANES, atol=ATOL, rtol=RTOL)
    prob = bg.prepare_padded(plan, seeds, seeded=False)
    w8 = bg._w8_planes(plan, Rp)
    _, Cp, Bp = d.shape
    N = Rp * Cp * Bp
    nb = Bp // bg.PASS_LANES
    times, bounds, unchanged, walked = [], [], [], []
    ok, rounds = False, 0
    while not ok and rounds < 64:
        for reverse, cross in ((False, prob.down), (True, prob.up)):
            wc = cut if (rounds == 0 and not reverse) else None
            before = d.clone()
            nw = torch.zeros(1, dtype=torch.int32, device=d.device)
            times.append(time_ms(lambda: bg.directional_pass(
                d, cross, prob.a_fwd, prob.a_bwd, reverse=reverse, atol=ATOL, rtol=RTOL,
                dirty=dirty, warm_cut=wc, rows_walked=nw), device))
            walked.append(int(nw.item()) / (Rp * nb))
            diff = d != before
            del before
            n_written = int(diff.sum())
            rows_changed = diff.view(Rp, Cp, nb, bg.PASS_LANES).any(dim=3).any(dim=1)
            unchanged.append(1.0 - float(rows_changed.float().mean()))
            # one read of the field, the planes it reads (cross, level 0 of
            # a_fwd / a_bwd, and cutlb on the cut pass), the dirty table read
            # and written, one write of each element the pass changed
            plane_elems = 5 * Rp * Cp + (Rp * Cp if wc is not None else 0)
            bounds.append((N + plane_elems + 2 * nb * Rp + n_written) * 4 / HBM_BYTES_PER_S)
        rounds += 1
        ok = not bool(bg.check(d, w8, atol=ATOL, rtol=RTOL).item())
    warm_ms = float(np.mean(times))
    warm_bound = max(float(np.mean(bounds)), PASS_OPS * N / F32_OPS_PER_S) * 1e3

    checks = check_cases(d, plan, ATOL, RTOL)
    time_ms(lambda: bg.check(d, w8, atol=ATOL, rtol=RTOL), device)          # warm
    check_ms = time_ms(lambda: bg.check(d, w8, atol=ATOL, rtol=RTOL), device, reps=5)
    plain_check_ms = time_ms(lambda: bg.check_plain(d, w8, atol=ATOL, rtol=RTOL), device)
    check_bytes_s = (N + 8 * Rp * Cp) * 4 / HBM_BYTES_PER_S
    check_ops_s = CHECK_OPS * N / F32_OPS_PER_S
    detail = {"phase": "kernels_at_replan_shapes", "field": [Rp, Cp, Bp], "warm_pass": warm_cmp,
              "warm_rounds": rounds, "warm_pass_launch_ms": times,
              "warm_pass_bound_ms": [b * 1e3 for b in bounds],
              "warm_pass_rows_walked_share": walked,
              "warm_pass_unchanged_row_share": unchanged, "check": checks,
              "check_ms": check_ms, "check_plain_ms": plain_check_ms}
    for i, (t, b, w) in enumerate(zip(times, bounds, walked)):
        log(f"# warm pass {i}: {t:.3f} ms (bound {b * 1e3:.3f} ms), "
            f"rows walked {w * Rp * nb:.0f} of {Rp * nb} ({w:.4f})")
    return detail, {
        "warm_ms": warm_ms, "warm_bound_ms": warm_bound,
        "warm_rows_walked_share": float(np.mean(walked)),
        "warm_max_abs_err": max(c["max_abs_err"] for c in warm_cmp.values()),
        "check": {"ms": check_ms, "plain_ms": plain_check_ms,
                  "bound_ms": max(check_bytes_s, check_ops_s) * 1e3,
                  "bound_by": "bytes" if check_bytes_s >= check_ops_s else "operations",
                  "max_abs_err": float(max(c["abs_err"] for c in checks.values()))},
    }


def eik_orderings_check(plan, d, atol, rtol, strip_width) -> dict:
    """The eikonal pass kernel against its plain version on the same inputs
    at one strip width: each of the four orderings forced, then driven by
    the forced pass's dirty table; the next ordering starts from the plain
    output. Fields bit for bit where reached, else within atol + rtol*|d|;
    dirty tables and changed flags equal."""
    import torch
    from mesh_navigation_torch.ops import eikonal_gpu as eg

    cls = eg.class_sources(plan)
    dirty = torch.zeros((d.shape[2] // eg.EIK_LANES, d.shape[0]), dtype=torch.int32,
                        device=d.device)
    out = {}
    for rev, cdir in (*eg._PAIR_A, *eg._PAIR_B):
        for force in (True, False):
            kw = dict(reverse=rev, chunk_dir=cdir, atol=atol, rtol=rtol, force=force,
                      strip_width=strip_width)
            d_k, chg_k, dirty_k = eg.eik_pass(d, plan.abc, cls, dirty, **kw)
            d_p, chg_p, dirty_p = eg._eik_pass_plain(d, plan.abc, cls, dirty, **kw)
            cmp = compare_fields(d_k, d_p, atol, rtol)
            cmp.update(bitwise=bool(torch.equal(d_k, d_p)),
                       flags_equal=int(chg_k.item()) == int(chg_p.item()),
                       dirty_equal=bool(torch.equal(dirty_k, dirty_p)),
                       dirty_rows=int(dirty_p.sum()))
            name = f"{'up' if rev else 'down'}{'+' if cdir > 0 else '-'}{'_forced' if force else '_dirty'}"
            out[name] = cmp
            if not (cmp["within_tol"] and cmp["flags_equal"] and cmp["dirty_equal"]):
                raise AssertionError(f"eik_pass kernel disagrees with its plain version: {name} {cmp}")
            d, dirty = d_p, dirty_p
    return out


def eik_kernel_check(device, nx: int = 40, ny: int = 36, batch: int = 16) -> tuple[dict, dict]:
    """Phase 2, eik_kernel_check: the eikonal pass kernel against its plain
    version on a small terrain whose row width is not a multiple of 32, with
    `batch` goal-face lanes and a loose upper bound in 30% of the unseeded
    elements (so that a forced pass has work in every row), at the default
    strip width and at EIK_NARROW_WIDTH (many strips a row). Also the plain
    version's time and the kernel's at this shape."""
    import torch
    from mesh_navigation_torch.mesh import synthetic
    from mesh_navigation_torch.mesh.arrays import build_mesh, host_array
    from mesh_navigation_torch.ops import eikonal_gpu as eg
    from mesh_navigation_torch.ops import sweeps

    v, f = synthetic.terrain_mesh(nx, ny, spacing=0.5, hills=2.0, roughness=0.01, seed=0)
    mesh = build_mesh(v, f, device=device)
    nz = torch.clamp(mesh.vertex_normals[:, 2], -1.0, 1.0)
    ew = sweeps.compute_edge_weights(mesh, torch.arccos(nz), 1.0)
    plan = eg.build_eikonal_kernel_plan(mesh, ew.cpu().numpy())
    rng = np.random.default_rng(SEED + 4)
    seed_v = host_array(mesh, "faces")[rng.integers(0, mesh.num_faces, batch)]
    seed_d = rng.uniform(0.05, 0.4, seed_v.shape).astype(np.float32)
    d = eg.seeded_field(plan, torch.from_numpy(seed_v), torch.from_numpy(seed_d))
    far = torch.from_numpy(rng.uniform(100.0, 150.0, tuple(d.shape)).astype(np.float32)).to(device)
    some = torch.from_numpy(rng.uniform(size=tuple(d.shape)) < 0.3).to(device)
    d = torch.where(torch.isinf(d) & some, far, d)
    with uncounted():
        widths = {"default": eg.EIK_STRIP_WIDTH, "narrow": EIK_NARROW_WIDTH}
        cases = {f"{name}_{case}": cmp for name, w in widths.items()
                 for case, cmp in eik_orderings_check(plan, d, CVP_ATOL, CVP_RTOL, w).items()}
        cls = eg.class_sources(plan)
        dirty = torch.zeros((d.shape[2] // eg.EIK_LANES, d.shape[0]), dtype=torch.int32,
                            device=device)
        kw = dict(reverse=False, chunk_dir=1, atol=CVP_ATOL, rtol=CVP_RTOL, force=True)
        time_ms(lambda: eg.eik_pass(d, plan.abc, cls, dirty, **kw), device)       # warm
        kernel_ms = time_ms(lambda: eg.eik_pass(d, plan.abc, cls, dirty, **kw), device, reps=5)
        plain_ms = time_ms(lambda: eg._eik_pass_plain(d, plan.abc, cls, dirty, **kw), device)
    detail = {"phase": "eik_kernel_check", "mesh": f"{nx}x{ny}", "field": list(d.shape),
              "lanes": batch, "classes": len(plan.classes), "strip_widths": widths,
              "cases": cases,
              "bitwise_all": all(c["bitwise"] for c in cases.values()),
              "forced_pass_kernel_ms": kernel_ms, "forced_pass_plain_ms": plain_ms}
    return detail, {"plain_ms": plain_ms, "check_shape": list(d.shape),
                    "check_shape_ms": kernel_ms,
                    "max_abs_err": max(c["max_abs_err"] for c in cases.values())}


def eik_slab_check(pass_fn, d, abc, cls, dirty, r0: int, kw: dict, device) -> dict:
    """The eikonal pass kernel (`pass_fn`) against its plain version on rows
    r0 .. r0 + EIK_SLAB_ROWS of one CVP-path launch's own input, at the
    path's full width, lanes and classes; rows outside the slab read as
    +inf to both. Fields bit for bit, dirty tables and changed flags equal;
    also the plain version's time on the slab."""
    import torch
    from mesh_navigation_torch.ops import eikonal_gpu as eg

    r1 = min(r0 + EIK_SLAB_ROWS, d.shape[0])
    ds, abcs = d[r0:r1].contiguous(), abc[r0:r1].contiguous()
    dirs = dirty[:, r0:r1].contiguous()
    d_k, chg_k, dirty_k = pass_fn(ds, abcs, cls, dirs, **kw)
    got = []
    plain_ms = time_ms(lambda: got.append(eg._eik_pass_plain(ds, abcs, cls, dirs, **kw)), device)
    d_p, chg_p, dirty_p = got[0]
    cmp = compare_fields(d_k, d_p, kw["atol"], kw["rtol"])
    cmp.update(rows=[r0, r1], shape=list(ds.shape), force=bool(kw.get("force")),
               bitwise=bool(torch.equal(d_k, d_p)),
               flags_equal=int(chg_k.item()) == int(chg_p.item()),
               dirty_equal=bool(torch.equal(dirty_k, dirty_p)),
               dirty_rows_in=int(dirs.sum()), dirty_rows_out=int(dirty_p.sum()),
               elements_changed=int((d_p != ds).sum()), plain_ms=plain_ms)
    if not (cmp["bitwise"] and cmp["flags_equal"] and cmp["dirty_equal"]):
        raise AssertionError(f"eik_pass kernel disagrees with its plain version on the "
                             f"CVP path's input: {cmp}")
    return cmp


def cvp(device, ctx, iters: int, batch: int = CVP_BATCH) -> tuple[dict, dict]:
    """Phase 11: the CVP planner at full width (bench.py:451-554) on the main
    path's terrain and steepness costs: side lengths = edge weights (cost
    factor 1.0), the eikonal plan with its Dijkstra warm plan, `batch`
    lanes with starts and goals drawn on vertices, one warm-up, then `iters`
    timed plan_batch_banded calls, each followed by one compute_velocity_cvp
    cycle. Gates: converged on every solve, the path's kernels launched,
    sane outputs."""
    import torch
    from mesh_navigation_torch.config import ControllerConfig, PlannerConfig
    from mesh_navigation_torch.control import MeshController
    from mesh_navigation_torch.control.controller import initial_state
    from mesh_navigation_torch.ops import kernels
    from mesh_navigation_torch.planners import CVPPlanner
    from mesh_navigation_torch.utils.timing import StageTimer

    mesh, v, costs_np = ctx["mesh"], ctx["v"], ctx["costs_np"]
    mesh_n = int(round(np.sqrt(mesh.num_vertices)))
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    costs = torch.from_numpy(costs_np).to(device)
    planner = CVPPlanner(mesh, PlannerConfig(cost_limit=2.0), grid=ctx["planner"].grid,
                         max_path_len=max(2048, 3 * mesh_n), device=device)
    ew = planner.prepare_weights(costs, 1.0)
    ew_np = ew.cpu().numpy()
    kplan = planner.prepare_eikonal_plan(ew_np, costs_np)
    if kplan is None or planner._dij_plan is None:
        raise RuntimeError("no banded eikonal plan (or warm plan) for the terrain mesh")
    ctrl = MeshController(mesh, ControllerConfig(), grid=planner.grid, device=device)
    sync(device)
    t_setup = time.perf_counter() - t0
    log(f"# cvp set-up {t_setup:.1f} s: classes {len(kplan.classes)}, coverage "
        f"{kplan.coverage}, residual pairs {kplan.n_residual}")
    rng = np.random.default_rng(SEED + 3)
    q = torch.tensor([[0.0, 0.0, 0.0, 1.0]]).expand(batch, 4)

    def sample():
        """Starts and goals on vertices (bench.py:488-495): the goal's
        containing-face search needs poses on the surface."""
        p = v[rng.integers(0, mesh.num_vertices, 2 * batch)].astype(np.float32)
        return p[:batch], p[batch:]

    def step(s, g, timer=None):
        res = planner.plan_batch_banded(ew, kplan, torch.from_numpy(s), torch.from_numpy(g),
                                        atol=CVP_ATOL, rtol=CVP_RTOL, timer=timer)
        st = initial_state(torch.from_numpy(g).to(device), torch.tensor([1.0, 0.0, 0.0]))
        cmds, _ = ctrl.compute_velocity_cvp(
            kplan, ew, res.d_pad.reshape(-1, res.d_pad.shape[-1]), costs,
            torch.from_numpy(s), q, st, tol=1e-3, timer=timer)
        return res, cmds

    kernels.reset_launches()
    warm = sample()
    tw = time.perf_counter()
    warm_res, cmds = step(*warm)
    sync(device)
    t_warm = time.perf_counter() - tw
    solves = [{"rounds": warm_res.rounds, "converged": bool(warm_res.converged)}]
    timer = StageTimer(device)
    t1 = time.perf_counter()
    res = None
    for _ in range(iters):
        res = cmds = None
        res, cmds = step(*sample(), timer=timer)
        solves.append({"rounds": res.rounds, "converged": bool(res.converged)})
    sync(device)
    dt = time.perf_counter() - t1
    launches = {name: kernels.LAUNCHES[name] for name in CVP_KERNELS}
    for name, n in launches.items():
        if n <= 0 and torch.device(device).type == "cuda":
            raise AssertionError(f"kernel {name} was not launched on the CVP path")
    if not all(x["converged"] for x in solves):
        raise AssertionError(f"a CVP solve did not converge: {solves}")
    ok_lanes = res.outcome == 0
    checks = {
        "shapes": list(res.path_positions.shape) == [batch, planner.max_path_len, 3]
        and list(cmds.linear.shape) == [batch],
        "reach_rate": float(ok_lanes.float().mean()),
        "costs_finite_where_reached": bool(torch.isfinite(res.cost[ok_lanes]).all()),
        "commands_finite": bool(torch.isfinite(cmds.linear).all()
                                and torch.isfinite(cmds.angular).all()),
        "control_success_rate": float((cmds.outcome == 0).float().mean()),
    }
    if not (checks["shapes"] and checks["costs_finite_where_reached"]
            and checks["commands_finite"] and checks["reach_rate"] > 0.5):
        raise AssertionError(f"CVP output check failed: {checks}")
    stages = {k: val / iters for k, val in timer.totals().items()}
    peak = torch.cuda.max_memory_allocated() / 1e9 if torch.device(device).type == "cuda" else None
    res = cmds = None
    trace = device_busy(lambda: step(*sample()), device)
    out = {
        "phase": "cvp", "mesh": f"{mesh_n}x{mesh_n}", "V": mesh.num_vertices, "lanes": batch,
        "atol": CVP_ATOL, "rtol": CVP_RTOL, "orderings": 2,
        "classes": len(kplan.classes), "coverage": kplan.coverage,
        "setup_s": t_setup, "warmup_s": t_warm, "iters": iters,
        "solves_per_s": batch * iters / dt, "ms_per_iter": dt * 1e3 / iters,
        "solves": solves, "stage_ms_per_iter": stages, "launches": launches,
        "launches_per_solve": {k: n / (iters + 1) for k, n in launches.items()},
        "checks": checks, "trace": trace, "peak_mem_gb": peak,
    }
    return out, dict(planner=planner, kplan=kplan, ew=ew, ew_np=ew_np, warm=warm,
                     warm_res=warm_res, launches=launches, costs=costs)


def cvp_oracle_gate(ctx, cctx, n_lanes: int = 2, costs_np=None, phase="cvp_oracle") -> dict:
    """Phase 12: two lanes of the warm-up solve against the native CVP fast
    marching (bench.py:520-550): the 99.9th-percentile relative error of the
    field below 1%, and the walked cost of each lane's descent no more than
    1% + 1e-2 above the walked cost of the same descent on the oracle's own
    field. Also read, not gated: the walked cost over the oracle's distance
    at the start vertex (the vertex descent walks along edges, so on an
    exact field it already walks up to a third more than the geodesic).
    `costs_np` (default: the main path's) are the vertex costs of the
    solve; cctx["ew_np"] its side lengths. The finite sets must be equal
    (vertices that keep a warm-start label where the fast marching leaves
    inf, ROADMAP queue C, are counted and fail the gate)."""
    import torch
    from mesh_navigation_torch.mesh import query
    from mesh_navigation_torch.native import NativeMesh
    from mesh_navigation_torch.ops import eikonal_gpu as eg
    from mesh_navigation_torch.planners.common import pose_chain
    from mesh_navigation_torch.planners.dijkstra import potential_lanes

    planner, kplan, res = cctx["planner"], cctx["kplan"], cctx["warm_res"]
    mesh, dev = planner.mesh, planner.device
    s, g = (x[:n_lanes] for x in cctx["warm"])
    g_face = query.containing_face_batch(mesh, planner.grid, torch.from_numpy(g).to(dev))[0]
    g_vids = mesh.faces[torch.clamp(g_face, min=0)].long()
    s_v = query.nearest_vertex_batch(mesh, planner.grid, torch.from_numpy(s).to(dev))[0]
    pot = potential_lanes(kplan, res.d_pad, res.lane_map, list(range(n_lanes)))
    v = ctx["v"]
    nm = NativeMesh(v, ctx["f"])
    lanes = []
    try:
        for b in range(n_lanes):
            gv = g_vids[b].cpu().numpy()
            sd = np.linalg.norm(v[gv] - g[b][None], axis=1).astype(np.float32)
            od = nm.cvp(cctx["ew_np"], ctx["costs_np"] if costs_np is None else costs_np,
                        gv, sd, 2.0)[0]
            d_or = eg.padded_flat_from_vb(kplan, torch.from_numpy(od)[None].to(dev))
            path, valid = eg.cvp_descend_paths(kplan, mesh, cctx["ew"], d_or, s_v[b:b + 1],
                                               g_vids[b:b + 1], planner.max_path_len, tol=5e-3)
            walk_or = float(pose_chain(mesh.vertices[path], valid, mesh.vertex_normals[path])[1][0])
            walked = float(res.cost[b])
            od_start = float(od[int(s_v[b])])
            fin_f, fin_o = np.isfinite(pot[b]), np.isfinite(od)
            lanes.append({"p999_rel_err": percentile_rel_err(pot[b], od),
                          "same_finite_set": bool(np.array_equal(fin_f, fin_o)),
                          "warm_only_vertices": int((fin_f & ~fin_o).sum()),
                          "walked_cost": walked, "oracle_field_walked_cost": walk_or,
                          "oracle_at_start": od_start,
                          "walked_over_oracle_at_start": walked / od_start if od_start > 0 else None,
                          "path_steps": int(res.path_valid[b].sum())})
    finally:
        nm.close()
    out = {"phase": phase, "lanes": lanes, "budget": 0.01,
           "max_rel_err": max(x["p999_rel_err"] for x in lanes)}
    bad = [x for x in lanes
           if not (x["p999_rel_err"] < 0.01 and x["same_finite_set"]
                   and x["walked_cost"] <= x["oracle_field_walked_cost"] * 1.01 + 1e-2)]
    if bad:
        raise AssertionError(f"{phase} gate failed: {out}")
    return out


def eik_strip_rows_computed(d, new, dirty, kw) -> "torch.Tensor":
    """[nj, S, Rp] bool: the strip-rows an eik_pass launch computed, from its
    input, output and dirty table by the kernel's rule: g of a strip-row is
    any(new < d) over its columns and lanes (a strip that improves keeps its
    new values, one that does not keeps d), and a strip-row is computed
    where force, a dirty row next to it, or g of strips s-1 .. s+1 of the
    row before or of strip s-1 of its own row asks for it."""
    import torch
    import torch.nn.functional as F
    from mesh_navigation_torch.ops import eikonal_gpu as eg

    Rp, Cp, Bp = d.shape
    nj, W = Bp // eg.EIK_LANES, kw["strip_width"]
    S = -(-Cp // W)
    lower = (new < d).view(Rp, Cp, nj, eg.EIK_LANES).any(dim=3)          # [Rp, Cp, nj]
    if kw["chunk_dir"] < 0:
        lower = lower.flip(1)                   # columns in pass order
    lower = F.pad(lower.permute(2, 0, 1), (0, S * W - Cp))              # [nj, Rp, S * W]
    g = lower.view(nj, Rp, S, W).any(dim=3).transpose(1, 2)             # [nj, S, Rp]
    if kw.get("force"):
        return torch.ones_like(g)
    din = dirty.bool()
    near = din.clone()
    near[:, 1:] |= din[:, :-1]
    near[:, :-1] |= din[:, 1:]
    need = near[:, None, :].expand(nj, S, Rp).clone()
    gs = F.pad(g, (0, 0, 1, 1))                                          # [nj, S + 2, Rp]
    fed_rb = gs[:, :-2] | gs[:, 1:-1] | gs[:, 2:]                        # strips s-1 .. s+1
    if kw["reverse"]:                           # the row before in pass order
        need[:, :, :-1] |= fed_rb[:, :, 1:]
    else:
        need[:, :, 1:] |= fed_rb[:, :, :-1]
    need |= gs[:, :-2]                          # strip s-1 of the same row
    return need


def kernels_at_cvp_shapes(cctx, device) -> tuple[dict, dict]:
    """Phase 13: the eikonal solve of one more plan_batch_banded call on the
    warm-up draw, pass by pass: each eik_pass launch timed by its own event
    pair, with its bound from what that launch's data needs: the operations
    of the strip-rows it computes (eik_strip_rows_computed: K unfold updates
    per element and K side-term sets per column of a computed strip-row)
    and the bytes of one read of the field and the abc planes, the dirty
    tables, and one write of each element it changed. The first forced
    launch is run a second time on the same input with the SM of each block
    recorded (the two outputs bit for bit equal: a race would show as
    nondeterminism) and timed at the strip widths EIK_TUNE_WIDTHS; it and
    the first launch driven by a dirty table are also held against the
    plain version on a slab of their own input (eik_slab_check): the forced
    one in the middle rows, the dirty one around the median dirty row that
    it improved. Not counted for the path."""
    import torch
    from mesh_navigation_torch.ops import eikonal_gpu as eg

    planner, kplan = cctx["planner"], cctx["kplan"]
    K = len(kplan.classes)
    times, byte_s, op_s, computed = [], [], [], []
    slabs, launch = {}, {}
    orig = eg.eik_pass

    def timed(d, abc, cls, dirty, **kw):
        got = []
        times.append(time_ms(lambda: got.append(orig(d, abc, cls, dirty, **kw)), device))
        out = got[0]
        new, _, dirty_out = out
        Rp, Cp, Bp = d.shape
        dirty_rows = dirty.any(dim=0).nonzero()[:, 0]
        written = dirty_out.any(dim=0).nonzero()[:, 0]
        if kw.get("force") and "forced" not in slabs:
            cuda = torch.device(device).type == "cuda"   # the CPU runs the plain pass
            grid = eg.eik_pass_grid(Cp, Bp, K, kw["strip_width"]) if cuda else {"grid": None}
            sm_ids = (torch.full((grid["blocks"],), -1, dtype=torch.int32, device=device)
                      if cuda else None)
            again = orig(d, abc, cls, dirty, sm_ids=sm_ids, **kw)
            repeat_bitwise = all(bool(torch.equal(x, y)) for x, y in zip(out, again))
            del again
            if not repeat_bitwise:
                raise AssertionError("two eik_pass launches on the CVP path's input differ")
            by_width = {}
            for w in EIK_TUNE_WIDTHS:
                kw_w = {**kw, "strip_width": w}
                run = lambda: orig(d, abc, cls, dirty, **kw_w)   # noqa: E731
                time_ms(run, device)                                           # warm
                by_width[w] = time_ms(run, device, reps=3)
            launch.update(grid, strip_width=kw["strip_width"], lane_block=eg.EIK_LANES,
                          sms_used=int(torch.unique(sm_ids).numel()) if cuda else None,
                          repeat_bitwise=repeat_bitwise, forced_ms_by_width=by_width)
            r0 = max(0, Rp // 2 - EIK_SLAB_ROWS // 2)
            slabs["forced"] = eik_slab_check(orig, d, abc, cls, dirty, r0, kw, device)
        elif not kw.get("force") and "dirty" not in slabs and len(dirty_rows):
            rows = written if len(written) else dirty_rows    # rows this launch improved
            r = int(rows[len(rows) // 2])
            r0 = max(0, min(r - 1, Rp - EIK_SLAB_ROWS))
            slabs["dirty"] = eik_slab_check(orig, d, abc, cls, dirty, r0, kw, device)
        need = eik_strip_rows_computed(d, new, dirty, kw)
        computed.append(float(need.float().mean()))
        W = kw["strip_width"]
        widths = torch.clamp(Cp - W * torch.arange(need.shape[1], device=device), max=W)
        n_cols = int((need.sum(dim=(0, 2)) * widths).sum())    # computed columns of a lane block
        n_written = int((new != d).sum())
        byte_s.append((d.numel() + abc.numel() + 2 * dirty.numel() + n_written) * 4
                      / HBM_BYTES_PER_S)
        op_s.append(n_cols * (eg.EIK_LANES * (K * EIK_UNFOLD_OPS + EIK_ELEM_OPS)
                              + K * EIK_SIDE_OPS) / F32_OPS_PER_S)
        return out

    s, g = cctx["warm"]
    eg.eik_pass = timed
    try:
        with uncounted():
            res = planner.plan_batch_banded(cctx["ew"], kplan, torch.from_numpy(s),
                                            torch.from_numpy(g), atol=CVP_ATOL, rtol=CVP_RTOL)
    finally:
        eg.eik_pass = orig
    if set(slabs) != {"forced", "dirty"}:
        raise AssertionError(f"the CVP solve gave no forced or no dirty-driven pass to check: "
                             f"{sorted(slabs)}")
    bounds = [max(x, y) * 1e3 for x, y in zip(byte_s, op_s)]
    detail = {"phase": "kernels_at_cvp_shapes", "field": list(res.d_pad.shape), "classes": K,
              "rounds": res.rounds, "launch": launch, "eik_pass_launch_ms": times,
              "eik_pass_bound_ms": bounds, "strip_rows_computed_share": computed,
              "path_slab_checks": slabs}
    return detail, {"ms": float(np.mean(times)), "bound_ms": float(np.mean(bounds)),
                    "bound_by": "bytes" if np.mean(byte_s) >= np.mean(op_s) else "operations",
                    "strip_width": launch["strip_width"], "grid": launch["grid"],
                    "sms_used": launch["sms_used"],
                    "slab_max_abs_err": max(c["max_abs_err"] for c in slabs.values()),
                    "slab_shape": slabs["forced"]["shape"],
                    "slab_plain_ms": slabs["forced"]["plain_ms"]}


def sweep_inputs(rng, tile: int, V: int, B: int, offsets, device):
    """A tile-padded [T + Vp + T, B] label matrix (+inf end tiles and padded
    rows, 30% of the other elements +inf, the rest in [0, 10)) and [K, Vp]
    planes (20% +inf, +inf on the padded rows), Vp = V rounded up to the tile."""
    import torch

    Vp = -(-V // tile) * tile
    d = np.full((tile + Vp + tile, B), np.inf, np.float32)
    body = rng.uniform(0, 10, (V, B)).astype(np.float32)
    body[rng.uniform(size=body.shape) < 0.3] = np.inf
    d[tile:tile + V] = body
    planes = np.full((len(offsets), Vp), np.inf, np.float32)
    planes[:, :V] = rng.uniform(0, 1, (len(offsets), V))
    planes[:, :V][rng.uniform(size=(len(offsets), V)) < 0.2] = np.inf
    return torch.from_numpy(d).to(device), torch.from_numpy(planes).to(device)


def sweep_pair(d, planes, offsets, tile: int, n_inner: int) -> dict:
    """The fused sweep kernel against its plain version on the same input:
    bit for bit (max_abs_err over the elements both leave finite, and the
    same finite set)."""
    import torch
    from mesh_navigation_torch.ops import sweep_gpu as sg

    k = sg.fused_sweep(d, planes, offsets, tile=tile, n_inner=n_inner)
    p = sg._fused_sweep_plain(d, planes, offsets, tile, n_inner)
    fin = torch.isfinite(p)
    res = {"bitwise": bool(torch.equal(k, p)),
           "same_finite_set": bool(torch.equal(fin, torch.isfinite(k))),
           "max_abs_err": float((k[fin] - p[fin]).abs().max()) if bool(fin.any()) else 0.0,
           "changed": int((p != d).sum())}
    if not (res["bitwise"] and res["max_abs_err"] == 0.0):
        raise AssertionError(f"fused_sweep kernel disagrees with its plain version: {res}")
    return res


def sweep_kernel_check(device) -> tuple[dict, float]:
    """Phase 2, sweep_kernel_check: the fused sweep kernel against its plain
    version, bit for bit, at tile 256 with n_inner 1, 2 and 3, offsets of
    +-tile, 8, 24 and 128 lanes and vertex counts that are not multiples of
    the tile; and at the 1M terrain's offsets and tile on a small matrix."""
    rng = np.random.default_rng(SEED + 6)
    cases = [(256, 1000, 8, 1, (1, -1, 256, -256)),
             (256, 1500, 24, 2, (1, -1, 40, -40, 41, -41)),
             (256, 2300, 128, 3, (-256, 256, 3, -7, 200)),
             (1280, 6000, 128, 2, (1, -1, 1024, -1024, 1025, -1025))]
    out = []
    with uncounted():
        for tile, V, B, n_inner, offsets in cases:
            d, planes = sweep_inputs(rng, tile, V, B, offsets, device)
            r = sweep_pair(d, planes, offsets, tile, n_inner)
            r.update(tile=tile, V=V, lanes=B, n_inner=n_inner, offsets=list(offsets))
            out.append(r)
    return ({"phase": "sweep_kernel_check", "cases": out,
             "bitwise_all": all(c["bitwise"] for c in out)},
            max(c["max_abs_err"] for c in out))


def structured(device, ctx, iters: int, batch: int = STRUCTURED_BATCH) -> tuple[dict, dict]:
    """Phase 14: the structured Dijkstra tier at full width on the main
    path's terrain and steepness costs (cost_limit 2.0, edge_cost_factor
    1.0): the host offset classification (timed), then one warm-up and
    `iters` timed DijkstraPlanner.plan_batch_structured calls with `batch`
    lanes, starts and goals on vertices drawn from the seed, each followed
    by one MeshController.compute_velocity cycle on the result's vector map.
    Gates: converged on every solve, the fused sweep launched, sane
    outputs."""
    import torch
    from mesh_navigation_torch.config import ControllerConfig, PlannerConfig
    from mesh_navigation_torch.control import MeshController
    from mesh_navigation_torch.control.controller import initial_state
    from mesh_navigation_torch.ops import kernels, sweeps
    from mesh_navigation_torch.ops import structured as st
    from mesh_navigation_torch.planners import DijkstraPlanner
    from mesh_navigation_torch.utils.timing import StageTimer

    mesh, v, costs_np = ctx["mesh"], ctx["v"], ctx["costs_np"]
    mesh_n = int(round(np.sqrt(mesh.num_vertices)))
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    costs = torch.from_numpy(costs_np).to(device)
    W = sweeps.slot_weights_np(mesh, costs_np, cost_limit=2.0, edge_cost_factor=1.0)
    planner = DijkstraPlanner(mesh, PlannerConfig(cost_limit=2.0), grid=ctx["planner"].grid,
                              max_path_len=max(2048, 3 * mesh_n), device=device)
    ctrl = MeshController(mesh, ControllerConfig(), grid=planner.grid, device=device)
    tp = time.perf_counter()
    oplan = planner.prepare_offset_plan(W)
    sync(device)
    plan_s = time.perf_counter() - tp
    Wt = torch.from_numpy(W).to(device)
    tile = st.default_tile(oplan)
    n_inner = st.default_n_inner(oplan, tile)
    sync(device)
    t_setup = time.perf_counter() - t0
    log(f"# structured set-up {t_setup:.1f} s (offset plan {plan_s:.1f} s): offsets "
        f"{oplan.offsets}, coverage {oplan.coverage}, tile {tile}, n_inner {n_inner}")
    rng = np.random.default_rng(SEED + 5)
    q = torch.tensor([[0.0, 0.0, 0.0, 1.0]]).expand(batch, 4)

    def sample():
        p = v[rng.integers(0, mesh.num_vertices, 2 * batch)].astype(np.float32)
        return p[:batch], p[batch:]

    def step(s, g, timer=None):
        res = planner.plan_batch_structured(Wt, oplan, torch.from_numpy(s), torch.from_numpy(g),
                                            timer=timer)
        stt = initial_state(torch.from_numpy(g).to(device), torch.tensor([1.0, 0.0, 0.0]))
        cmds, _ = ctrl.compute_velocity(res.vector_map, costs, torch.from_numpy(s), q, stt,
                                        timer=timer)
        return res, cmds

    kernels.reset_launches()
    warm = sample()
    tw = time.perf_counter()
    warm_res, cmds = step(*warm)
    sync(device)
    t_warm = time.perf_counter() - tw
    solves = [{"sweeps": warm_res.rounds, "converged": bool(warm_res.converged)}]
    warm_small = {"potential": warm_res.potential[:2].cpu().numpy(),
                  "pred": warm_res.pred[:2].cpu().numpy(), "cost": warm_res.cost[:2].cpu().numpy()}
    warm_res = cmds = None
    timer = StageTimer(device)
    t1 = time.perf_counter()
    res = None
    for _ in range(iters):
        res = cmds = None
        res, cmds = step(*sample(), timer=timer)
        solves.append({"sweeps": res.rounds, "converged": bool(res.converged)})
    sync(device)
    dt = time.perf_counter() - t1
    launches = {name: kernels.LAUNCHES[name] for name in STRUCTURED_KERNELS}
    for name, n in launches.items():
        if n <= 0 and cuda:
            raise AssertionError(f"kernel {name} was not launched on the structured path")
    if not all(x["converged"] for x in solves):
        raise AssertionError(f"a structured solve did not converge: {solves}")
    ok_lanes = res.outcome == 0
    V = mesh.num_vertices
    checks = {
        "shapes": list(res.path_positions.shape) == [batch, planner.max_path_len, 3]
        and list(res.vector_map.shape) == [batch, V, 3] and list(res.pred.shape) == [batch, V]
        and list(res.potential.shape) == [batch, V] and list(cmds.linear.shape) == [batch],
        "reach_rate": float(ok_lanes.float().mean()),
        "costs_finite_where_reached": bool(torch.isfinite(res.cost[ok_lanes]).all()),
        "vector_map_finite": bool(torch.isfinite(res.vector_map).all()),
        "commands_finite": bool(torch.isfinite(cmds.linear).all()
                                and torch.isfinite(cmds.angular).all()),
        "control_success_rate": float((cmds.outcome == 0).float().mean()),
    }
    if not (checks["shapes"] and checks["costs_finite_where_reached"]
            and checks["vector_map_finite"] and checks["commands_finite"]
            and checks["reach_rate"] > 0.5):
        raise AssertionError(f"structured output check failed: {checks}")
    stages = {k: val / iters for k, val in timer.totals().items()}
    peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
    res = cmds = None
    trace = device_busy(lambda: step(*sample()), device)
    out = {
        "phase": "structured", "mesh": f"{mesh_n}x{mesh_n}", "V": V, "lanes": batch,
        "dtype": "float32", "offsets": list(oplan.offsets), "coverage": oplan.coverage,
        "tile": tile, "n_inner": n_inner, "offset_plan_s": plan_s,
        "setup_s": t_setup, "warmup_s": t_warm, "iters": iters,
        "solves_per_s": batch * iters / dt, "ms_per_iter": dt * 1e3 / iters,
        "solves": solves, "stage_ms_per_iter": stages, "launches": launches,
        "launches_per_solve": {k: n / (iters + 1) for k, n in launches.items()},
        "checks": checks, "trace": trace, "peak_mem_gb": peak,
    }
    return out, dict(planner=planner, oplan=oplan, Wt=Wt, tile=tile, n_inner=n_inner,
                     warm=warm, warm_small=warm_small, launches=launches)


def full_result_oracle(ctx, planner, starts, goals, ws) -> list:
    """The lanes of a full plan result (`ws`: potential, pred and cost of
    the first lanes, numpy) against the native heap Dijkstra on the same
    costs: the field's largest relative error and the walked path cost
    against the native predecessor chain's
    (tests/test_baseline_parity.py:54-61)."""
    import torch
    from mesh_navigation_torch.mesh import query

    dev = planner.device
    sv = query.nearest_vertex_batch(planner.mesh, planner.grid, torch.from_numpy(starts).to(dev))[0]
    gv = query.nearest_vertex_batch(planner.mesh, planner.grid, torch.from_numpy(goals).to(dev))[0]
    sv, gv = sv.cpu().numpy(), gv.cpu().numpy()
    v = ctx["v"]
    lanes = []
    for b, (od, opred) in enumerate(native_fields(v, ctx["f"], ctx["costs_np"], gv)):
        pot = ws["potential"][b]
        fin = np.isfinite(od)
        rel = float(np.max(np.abs(pot[fin] - od[fin]) / np.maximum(od[fin], 1e-3)))
        chain = [int(sv[b])]
        while chain[-1] != gv[b] and opred[chain[-1]] != chain[-1] and len(chain) < len(v):
            chain.append(int(opred[chain[-1]]))
        ref_cost = float(np.linalg.norm(np.diff(v[chain], axis=0), axis=1).sum())
        got = float(ws["cost"][b])
        lanes.append({"max_rel_err": rel,
                      "same_finite_set": bool(np.array_equal(np.isfinite(pot), fin)),
                      "path_cost": got, "native_chain_cost": ref_cost,
                      "path_cost_rel_err": abs(got - ref_cost) / max(ref_cost, 1e-6),
                      "native_chain_steps": len(chain),
                      "pred_equal_share": float(np.mean(ws["pred"][b] == opred))})
    return lanes


def full_result_gate(phase: str, lanes: list) -> dict:
    out = {"phase": phase, "lanes": lanes, "budget": 0.01,
           "max_rel_err": max(x["max_rel_err"] for x in lanes)}
    if not all(x["max_rel_err"] < 0.01 and x["same_finite_set"] and x["path_cost_rel_err"] < 0.01
               for x in lanes):
        raise AssertionError(f"{phase} gate failed: {out}")
    return out


def structured_oracle_gate(ctx, sctx, n_lanes: int = 2) -> dict:
    """Phase 15: two lanes of the structured warm-up solve against the native
    heap Dijkstra: the field's largest relative error and the path cost
    against the native predecessor chain's, both below 1%."""
    s, g = (x[:n_lanes] for x in sctx["warm"])
    return full_result_gate("structured_oracle",
                            full_result_oracle(ctx, sctx["planner"], s, g, sctx["warm_small"]))


def kernels_at_structured_shapes(sctx, device) -> tuple[dict, dict]:
    """Phase 16: the fused sweep at the structured path's shape, on the
    path's own field after STRUCTURED_WAVE_SWEEPS sweeps of the warm-up
    draw's solve: one launch held against the plain version bit for bit, the
    launch's time (mean of 10 event-timed launches after one warm-up) and the
    plain version's. The bound is one read and one write of the matrix and
    one read of the planes, (2 (Vp + 2T) B + K Vp) * 4 bytes, against
    n_inner * K add + min pairs per element. Not counted for the path."""
    import torch
    from mesh_navigation_torch.mesh import query
    from mesh_navigation_torch.ops import structured as st
    from mesh_navigation_torch.ops import sweep_gpu as sg

    planner, oplan = sctx["planner"], sctx["oplan"]
    tile, n_inner = sctx["tile"], sctx["n_inner"]
    _, g = sctx["warm"]
    gv = query.nearest_vertex_batch(planner.mesh, planner.grid, torch.from_numpy(g).to(device))[0]
    V = planner.mesh.num_vertices
    B = gv.shape[0]
    K = len(oplan.offsets)
    Vp = -(-V // tile) * tile
    planes = torch.full((K, Vp), np.inf, dtype=torch.float32, device=device)
    planes[:, :V] = oplan.planes
    with uncounted():
        d = st.seeded_padded(V, gv, tile)
        spare = torch.empty_like(d)
        for _ in range(STRUCTURED_WAVE_SWEEPS):
            d, spare = sg.fused_sweep(d, planes, oplan.offsets, tile=tile, n_inner=n_inner,
                                      out=spare), d
        pair = sweep_pair(d, planes, oplan.offsets, tile, n_inner)
        run = lambda: sg.fused_sweep(d, planes, oplan.offsets, tile=tile,   # noqa: E731
                                     n_inner=n_inner, out=spare)
        time_ms(run, device)                                                  # warm
        ms = time_ms(run, device, reps=10)
        plain_ms = time_ms(lambda: sg._fused_sweep_plain(d, planes, oplan.offsets, tile,
                                                         n_inner), device)
    bytes_s = (2 * (Vp + 2 * tile) * B + K * Vp) * 4 / HBM_BYTES_PER_S
    ops_s = n_inner * K * 2 * Vp * B / F32_OPS_PER_S
    detail = {"phase": "kernels_at_structured_shapes", "matrix": list(d.shape), "tile": tile,
              "n_inner": n_inner, "offsets": list(oplan.offsets),
              "input_after_sweeps": STRUCTURED_WAVE_SWEEPS, "pair": pair,
              "ms": ms, "plain_ms": plain_ms, "bound_ms": max(bytes_s, ops_s) * 1e3}
    return detail, {"ms": ms, "plain_ms": plain_ms, "bound_ms": max(bytes_s, ops_s) * 1e3,
                    "bound_by": "bytes" if bytes_s >= ops_s else "operations",
                    "max_abs_err": pair["max_abs_err"]}


def irregular(device, mesh_n: int, iters: int, batch: int = IRREGULAR_BATCH) -> tuple[dict, dict]:
    """Phase 17: the irregular-mesh stage (bench.py:559-614) at full width: a
    jittered-Delaunay terrain of mesh_n x mesh_n vertices, band-reordered
    (mesh/reorder.build_reordered_mesh), steepness costs, slot weights, the
    banded plan with its residual edges and extended lanes, then one warm-up
    and `iters` timed DijkstraPlanner.plan_batch_banded(light=True) calls
    with `batch` lanes at atol 1e-3 / rtol 2e-3 (a quiet-round solve with
    the residual scatter-min, the residual class table, the class-9 walk),
    each followed by one MeshController.compute_velocity_banded cycle.
    Gates: converged on every solve, the pass kernel launched in its dirty
    mode and the class-pred kernel launched, sane outputs."""
    import torch
    from mesh_navigation_torch.config import ControllerConfig, PlannerConfig
    from mesh_navigation_torch.control import MeshController
    from mesh_navigation_torch.control.controller import initial_state
    from mesh_navigation_torch.mesh import reorder, synthetic
    from mesh_navigation_torch.mesh.arrays import host_array
    from mesh_navigation_torch.ops import kernels
    from mesh_navigation_torch.planners import DijkstraPlanner
    from mesh_navigation_torch.utils.timing import StageTimer

    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    vi, fi = synthetic.irregular_terrain_mesh(mesh_n, mesh_n, spacing=0.5, jitter=0.45,
                                              hills=2.0, roughness=0.01, seed=1)
    t_delaunay = time.perf_counter() - t0
    mesh = reorder.build_reordered_mesh(vi, fi, device=device)
    t_mesh = time.perf_counter() - t0
    costs_np, costs, W = steepness_weights(mesh)
    planner = DijkstraPlanner(mesh, PlannerConfig(cost_limit=2.0),
                              max_path_len=max(2048, 3 * mesh_n), device=device)
    ctrl = MeshController(mesh, ControllerConfig(), grid=planner.grid, device=device)
    tp = time.perf_counter()
    kplan = planner.prepare_banded_plan(W)
    if kplan is None or not kplan.n_residual:
        raise RuntimeError("no banded plan with residual edges for the irregular mesh")
    sync(device)
    plan_s = time.perf_counter() - tp
    t_setup = time.perf_counter() - t0
    plan_info = {"n_rows": kplan.n_rows, "n_cols": kplan.n_cols,
                 "n_cols_pad": kplan.n_cols_pad, "coverage": kplan.coverage,
                 "n_residual": kplan.n_residual, "n_res_dst": kplan.n_res_dst,
                 "xlanes_down": [list(x) for x in kplan.xlanes_down],
                 "xlanes_up": [list(x) for x in kplan.xlanes_up]}
    log(f"# irregular set-up {t_setup:.1f} s (Delaunay {t_delaunay:.1f} s, mesh "
        f"{t_mesh:.1f} s, plan {plan_s:.1f} s): {plan_info}")
    rng = np.random.default_rng(SEED + 8)

    def step(s, g, q, timer=None):
        st = initial_state(torch.from_numpy(g).to(device), torch.tensor([1.0, 0.0, 0.0]))
        res = planner.plan_batch_banded(kplan, torch.from_numpy(s), torch.from_numpy(g),
                                        atol=IRREGULAR_ATOL, rtol=IRREGULAR_RTOL, timer=timer)
        cmds, _ = ctrl.compute_velocity_banded(
            kplan, res.d_pad.reshape(-1, res.d_pad.shape[-1]), costs, torch.from_numpy(s),
            torch.from_numpy(q), st, tol=1e-5, lane_map=res.lane_map, timer=timer)
        return res, cmds

    kernels.reset_launches()
    warm = sample_scenarios(rng, mesh_n, batch)
    tw = time.perf_counter()
    warm_res, cmds = step(*warm)
    sync(device)
    t_warm = time.perf_counter() - tw
    solves = [{"rounds": warm_res.rounds, "converged": bool(warm_res.converged)}]
    timer = StageTimer(device)
    res = None
    t1 = time.perf_counter()
    for _ in range(iters):
        res = cmds = None
        res, cmds = step(*sample_scenarios(rng, mesh_n, batch), timer=timer)
        solves.append({"rounds": res.rounds, "converged": bool(res.converged)})
    sync(device)
    dt = time.perf_counter() - t1
    launches = {name: kernels.LAUNCHES[name] for name in IRREGULAR_KERNELS}
    for name, n in launches.items():
        if n <= 0 and cuda:
            raise AssertionError(f"kernel {name} was not launched on the irregular path")
    if not all(x["converged"] for x in solves):
        raise AssertionError(f"an irregular solve did not converge: {solves}")
    ok_lanes = res.outcome == 0
    checks = {
        "shapes": list(res.path_positions.shape) == [batch, planner.max_path_len, 3]
        and list(cmds.linear.shape) == [batch],
        "reach_rate": float(ok_lanes.float().mean()),
        "costs_finite_where_reached": bool(torch.isfinite(res.cost[ok_lanes]).all()),
        "commands_finite": bool(torch.isfinite(cmds.linear).all()
                                and torch.isfinite(cmds.angular).all()),
        "control_success_rate": float((cmds.outcome == 0).float().mean()),
    }
    if not (checks["shapes"] and checks["costs_finite_where_reached"]
            and checks["commands_finite"] and checks["reach_rate"] > 0.5):
        raise AssertionError(f"irregular output check failed: {checks}")
    stages = {k: val / iters for k, val in timer.totals().items()}
    peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
    res = cmds = None
    trace = device_busy(lambda: step(*sample_scenarios(rng, mesh_n, batch)), device)
    out = {
        "phase": "irregular", "mesh": f"{mesh_n}x{mesh_n}", "V": mesh.num_vertices,
        "lanes": batch, "dtype": "float32", "atol": IRREGULAR_ATOL, "rtol": IRREGULAR_RTOL,
        "plan": plan_info, "setup_s": t_setup, "delaunay_s": t_delaunay, "plan_s": plan_s,
        "warmup_s": t_warm, "iters": iters, "solves_per_s": batch * iters / dt,
        "ms_per_iter": dt * 1e3 / iters, "solves": solves, "stage_ms_per_iter": stages,
        "launches": launches, "launches_per_solve": {k: n / (iters + 1) for k, n in launches.items()},
        "checks": checks, "trace": trace, "peak_mem_gb": peak,
    }
    ctx = dict(v=host_array(mesh, "vertices"), f=host_array(mesh, "faces"), mesh=mesh,
               costs_np=costs_np, kplan=kplan, planner=planner, warm=warm, warm_res=warm_res,
               launches=launches, scan=(vi, fi))
    return out, ctx


def xl_slab_check(pass_fn, d, cross, a_fwd, a_bwd, kw: dict, r0: int, device) -> dict:
    """The extended-lane pass kernel (`pass_fn`) against its plain version on rows r0 ..
    r0 + IRREGULAR_SLAB_ROWS of one irregular-path launch's own input, at
    the path's full width and lanes with its lanes, dirty table and flags;
    rows outside the slab read as +inf to both. Fields bit for bit, dirty
    tables, flags and rows walked equal; also the plain version's time."""
    import torch
    from mesh_navigation_torch.ops import banded_gpu as bg

    r1 = min(r0 + IRREGULAR_SLAB_ROWS, d.shape[0])
    sl = lambda t: t[r0:r1].contiguous()   # noqa: E731
    d_k = d[r0:r1].clone()
    d_p = d_k.clone()
    kw_s = dict(kw, xcross=sl(kw["xcross"]), xlist=kw["xlist"].rows(r0, r1))
    dirty = kw["dirty"]
    dirty_k = dirty[:, r0:r1].clone()
    dirty_p = dirty_k.clone()
    wk = torch.zeros(1, dtype=torch.int32, device=d.device)
    wp = torch.zeros(1, dtype=torch.int64, device=d.device)
    chg_k = pass_fn(d_k, sl(cross), sl(a_fwd), sl(a_bwd),
                    **dict(kw_s, dirty=dirty_k, rows_walked=wk))
    got = []
    plain_ms = time_ms(lambda: got.append(bg.directional_pass_plain(
        d_p, sl(cross), sl(a_fwd), sl(a_bwd), bb=bg.PASS_LANES,
        **dict(kw_s, dirty=dirty_p, rows_walked=wp))), device)
    cmp = compare_fields(d_k, d_p, kw["atol"], kw["rtol"])
    cmp.update(rows=[r0, r1], shape=list(d_k.shape), force=bool(kw.get("force")),
               reverse=bool(kw["reverse"]), flags_equal=bool(chg_k.item()) == bool(got[0].item()),
               dirty_equal=bool(torch.equal(dirty_k, dirty_p)),
               dirty_rows_in=int(dirty[:, r0:r1].sum()), rows_walked=int(wk.item()),
               rows_walked_equal=int(wk.item()) == int(wp.item()),
               elements_changed=int((d_p != sl(d)).sum()), plain_ms=plain_ms)
    if not (cmp["bitwise"] and cmp["flags_equal"] and cmp["dirty_equal"]
            and cmp["rows_walked_equal"] and cmp["elements_changed"] > 0):
        raise AssertionError(f"the extended-lane pass kernel disagrees with its plain version "
                             f"on the irregular path's input: {cmp}")
    return cmp


def kernels_at_irregular_shapes(ictx, device) -> tuple[dict, dict]:
    """Phase 19: the solve of one more plan_batch_banded call on the warm-up
    draw, pass by pass: each pass launch timed by its own event pair, with
    the rows its blocks walked and its bound from what that launch's data
    needs (one read of the field, the cross planes, level 0 of the chain
    weights and the extended lanes' lists, the dirty table read and
    written, one write of each element it changed; against PASS_OPS an
    element and XLANE_OPS a listed edge and lane); each residual
    scatter-min timed the same way. torch.profiler traces the solve: each
    launch's prescan and walker ms by kernel name, and the walker's us a
    walked row of a block over the solve. The first forced down pass and the first
    dirty-driven up pass that changes labels are held against the plain
    version on a slab of their own input (xl_slab_check). Beside them, on
    the solve's field at the same lanes, a forced down pass with the lanes
    and one of the main walker without them (no dirty table, so no
    prescan: every row walked). Then the class-pred kernel on the solve's field
    against its plain version, its time and bound, and the walk kernel's
    class-9 decode against its plain loop (walk_check). Not counted for the
    path."""
    import torch
    from mesh_navigation_torch.mesh import query
    from mesh_navigation_torch.ops import banded_gpu as bg

    planner, kplan = ictx["planner"], ictx["kplan"]
    s, g, _ = ictx["warm"]
    times, bounds_b, walked, slabs, scatter_ms = [], [], [], {}, []
    kinds = []     # each launch of the pass kernel in the trace: "path" or "slab"
    orig_pass, orig_res = bg.directional_pass, bg._residual_round

    def timed_pass(d, cross, a_fwd, a_bwd, **kw):
        Rp, Cp, Bp = d.shape
        nb = Bp // bg.PASS_LANES
        key = "forced" if kw.get("force") else "dirty"
        want_slab = key not in slabs and (key == "forced" or kw["reverse"])
        if want_slab:
            d_in, dirty_in = d.clone(), kw["dirty"].clone()
        before = d.clone()
        nw = torch.zeros(1, dtype=torch.int32, device=d.device)
        got = []
        kinds.append("path")
        times.append(time_ms(lambda: got.append(orig_pass(d, cross, a_fwd, a_bwd,
                                                          **dict(kw, rows_walked=nw))),
                             device))
        diff = d != before
        del before
        n_written = int(diff.sum())
        walked.append(int(nw.item()) / (Rp * nb))
        planes = 5 * Rp * Cp * 4 + xlist_size(kw.get("xlist"), Cp)[0]
        bounds_b.append(((Rp * Cp * Bp + 2 * nb * Rp + n_written) * 4 + planes)
                        / HBM_BYTES_PER_S)
        if want_slab and n_written:
            rows = diff.any(dim=2).any(dim=1).nonzero()[:, 0]
            r = int(rows[len(rows) // 2])
            r0 = max(0, min(r - IRREGULAR_SLAB_ROWS // 2, Rp - IRREGULAR_SLAB_ROWS))
            kinds.append("slab")
            slabs[key] = xl_slab_check(orig_pass, d_in, cross, a_fwd, a_bwd,
                                       dict(kw, dirty=dirty_in), r0, device)
        if want_slab:
            del d_in, dirty_in
        return got[0]

    def timed_res(*a, **kw):
        got = []
        scatter_ms.append(time_ms(lambda: got.append(orig_res(*a, **kw)), device))
        return got[0]

    bg.directional_pass, bg._residual_round = timed_pass, timed_res
    try:
        with uncounted(), kernel_trace(device) as tr:
            goal_v = query.nearest_vertex_batch(planner.mesh, planner.grid,
                                                torch.from_numpy(g).to(device))[0]
            order, _ = bg.group_lanes(goal_v, kplan.num_vertices)
            res = bg.banded_solve_padded(kplan, goal_v[order], max_rounds=256,
                                         atol=IRREGULAR_ATOL, rtol=IRREGULAR_RTOL)
    finally:
        bg.directional_pass, bg._residual_round = orig_pass, orig_res
    if set(slabs) != {"forced", "dirty"}:
        raise AssertionError(f"the irregular solve gave no forced or no dirty-driven pass "
                             f"to check: {sorted(slabs)}")
    d = res.d_pad
    Rp, Cp, Bp = d.shape
    N = Rp * Cp * Bp
    xl_edges = [xlist_size(kplan.xlist_down, Cp)[1], xlist_size(kplan.xlist_up, Cp)[1]]
    ops_s = (PASS_OPS * N + XLANE_OPS * max(xl_edges) * Bp) / F32_OPS_PER_S
    bounds = [max(b, ops_s) * 1e3 for b in bounds_b]
    # the prescan's and the walker's ms of each path launch (every launch of
    # this solve has the dirty table: one prescan, one walker), and the
    # walker's us a walked row of a block over the whole solve (a launch
    # that walks few rows spends its time on the jumps between them)
    pre_ms, walk_ms = tr.ms("banded_prescan_kernel"), tr.ms("banded_pass_kernel")
    split = None
    if len(pre_ms) == len(walk_ms) == len(kinds):
        path = [i for i, k in enumerate(kinds) if k == "path"]
        split = {"prescan_ms": [pre_ms[i] for i in path],
                 "walker_ms": [walk_ms[i] for i in path]}
        split["walker_us_per_walked_row"] = (sum(split["walker_ms"]) * 1e3
                                             / max(sum(walked) * Rp, 1e-9))
    # a forced down pass over the solve's field with the lanes, and the main
    # walker's without them: no dirty table (no prescan), every row walked
    # and nearly every row scanned
    prob = bg.prepare_padded(kplan, goal_v[order], seeded=False)
    forced = {}
    with uncounted():
        for name, xkw in (("with_lanes", dict(xcross=prob.xdown, xlanes=kplan.xlanes_down,
                                              xlist=prob.xlist_down)),
                          ("main_walker", {})):
            dm = d.clone()
            nw = torch.zeros(1, dtype=torch.int32, device=d.device)
            ms = time_ms(lambda: orig_pass(dm, prob.down, prob.a_fwd, prob.a_bwd,
                                           reverse=False, force=True, atol=IRREGULAR_ATOL,
                                           rtol=IRREGULAR_RTOL, rows_walked=nw, **xkw), device)
            rows_a_block = int(nw.item()) / (Bp // bg.PASS_LANES)
            forced[name] = {"ms": ms, "rows_a_block": rows_a_block,
                            "us_per_row": ms * 1e3 / rows_a_block}
            del dm
    tol = max(1e-5, 3.0 * IRREGULAR_RTOL)
    with uncounted():
        pred = check_pred_pair(kplan, d, IRREGULAR_ATOL, IRREGULAR_RTOL, tol=tol)
        w8 = bg._w8_planes(kplan, Rp)
        kw = dict(R=kplan.n_rows, C=kplan.n_cols, V=kplan.num_vertices, tol=tol)
        time_ms(lambda: bg.class_pred(d, w8, **kw), device)                   # warm
        pred_ms = time_ms(lambda: bg.class_pred(d, w8, **kw), device, reps=5)
        recon_ms = time_ms(lambda: bg.predecessors_banded_classes_residual(kplan, d, tol=tol),
                           device)
    walk = walk_check(planner, kplan, s, g, IRREGULAR_ATOL, IRREGULAR_RTOL, device)
    pred_bytes = N * 4 + kplan.num_vertices * Bp + 8 * Rp * Cp * 4
    pred_bound = max(pred_bytes / HBM_BYTES_PER_S, PRED_OPS * N / F32_OPS_PER_S) * 1e3
    detail = {"phase": "kernels_at_irregular_shapes", "field": [Rp, Cp, Bp],
              "rounds": res.rounds, "converged": res.converged,
              "xlanes": [len(kplan.xlanes_down), len(kplan.xlanes_up)],
              "xlist_edges": xl_edges,
              "xlist_max_row": [kplan.xlist_down.max_row, kplan.xlist_up.max_row],
              "pass_launch_ms": times, "pass_bound_ms": bounds,
              "pass_rows_walked_share": walked, "pass_split": split,
              "pass_split_note": None if split else (
                  "torch.profiler showed no device time for the pass kernels"),
              "forced_pass_on_the_field": forced, "residual_scatter_ms": scatter_ms,
              "path_slab_checks": slabs, "pred": pred, "pred_ms": pred_ms,
              "pred_with_reconcile_ms": recon_ms, "pred_bound_ms": pred_bound, "walk": walk}
    for i, (t, b, w) in enumerate(zip(times, bounds, walked)):
        log(f"# irregular pass {i}: {t:.3f} ms (bound {b:.3f} ms), rows walked share {w:.4f}"
            + ("" if split is None else
               f", prescan {split['prescan_ms'][i]:.3f} ms, walker {split['walker_ms'][i]:.3f}"
               " ms"))
    log(f"# irregular forced pass on the field: {forced}")
    return detail, {"ms": float(np.mean(times)), "bound_ms": float(np.mean(bounds)),
                    "rows_walked_share": float(np.mean(walked)),
                    "prescan_ms": None if split is None else float(np.mean(split["prescan_ms"])),
                    "walker_ms": None if split is None else float(np.mean(split["walker_ms"])),
                    "walker_us_per_walked_row": (None if split is None
                                                 else split["walker_us_per_walked_row"]),
                    "forced_us_per_row": forced["with_lanes"]["us_per_row"],
                    "main_walker_us_per_row": forced["main_walker"]["us_per_row"],
                    "max_abs_err": max(c["max_abs_err"] for c in slabs.values()),
                    "pred_ms": pred_ms, "pred_bound_ms": pred_bound,
                    "pred_max_abs_err": float(pred["max_abs_err"]),
                    "walk": walk}


def server_cvp(device, ctx, iters: int, batch: int = CVP_BATCH) -> tuple[dict, dict]:
    """Phase 20: the navigation server's CVP kind (the reference's default,
    api/server.py:73) on the main path's terrain with the replan phase's
    layers: set-up, one warm-up and `iters` timed get_path_batch calls of
    `batch` lanes on vertices (the eikonal pass and the warm banded pass
    through the server), then the replan phase's first jump cloud through
    update_point_cloud and one more get_path_batch on the warm-up lanes,
    which rebuilds the plan the update marked stale. Gates: converged on
    every solve, both kernels launched, two lanes against the native fast
    marching on the server's current costs before and after the update,
    and the post-update field bit for bit equal to plan_batch_banded on a
    plan built afresh from the server's edge weights and costs (and unlike
    the pre-update field near the obstacle); the post-update solve's first
    forced eik_pass held against the plain pass on a 4-row slab."""
    import torch
    from mesh_navigation_torch.api.server import MeshNavServer
    from mesh_navigation_torch.ops import eikonal_gpu as eg
    from mesh_navigation_torch.ops import kernels
    from mesh_navigation_torch.planners import CVPPlanner
    from mesh_navigation_torch.utils.timing import StageTimer

    mesh, v = ctx["mesh"], ctx["v"]
    mesh_n = int(round(np.sqrt(mesh.num_vertices)))
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    srv = MeshNavServer(mesh, replan_config(), grid=ctx["planner"].grid,
                        max_path_len=max(2048, 3 * mesh_n), device=device)
    sync(device)
    t_setup = time.perf_counter() - t0
    if srv.planner_kind != "cvp" or srv.eikonal_plan is None or srv.planner._dij_plan is None:
        raise AssertionError("the default server is not a CVP server with an eikonal plan")
    log(f"# server_cvp set-up {t_setup:.1f} s")
    rng = np.random.default_rng(SEED + 4)

    def sample():
        p = v[rng.integers(0, mesh.num_vertices, 2 * batch)].astype(np.float32)
        return torch.from_numpy(p[:batch]), torch.from_numpy(p[batch:])

    kernels.reset_launches()
    warm = sample()
    tw = time.perf_counter()
    warm_res = srv.get_path_batch(*warm)
    sync(device)
    t_warm = time.perf_counter() - tw
    solves = [{"rounds": warm_res.rounds, "converged": bool(warm_res.converged)}]
    timer = StageTimer(device)
    t1 = time.perf_counter()
    for _ in range(iters):
        res = srv.get_path_batch(*sample(), timer=timer)
        solves.append({"rounds": res.rounds, "converged": bool(res.converged)})
    sync(device)
    dt = time.perf_counter() - t1
    res = None
    stages = {k: val / iters for k, val in timer.totals().items()}
    before_costs = srv.vertex_costs.cpu().numpy()
    cctx = dict(planner=srv.planner, kplan=srv.eikonal_plan, warm_res=warm_res,
                warm=tuple(x.numpy() for x in warm),
                ew=srv.edge_weights, ew_np=srv.edge_weights.cpu().numpy())
    with uncounted():
        oracle_before = cvp_oracle_gate(ctx, cctx, costs_np=before_costs,
                                        phase="server_cvp_oracle_before")

    # the replan phase's first jump cloud (its rng: the seeds, then the clouds)
    crng = np.random.default_rng(SEED + 2)
    crng.integers(0, mesh.num_vertices, REPLAN_BATCH)
    cloud = update_clouds(crng, v, mesh_n)[0][1]
    tu = time.perf_counter()
    srv.update_point_cloud("obst", torch.from_numpy(cloud).to(device))
    sync(device)
    t_update = time.perf_counter() - tu
    if not srv.eikonal_stale:
        raise AssertionError("update_point_cloud left the CVP plan fresh")
    first_forced = {}
    orig = eg.eik_pass

    def keep_first_forced(d, abc, cls, dirty, **kw):
        if kw.get("force") and not first_forced:
            first_forced.update(d=d, abc=abc, cls=cls, dirty=dirty, kw=kw)
        return orig(d, abc, cls, dirty, **kw)

    rtimer = StageTimer(device)
    eg.eik_pass = keep_first_forced
    try:
        tr = time.perf_counter()
        post = srv.get_path_batch(*warm, timer=rtimer)
        sync(device)
        t_post = time.perf_counter() - tr
    finally:
        eg.eik_pass = orig
    launches = {name: kernels.LAUNCHES[name] for name in CVP_KERNELS}
    solves.append({"rounds": post.rounds, "converged": bool(post.converged), "after_update": True})
    rebuild_s = rtimer.totals().get("rebuild", 0.0) / 1e3
    if not all(x["converged"] for x in solves):
        raise AssertionError(f"a server_cvp solve did not converge: {solves}")
    for name, n in launches.items():
        if n <= 0 and cuda:
            raise AssertionError(f"kernel {name} was not launched on the server_cvp path")
    costs_np = srv.vertex_costs.cpu().numpy()
    lethal = int(np.isinf(costs_np).sum() - np.isinf(before_costs).sum())
    if lethal <= 0:
        raise AssertionError("the jump cloud made no vertex lethal")
    cctx.update(kplan=srv.eikonal_plan, warm_res=post, ew=srv.edge_weights,
                ew_np=srv.edge_weights.cpu().numpy())
    with uncounted():
        oracle_after = cvp_oracle_gate(ctx, cctx, costs_np=costs_np,
                                       phase="server_cvp_oracle_after")
        fresh = CVPPlanner(mesh, srv.config.planner, grid=srv.grid,
                           max_path_len=srv.planner.max_path_len, device=device)
        fplan = fresh.prepare_eikonal_plan(cctx["ew_np"], costs_np)
        want = fresh.plan_batch_banded(srv.edge_weights, fplan, *warm)
        fresh_equal = {k: bool(torch.equal(getattr(post, k), getattr(want, k)))
                       for k in ("d_pad", "outcome", "path_positions", "path_valid", "cost")}
        del fresh, fplan, want
        R, C, Cp = srv.eikonal_plan.n_rows, srv.eikonal_plan.n_cols, srv.eikonal_plan.n_cols_pad
        center = cloud[:, :2].mean(axis=0)
        near = np.nonzero(np.linalg.norm(v[:, :2] - center, axis=1) < 3.0)[0]
        rows = torch.from_numpy((near // C) * Cp + near % C).to(device)
        d_post = post.d_pad.reshape(-1, post.d_pad.shape[-1])[rows, :batch]
        d_pre = warm_res.d_pad.reshape(-1, warm_res.d_pad.shape[-1])[rows, :batch]
        near_changed = int((d_post != d_pre).sum())
        ff = first_forced
        r0 = max(0, ff["d"].shape[0] // 2 - EIK_SLAB_ROWS // 2)
        slab = eik_slab_check(orig, ff["d"], ff["abc"], ff["cls"], ff["dirty"], r0, ff["kw"],
                              device)
    first_forced.clear()
    if not all(fresh_equal.values()) or near_changed == 0:
        raise AssertionError(f"the post-update batch is not the fresh plan's: {fresh_equal}, "
                             f"{near_changed} field entries changed near the obstacle")
    peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
    trace = device_busy(lambda: srv.get_path_batch(*sample()), device)
    out = {
        "phase": "server_cvp", "mesh": f"{mesh_n}x{mesh_n}", "V": mesh.num_vertices,
        "lanes": batch, "setup_s": t_setup, "warmup_s": t_warm, "iters": iters,
        "solves_per_s": batch * iters / dt, "ms_per_iter": dt * 1e3 / iters,
        "stage_ms_per_iter": stages, "solves": solves, "launches": launches,
        "update_s": t_update, "rebuild_s": rebuild_s, "post_update_call_s": t_post,
        "lethal_vertices_added": lethal, "oracle_before": oracle_before,
        "oracle_after": oracle_after, "fresh_plan_bitwise": fresh_equal,
        "near_obstacle_entries_changed": near_changed, "slab_check": slab,
        "trace": trace, "peak_mem_gb": peak,
    }
    return out, dict(srv=srv, launches=launches,
                     slab_max_abs_err=slab["max_abs_err"])


# navigate's pairs: seeds SEED + k of navigation_pair; two (a Dijkstra
# success and a stall), so that the script keeps inside its time limit on a
# slow host (each navigation takes 16-40 s at 1M)
NAV_PAIRS = (5, 6)
# the outcome of the reference's navigate loop with the port's surface
# projection on each pair, by (mesh_n, nav_dist) of the phase:
# tests/navigate_pairs.py on windows of the terrain. Two faults of the
# reference's control law (ROADMAP queue C) sink pairs: the Dijkstra robot's
# staircase stall (pair 6 at 1M), and the CVP robot circling its goal
# just outside dist_tolerance (pair 5 of the CPU rehearsal's 64 x 64 map).
REFERENCE_NAV_OUTCOMES = {
    (1024, 25.0): {"dijkstra": ("SUCCESS", "PAT_EXCEEDED"), "cvp": ("SUCCESS", "SUCCESS")},
    (64, 10.0): {"dijkstra": ("SUCCESS", "SUCCESS"), "cvp": ("PAT_EXCEEDED", "SUCCESS")},
}


def navigation_pair(v, ny: int, rng, dist: float, spacing: float = 0.5):
    """A goal drawn from `rng` over the terrain (at least dist + 3 m from its
    edge) and a start `dist` metres away in a drawn direction, snapped to
    its nearest grid vertex; both 0.05 above the surface."""
    nx = len(v) // ny
    margin = dist + 3.0
    gx, gy = rng.uniform(margin, [(nx - 1) * spacing - margin, (ny - 1) * spacing - margin])
    ang = rng.uniform(0.0, 2.0 * np.pi)
    si, sj = (int(np.rint((gx + dist * np.cos(ang)) / spacing)),
              int(np.rint((gy + dist * np.sin(ang)) / spacing)))
    gz = v[int(np.rint(gx / spacing)) * ny + int(np.rint(gy / spacing)), 2]
    start = v[si * ny + sj] + np.float32([0.0, 0.0, 0.05])
    return start.astype(np.float32), np.float32([gx, gy, gz + 0.05])


def server_single(device, ctx, scctx, dsrv, nav_dist: float = 25.0,
                  max_cycles: int = 3000) -> dict:
    """Phase 21: one robot on the same 1M map through both server kinds (the
    CVP server of phase 20 and the replan phase's Dijkstra server). On the
    first pair of NAV_PAIRS: get_path (the gather solves: Jacobi Dijkstra
    sweeps, Jacobi eikonal sweeps with the vector field and back-tracking)
    with its sweeps and ms, each field held against its native oracle (heap
    Dijkstra, fast marching) on the server's current costs at the start
    vertex and the 99.9th percentile; one set_plan, exe_path_step and
    is_goal_reached. Then navigate (its robot kept on the surface, a repair
    of the reference's loop) with the reference's defaults but max_cycles
    on every pair, `nav_dist` metres apart: outcome, cycles, recoveries,
    wall time, and on the first pair the device's idle share under the
    card's trace (tracing included in its wall).
    Gates: the oracles below 1%; on the first pair the final position
    within dist_tolerance of the plan's goal pose; on every pair the
    outcome that the reference's loop with the same surface projection
    gives (REFERENCE_NAV_OUTCOMES; at 1M every CVP pair succeeds)."""
    import torch
    from mesh_navigation_torch.mesh import query
    from mesh_navigation_torch.native import NativeMesh
    from mesh_navigation_torch.ops import kernels

    mesh, v, f = ctx["mesh"], ctx["v"], ctx["f"]
    mesh_n = int(round(np.sqrt(mesh.num_vertices)))
    expect = REFERENCE_NAV_OUTCOMES.get((mesh_n, nav_dist))
    if expect is None:
        raise ValueError(f"no reference navigate outcomes for {mesh_n}x{mesh_n} at {nav_dist} m "
                         "(tests/navigate_pairs.py makes them)")
    pairs = [navigation_pair(v, mesh_n, np.random.default_rng(SEED + k), nav_dist)
             for k in NAV_PAIRS]
    start, goal = pairs[0]
    s_t, g_t = torch.from_numpy(start), torch.from_numpy(goal)
    quat = torch.tensor([0.0, 0.0, 0.0, 1.0])
    out = {"phase": "server_single", "mesh": f"{mesh_n}x{mesh_n}", "V": mesh.num_vertices,
           "pairs": [{"seed": SEED + k, "start": p[0].tolist(), "goal": p[1].tolist(),
                      "start_goal_m": float(np.linalg.norm(p[0] - p[1]))}
                     for k, p in zip(NAV_PAIRS, pairs)],
           "kinds": {}}
    kernels.reset_launches()
    for kind, srv in (("dijkstra", dsrv), ("cvp", scctx["srv"])):
        sync(device)
        t0 = time.perf_counter()
        plan = srv.get_path(s_t, g_t)
        sync(device)
        ms = (time.perf_counter() - t0) * 1e3
        if int(plan.outcome) != 0 or not plan.converged:
            raise AssertionError(f"{kind} get_path: outcome {int(plan.outcome)}, "
                                 f"converged {plan.converged}")
        costs_np = srv.vertex_costs.cpu().numpy()
        pot = plan.potential.cpu().numpy()
        sv = int(query.nearest_vertex(mesh, srv.grid, s_t.to(device))[0])
        with uncounted():
            if kind == "dijkstra":
                gv = int(query.nearest_vertex(mesh, srv.grid, g_t.to(device))[0])
                od = native_fields(v, f, costs_np, [gv])[0][0]
            else:
                g_face = query.containing_face(mesh, srv.grid, g_t.to(device))[0]
                gv = mesh.faces[int(g_face)].long().cpu().numpy()
                sd = np.linalg.norm(v[gv] - goal[None], axis=1).astype(np.float32)
                nm = NativeMesh(v, f)
                try:
                    od = nm.cvp(srv.edge_weights.cpu().numpy(), costs_np, gv, sd, 2.0)[0]
                finally:
                    nm.close()
        oracle = {"start_rel_err": float(abs(pot[sv] - od[sv]) / od[sv]),
                  "p999_rel_err": percentile_rel_err(pot, od),
                  "same_finite_set": bool(np.array_equal(np.isfinite(pot), np.isfinite(od)))}
        if not (oracle["start_rel_err"] < 0.01 and oracle["p999_rel_err"] < 0.01):
            raise AssertionError(f"{kind} get_path oracle gate failed: {oracle}")
        st = srv.set_plan(plan)
        cmd, st = srv.exe_path_step(plan, s_t, quat, st)
        reached = bool(srv.is_goal_reached(s_t, quat, st))
        if int(cmd.outcome) != 0 or reached:
            raise AssertionError(f"{kind} ExePath cycle at the start: outcome "
                                 f"{int(cmd.outcome)}, goal reached {reached}")
        goal_pos = st.goal_pos.cpu().numpy()
        navs = []
        for i, (p_s, p_g) in enumerate(pairs):
            runs = []

            def drive():
                runs.append(srv.navigate(torch.from_numpy(p_s), quat, torch.from_numpy(p_g),
                                         max_cycles=max_cycles))
            if i == 0:
                traced = device_busy(drive, device)
                wall_s = traced["traced_wall_ms"] / 1e3
            else:
                sync(device)
                t0 = time.perf_counter()
                drive()
                sync(device)
                wall_s, traced = time.perf_counter() - t0, None
            nav = runs[0]
            final = nav["final_position"].cpu().numpy()
            navs.append({"seed": SEED + NAV_PAIRS[i], "outcome": nav["outcome"].name,
                         "reference_outcome": expect[kind][i], "cycles": nav["cycles"],
                         "recoveries": nav["recoveries"], "wall_s": wall_s,
                         "final_to_goal_m": float(np.linalg.norm(final - p_g)),
                         "path_cost": nav["path_cost"]})
            if traced is not None:
                navs[-1].update(final_to_plan_goal_m=float(np.linalg.norm(final - goal_pos)),
                                idle_share=traced["idle_share"], trace=traced)
            log(f"# server_single {kind} pair {i}: navigate {nav['outcome'].name} in "
                f"{nav['cycles']} cycles, {wall_s:.1f} s")
        succeeded = sum(n["outcome"] == "SUCCESS" for n in navs)
        k = {"get_path_ms": ms, "sweeps": plan.rounds, "path_cost": float(plan.cost),
             "path_steps": int(plan.path_valid.sum()), "oracle": oracle,
             "first_command": {"linear": float(cmd.linear), "angular": float(cmd.angular)},
             "navigate": navs, "success_rate": succeeded / len(navs),
             "reference_success_rate": sum(o == "SUCCESS" for o in expect[kind]) / len(navs)}
        out["kinds"][kind] = k
        log(f"# server_single {kind}: get_path {ms:.1f} ms, {plan.rounds} sweeps; navigate "
            f"{succeeded}/{len(navs)} SUCCESS (the reference's loop: "
            f"{k['reference_success_rate'] * len(navs):.0f})")
        if (any(n["outcome"] != n["reference_outcome"] for n in navs)
                or navs[0]["outcome"] == "SUCCESS" and navs[0]["final_to_plan_goal_m"] > 0.3):
            raise AssertionError(f"{kind} navigate departs from the reference's loop: {navs}")
    out["launches"] = {n: c for n, c in kernels.LAUNCHES.items() if c}
    return out


# the server_layers phase: the layered costmap behind the server
SERVER_LAYERS_KERNELS = ("banded_pass", "banded_pass_dirty", "eik_pass", "class_pred", "check")
LAYER_RAYS = 4096               # rays and vertices of the raycast gates
LAYER_RAY_STEPS = 64            # DDA cells each gated grid ray walks
NEW_LAYERS = ("height_diff", "roughness", "ridge", "border", "clearance")


def full_stack_config():
    """The full layer stack (BASELINE.json configs[2] with configs[1]'s
    local layers): the five local layers of slice 7 beside steepness, the
    obstacle layer, the inflation layer with its repulsive field over the
    obstacle, border and clearance lethal sets, and their max. The radii
    are 1.0 m, not the reference's 0.3 m default (local.py:91,114,151): on
    the terrain's 0.5 m grid a 0.3 m radius holds no neighbour, so ridge
    would read threshold + 0.1 (lethal) everywhere and height_diff and
    roughness 0. ridge and height_diff stay out of the inflation's inputs:
    at 1.0 m their lethal sets cover most of the map. The inflation radii
    are bench_layers.py:58's; the 0.4 m default is shorter than one edge."""
    from mesh_navigation_torch.config import LayerConfig, MeshMapConfig, NavConfig, PlannerConfig

    LC = LayerConfig
    return NavConfig(
        mesh_map=MeshMapConfig(default_layer="combined", edge_cost_factor=1.0),
        planner=PlannerConfig(cost_limit=2.0),
        layers=(
            LC(name="height_diff", kind="height_diff",
               params=(("radius", 1.0), ("threshold", 0.185))),
            LC(name="roughness", kind="roughness", params=(("radius", 1.0), ("threshold", 0.3))),
            LC(name="ridge", kind="ridge", params=(("radius", 1.0), ("threshold", 0.3))),
            LC(name="steepness", kind="steepness", params=(("threshold", 0.3),)),
            LC(name="border", kind="border"),
            LC(name="clearance", kind="clearance"),
            LC(name="obst", kind="obstacle"),
            LC(name="infl", kind="inflation", inputs=("obst", "border", "clearance"),
               params=(("inflation_radius", 2.0), ("inscribed_radius", 0.5))),
            LC(name="combined", kind="max_combination",
               inputs=("height_diff", "roughness", "ridge", "steepness", "border", "clearance",
                       "obst", "infl")),
        ),
    )


class timed_calls:
    """Wall seconds of every call of `owner.name` inside the block (the
    callee synchronises the card where its result is read on the host)."""

    def __init__(self, owner, name: str):
        self.owner, self.name, self.seconds = owner, name, []

    def __enter__(self):
        self.orig = getattr(self.owner, self.name)

        def wrapped(*a, **k):
            t0 = time.perf_counter()
            out = self.orig(*a, **k)
            self.seconds.append(time.perf_counter() - t0)
            return out

        setattr(self.owner, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.orig)
        return False


def layer_times(srv, device) -> tuple[dict, dict]:
    """Each layer of the server's stack on the card, in the stack's order,
    timed by CUDA events (host clock on the CPU): ms, lethal share, mean
    finite cost. Returns (per-layer dict, outputs)."""
    import torch

    stack, mesh = srv.stack, srv.mesh
    state = dict(srv.layer_state)
    state["__factors__"] = {c.name: c.factor for c in stack.configs}
    configs = {c.name: c for c in stack.configs}
    outputs, out = {}, {}
    for name in stack.order:
        inputs = {i: outputs[i] for i in configs[name].inputs}
        res = []
        ms = time_ms(lambda: res.append(stack.fns[name](mesh, inputs, state)), device)
        outputs[name] = res[0]
        costs = res[0].costs
        fin = torch.isfinite(costs)
        out[name] = {"kind": configs[name].kind, "ms": ms,
                     "lethal_share": float(res[0].lethal.float().mean()),
                     "mean_cost": float(costs[fin].mean()) if bool(fin.any()) else None,
                     "inf_vertices": int((~fin).sum())}
    return out, outputs


def layers_card_vs_cpu(srv, outputs, device) -> dict:
    """Gate 2: the radius table, the five new layers and the repulsive field
    computed by the same port functions on host copies of the mesh and
    inputs: tables and lethal masks equal, costs within 1e-5, vectors
    within 1e-5 with an equal support."""
    import torch
    from mesh_navigation_torch.layers import inflation, local
    from mesh_navigation_torch.ops import raycast

    t0 = time.perf_counter()
    mesh_c = srv.mesh.to("cpu")
    neigh, mask = local.radius_neighborhood(mesh_c, 1.0)     # built afresh on the host
    card_neigh, card_mask = srv.layer_state["neigh:1.0"]
    state_c = {"neigh:1.0": (torch.from_numpy(neigh).long(), torch.from_numpy(mask)),
               "clearance:grid3d": raycast.build_face_grid3d(mesh_c)}
    out = {"radius_table_equal": bool(np.array_equal(card_neigh.cpu().numpy(), neigh)
                                      and np.array_equal(card_mask.cpu().numpy(), mask)),
           "layers": {}}
    ok = out["radius_table_equal"]
    configs = {c.name: c for c in srv.stack.configs}
    for name in NEW_LAYERS:
        oc = srv.stack.fns[name](mesh_c, {}, state_c)
        og = outputs[name]
        lethal_eq = bool(torch.equal(og.lethal.cpu(), oc.lethal))
        err = float((og.costs.cpu() - oc.costs).abs().max())
        out["layers"][name] = {"kind": configs[name].kind, "lethal_equal": lethal_eq,
                               "max_abs_err": err}
        ok = ok and lethal_eq and err <= 1e-5
    dist = srv.layer_state["inflation:infl"][0]
    rg = inflation.repulsive_field(srv.mesh, dist)
    rc = inflation.repulsive_field(mesh_c, dist.cpu())
    sup_g, sup_c = rg.vectors.ne(0).any(dim=1).cpu(), rc.vectors.ne(0).any(dim=1)
    err = float((rg.vectors.cpu() - rc.vectors).abs().max())
    out["repulsive"] = {"sweeps_card": rg.sweeps, "sweeps_cpu": rc.sweeps,
                        "support": int(sup_c.sum()), "support_equal": bool(torch.equal(sup_g, sup_c)),
                        "max_abs_err": err}
    ok = ok and out["repulsive"]["support_equal"] and err <= 1e-5
    out["cpu_side_s"] = time.perf_counter() - t0
    out["crop"] = None           # the CPU side runs on the phase's whole mesh
    if not ok:
        raise AssertionError(f"server_layers card against CPU failed: {out}")
    return out


def raycast_gates(srv, v, device) -> dict:
    """Gate 3: raycast_grid against raycast_bruteforce on the card for
    LAYER_RAYS seeded rays from above the terrain with a downward
    component (face ids equal and t within 1e-5 wherever the brute-force
    hit lies within the grid's LAYER_RAY_STEPS cells; beyond them a grid
    hit is no nearer than the brute force's), and vertex_clearance_grid
    against vertex_clearance
    on LAYER_RAYS seeded vertices (equal)."""
    import torch
    from mesh_navigation_torch.ops import raycast

    mesh, g = srv.mesh, srv.layer_state["clearance:grid3d"]
    rng = np.random.default_rng(SEED + 7)
    lo, hi = v.min(axis=0), v.max(axis=0)
    o = np.stack([rng.uniform(lo[0] + 1, hi[0] - 1, LAYER_RAYS),
                  rng.uniform(lo[1] + 1, hi[1] - 1, LAYER_RAYS),
                  rng.uniform(hi[2] + 1.0, hi[2] + 3.0, LAYER_RAYS)], axis=1)
    d = rng.normal(size=(LAYER_RAYS, 3))
    d[:, 2] = -np.abs(d[:, 2]) - 0.3
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = torch.from_numpy(o.astype(np.float32)).to(device)
    d = torch.from_numpy(d.astype(np.float32)).to(device)
    grid, brute = [], []
    grid_ms = time_ms(lambda: grid.append(
        raycast.raycast_grid(mesh, g, o, d, n_steps=LAYER_RAY_STEPS)), device)
    brute_ms = time_ms(lambda: brute.append(raycast.raycast_bruteforce(mesh, o, d)), device)
    (tg, fg, hg), (tb, fb, hb) = grid[0], brute[0]
    # cells between the origin's and the brute-force hit's: the DDA visits
    # the hit's cell at that step
    p = o + d * torch.where(hb, tb, 0.0)[:, None]
    cells = lambda x: torch.floor((x - g.origin) / g.cell_size).to(torch.int64)
    reach = hb & ((cells(p) - cells(o)).abs().sum(dim=1) < LAYER_RAY_STEPS)
    face_ok = bool(torch.equal(fg[reach], fb[reach]) and bool(hg[reach].all()))
    t_err = float((tg[reach] - tb[reach]).abs().max()) if bool(reach.any()) else 0.0
    # beyond the reach a grid hit, where there is one, is a real one: no
    # nearer than the brute force's (and none where the brute force misses)
    grid_only = int((hg & ~reach & ~(hb & (tg >= tb - 1e-5))).sum())
    vids = torch.from_numpy(rng.choice(mesh.num_vertices, LAYER_RAYS, replace=False)).to(device)
    cg = raycast.vertex_clearance_grid(mesh, g, 0.9, vertex_ids=vids)
    cb = raycast.vertex_clearance(mesh, 0.9, vertex_ids=vids)
    out = {"rays": LAYER_RAYS, "n_steps": LAYER_RAY_STEPS, "brute_hits": int(hb.sum()),
           "within_reach": int(reach.sum()), "faces_equal": face_ok, "max_t_err": t_err,
           "grid_hits_not_brute": grid_only, "grid_ms": grid_ms,
           "brute_ms": brute_ms, "clearance_vertices": LAYER_RAYS,
           "clearance_equal": bool(torch.equal(cg, cb)),
           "clearance_open_sky": int((cg >= 0.9).sum())}
    if not (face_ok and t_err <= 1e-5 and grid_only == 0 and out["clearance_equal"]
            and out["within_reach"] > LAYER_RAYS // 4):
        raise AssertionError(f"server_layers raycast gates failed: {out}")
    return out


def min_dist_to(points, targets, chunk: int = 1 << 16) -> float:
    """Smallest Euclidean distance from any of points [P, 3] to targets
    [T, 3], T in chunks."""
    import torch

    best = float("inf")
    for s in range(0, targets.shape[0], chunk):
        best = min(best, float(torch.cdist(points, targets[s:s + chunk]).min()))
    return best


def path_length(plan) -> float:
    pts = plan.path_positions[plan.path_valid]
    return float((pts[1:] - pts[:-1]).norm(dim=1).sum())


def server_layers(device, ctx, iters: int, batch: int = CVP_BATCH,
                  nav_dist: float = 25.0) -> tuple[dict, dict]:
    """Phase 22: the layered costmap behind the server at full width: the
    CVP server (the default kind) on the main path's terrain with the
    full_stack layers. Set-up (radius table, 3-D face grid, each layer's
    card time, lethal share and mean cost, the repulsive field's sweeps,
    the eikonal plan), then the gates in order: the new layers, the radius
    table and the repulsive field against the same functions on the CPU;
    raycast_grid against raycast_bruteforce and the two clearance routes on
    the card; one warm-up and `iters` timed get_path_batch calls of `batch`
    lanes (converged, eik_pass and banded_pass launched, two lanes against
    the native fast marching); the replan phase's first jump cloud through
    update_point_cloud (the post-update batch bit for bit a fresh plan's,
    the oracle after it, a non-zero repulsive field around the obstacle);
    one CVP get_path on server_single's first pair with the layers' field
    blended in (its oracle at the start vertex and the 99.9th percentile),
    beside the same plan without the field; then a Dijkstra-kind server
    with the same stack runs make_replan_step("obst") (a warm-up, then
    jump / drift / clear once each: warm against cold, converged, check and
    the warm pass launched) and answers one get_path_batch (converged, two
    lanes against the native heap Dijkstra). Launches are counted from the
    first batch GetPath to the end, comparisons excluded."""
    import torch
    from mesh_navigation_torch.api.server import MeshNavServer
    from mesh_navigation_torch.layers import inflation, local
    from mesh_navigation_torch.mesh import query
    from mesh_navigation_torch.native import NativeMesh
    from mesh_navigation_torch.ops import banded_gpu as bg
    from mesh_navigation_torch.ops import kernels, raycast
    from mesh_navigation_torch.planners import CVPPlanner
    from mesh_navigation_torch.utils.timing import StageTimer

    mesh, v, f = ctx["mesh"], ctx["v"], ctx["f"]
    mesh_n = int(round(np.sqrt(mesh.num_vertices)))
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    mesh.host.pop("neigh:1.0", None)          # the table is built and timed here
    cfg = full_stack_config()
    t0 = time.perf_counter()
    with timed_calls(local, "radius_neighborhood") as t_rad, \
            timed_calls(raycast, "build_face_grid3d") as t_grid, \
            timed_calls(CVPPlanner, "prepare_eikonal_plan") as t_plan:
        srv = MeshNavServer(mesh, cfg, grid=ctx["planner"].grid,
                            max_path_len=max(2048, 3 * mesh_n), device=device)
        sync(device)
    t_setup = time.perf_counter() - t0
    if srv.planner_kind != "cvp" or srv.eikonal_plan is None:
        raise AssertionError("the full-stack server is not a CVP server with an eikonal plan")
    g3 = srv.layer_state["clearance:grid3d"]
    per_layer, outputs = layer_times(srv, device)
    rep = []
    rep_ms = time_ms(lambda: rep.append(
        inflation.repulsive_field(mesh, srv.layer_state["inflation:infl"][0])), device)
    setup = {"setup_s": t_setup,
             "radius_table": {"radius": 1.0, "K": int(srv.layer_state["neigh:1.0"][0].shape[1]),
                              "mean_neighbours": float(srv.layer_state["neigh:1.0"][1].sum(dim=1)
                                                       .float().mean()),
                              "build_s": t_rad.seconds},
             "grid3d": {"dims": g3.dims.tolist(), "cell_size": g3.cell_size_static,
                        "max_per_cell": g3.max_per_cell, "faces_binned": int(g3.bucket_faces.numel()),
                        "build_s": t_grid.seconds},
             "layers": per_layer, "layers_ms_total": sum(x["ms"] for x in per_layer.values()),
             "repulsive": {"sweeps": rep[0].sweeps, "ms": rep_ms,
                           "nonzero_vertices": int(rep[0].vectors.ne(0).any(dim=1).sum())},
             "eikonal_plan_s": t_plan.seconds}
    del rep
    log(f"# server_layers set-up {t_setup:.1f} s: K {setup['radius_table']['K']}, grid "
        f"{setup['grid3d']['dims']} x {setup['grid3d']['max_per_cell']}, layers "
        f"{setup['layers_ms_total']:.1f} ms, repulsive {setup['repulsive']['sweeps']} sweeps")
    vs_cpu = layers_card_vs_cpu(srv, outputs, device)
    del outputs
    log(f"# server_layers card vs CPU: CPU side {vs_cpu['cpu_side_s']:.1f} s")
    rays = raycast_gates(srv, v, device)

    # batch GetPath (the path's launches count from here)
    rng = np.random.default_rng(SEED + 8)

    def sample():
        p = v[rng.integers(0, mesh.num_vertices, 2 * batch)].astype(np.float32)
        return torch.from_numpy(p[:batch]), torch.from_numpy(p[batch:])

    kernels.reset_launches()
    warm = sample()
    tw = time.perf_counter()
    warm_res = srv.get_path_batch(*warm)
    sync(device)
    t_warm = time.perf_counter() - tw
    solves = [{"rounds": warm_res.rounds, "converged": bool(warm_res.converged)}]
    timer = StageTimer(device)
    t1 = time.perf_counter()
    for _ in range(iters):
        res = srv.get_path_batch(*sample(), timer=timer)
        solves.append({"rounds": res.rounds, "converged": bool(res.converged)})
    sync(device)
    dt = time.perf_counter() - t1
    res = None
    stages = {k: val / iters for k, val in timer.totals().items()}
    batch_launches = {name: kernels.LAUNCHES[name] for name in CVP_KERNELS}
    before_costs = srv.vertex_costs.cpu().numpy()
    before_vec = srv.layer_vectors.ne(0).any(dim=1)
    cctx = dict(planner=srv.planner, kplan=srv.eikonal_plan, warm_res=warm_res,
                warm=tuple(x.numpy() for x in warm),
                ew=srv.edge_weights, ew_np=srv.edge_weights.cpu().numpy())
    with uncounted():
        oracle_before = cvp_oracle_gate(ctx, cctx, costs_np=before_costs,
                                        phase="server_layers_oracle_before")
        trace = device_busy(lambda: srv.get_path_batch(*sample()), device)
    peak_batch = torch.cuda.max_memory_allocated() / 1e9 if cuda else None

    # the sensor update: obstacle -> inflation with its field -> max
    crng = np.random.default_rng(SEED + 2)
    crng.integers(0, mesh.num_vertices, REPLAN_BATCH)
    cloud = update_clouds(crng, v, mesh_n)[0][1]
    tu = time.perf_counter()
    srv.update_point_cloud("obst", torch.from_numpy(cloud).to(device))
    sync(device)
    t_update = time.perf_counter() - tu
    rtimer = StageTimer(device)
    tr = time.perf_counter()
    post = srv.get_path_batch(*warm, timer=rtimer)
    sync(device)
    t_post = time.perf_counter() - tr
    solves.append({"rounds": post.rounds, "converged": bool(post.converged), "after_update": True})
    if not all(x["converged"] for x in solves):
        raise AssertionError(f"a server_layers solve did not converge: {solves}")
    costs_np = srv.vertex_costs.cpu().numpy()
    lethal_added = int(np.isinf(costs_np).sum() - np.isinf(before_costs).sum())
    obst_v = torch.from_numpy(np.nonzero(np.isinf(costs_np) & ~np.isinf(before_costs))[0])
    near = torch.cdist(mesh.vertices, mesh.vertices[obst_v.to(device)]).amin(dim=1) <= 2.0 \
        if lethal_added > 0 else torch.zeros_like(before_vec)
    field_near = int((srv.layer_vectors.ne(0).any(dim=1) & near & ~before_vec).sum())
    cctx.update(kplan=srv.eikonal_plan, warm_res=post, ew=srv.edge_weights,
                ew_np=srv.edge_weights.cpu().numpy())
    with uncounted():
        oracle_after = cvp_oracle_gate(ctx, cctx, costs_np=costs_np,
                                       phase="server_layers_oracle_after")
        fresh = CVPPlanner(mesh, srv.config.planner, grid=srv.grid,
                           max_path_len=srv.planner.max_path_len, device=device)
        fplan = fresh.prepare_eikonal_plan(cctx["ew_np"], costs_np)
        want = fresh.plan_batch_banded(srv.edge_weights, fplan, *warm)
        fresh_equal = {k: bool(torch.equal(getattr(post, k), getattr(want, k)))
                       for k in ("d_pad", "outcome", "path_positions", "path_valid", "cost")}
        del fresh, fplan, want
    if lethal_added <= 0 or field_near <= 0 or not all(fresh_equal.values()):
        raise AssertionError(f"server_layers update: {lethal_added} lethal vertices added, "
                             f"{field_near} field vertices near them, fresh plan {fresh_equal}")
    update = {"update_s": t_update, "post_update_call_s": t_post,
              "rebuild_s": rtimer.totals().get("rebuild", 0.0) / 1e3,
              "lethal_vertices_added": lethal_added,
              "field_vertices_new_near_obstacle": field_near,
              "field_vertices": int(srv.layer_vectors.ne(0).any(dim=1).sum()),
              "fresh_plan_bitwise": fresh_equal}
    del warm_res, post
    cvp_launches = {name: kernels.LAUNCHES[name] for name in CVP_KERNELS}

    # one robot: the single CVP GetPath with the layers' field blended in
    start, goal = navigation_pair(v, mesh_n, np.random.default_rng(SEED + NAV_PAIRS[0]), nav_dist)
    s_t, g_t = torch.from_numpy(start), torch.from_numpy(goal)
    sync(device)
    ts0 = time.perf_counter()
    plan = srv.get_path(s_t, g_t)
    sync(device)
    single_ms = (time.perf_counter() - ts0) * 1e3
    if int(plan.outcome) != 0 or not plan.converged:
        raise AssertionError(f"server_layers get_path: outcome {int(plan.outcome)}, "
                             f"converged {plan.converged}")
    plain = srv.planner.plan_one(srv.edge_weights, srv.vertex_costs, s_t, g_t,
                                 layer_vectors=None)
    pot = plan.potential.cpu().numpy()
    sv = int(query.nearest_vertex(mesh, srv.grid, s_t.to(device))[0])
    g_face = query.containing_face(mesh, srv.grid, g_t.to(device))[0]
    gv = mesh.faces[int(g_face)].long().cpu().numpy()
    sd = np.linalg.norm(v[gv] - goal[None], axis=1).astype(np.float32)
    nm = NativeMesh(v, f)
    try:
        od = nm.cvp(srv.edge_weights.cpu().numpy(), costs_np, gv, sd, 2.0)[0]
    finally:
        nm.close()
    single_oracle = {"start_rel_err": float(abs(pot[sv] - od[sv]) / od[sv]),
                     "p999_rel_err": percentile_rel_err(pot, od)}
    if not (single_oracle["start_rel_err"] < 0.01 and single_oracle["p999_rel_err"] < 0.01):
        raise AssertionError(f"server_layers get_path oracle gate failed: {single_oracle}")
    lethal_xyz = mesh.vertices[srv.layer_outputs["infl"].lethal]
    single = {"start": start.tolist(), "goal": goal.tolist(), "get_path_ms": single_ms,
              "sweeps": plan.rounds, "oracle": single_oracle,
              "path_length_m": path_length(plan), "path_cost": float(plan.cost),
              "min_dist_to_lethal_m": min_dist_to(plan.path_positions[plan.path_valid],
                                                  lethal_xyz),
              "without_field": {"path_length_m": path_length(plain), "path_cost": float(plain.cost),
                                "min_dist_to_lethal_m": min_dist_to(
                                    plain.path_positions[plain.path_valid], lethal_xyz)},
              "field_at_path_vertices": int(srv.layer_vectors[query.nearest_vertex_batch(
                  mesh, srv.grid, plan.path_positions[plan.path_valid])[0]].ne(0).any(dim=1)
                                            .sum())}
    del plan, plain
    cvp_srv_peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
    del srv, cctx
    if cuda:
        torch.cuda.empty_cache()

    # the replan step on a Dijkstra-kind server with the same stack
    t0 = time.perf_counter()
    dsrv = MeshNavServer(mesh, cfg, planner_kind="dijkstra", grid=ctx["planner"].grid,
                         device=device)
    step = dsrv.make_replan_step("obst")
    sync(device)
    t_dsetup = time.perf_counter() - t0
    srng = np.random.default_rng(SEED + 9)
    seeds = torch.from_numpy(np.sort(srng.integers(0, mesh.num_vertices, REPLAN_BATCH))).to(device)
    base = bg.banded_solve_padded(dsrv.banded_plan, seeds, atol=ATOL, rtol=RTOL)
    costs, d = dsrv.vertex_costs, base.d_pad
    steps = []
    step_timer = StageTimer(device)
    for name, pts in [("warmup", update_clouds(srng, v, mesh_n)[0][1])] + \
            update_clouds(srng, v, mesh_n):
        sync(device)
        t = time.perf_counter()
        costs, d, rounds = step(torch.from_numpy(pts).to(device), costs, d, seeds,
                                timer=None if name == "warmup" else step_timer)
        sync(device)
        ms = (time.perf_counter() - t) * 1e3
        if not step.last["converged"]:
            raise AssertionError(f"server_layers replan step {name} did not converge")
        with uncounted():
            wc = warm_vs_cold(step, seeds, d)
        steps.append({"pattern": name, "ms": ms, "rounds": rounds,
                      "lethal": int(torch.isinf(costs).sum()), **wc})
    del d, base
    # one batch GetPath on the Dijkstra server (the light banded path)
    dwarm = sample()
    dres = dsrv.get_path_batch(*dwarm)
    sync(device)
    if not dres.converged:
        raise AssertionError("server_layers Dijkstra get_path_batch did not converge")
    with uncounted():
        dctx = dict(planner=dsrv.planner, kplan=dsrv.banded_plan, mesh=mesh,
                    warm=tuple(x.numpy() for x in dwarm) + (None,), warm_res=dres, v=v, f=f,
                    costs_np=dsrv.vertex_costs.cpu().numpy())
        d_oracle = oracle_gate(dctx, phase="server_layers_dijkstra_oracle")
    launches = {name: kernels.LAUNCHES[name] for name in SERVER_LAYERS_KERNELS}
    for name in ("banded_pass", "banded_pass_dirty", "eik_pass", "class_pred", "check"):
        if launches[name] <= 0 and cuda:
            raise AssertionError(f"kernel {name} was not launched on the server_layers path")
    timed_steps = steps[1:]
    replan_out = {"setup_s": t_dsetup, "steps": steps,
                  "ms_per_update": float(np.mean([x["ms"] for x in timed_steps])),
                  "stage_ms_per_update": {k: val / len(timed_steps)
                                          for k, val in step_timer.totals().items()},
                  "warm_vs_cold_max_rel": max(x["max_rel_err"] for x in steps),
                  "dijkstra_batch": {"lanes": batch, "rounds": dres.rounds,
                                     "oracle": d_oracle}}
    del dsrv, step, dres
    out = {
        "phase": "server_layers", "config": "full_stack", "mesh": f"{mesh_n}x{mesh_n}",
        "V": mesh.num_vertices, "lanes": batch, **setup, "card_vs_cpu": vs_cpu,
        "raycasts": rays, "warmup_s": t_warm, "iters": iters,
        "solves_per_s": batch * iters / dt, "ms_per_iter": dt * 1e3 / iters,
        "stage_ms_per_iter": stages, "solves": solves, "batch_launches": batch_launches,
        "oracle_before": oracle_before, "oracle_after": oracle_after, "update": update,
        "single": single, "replan": replan_out, "launches": launches,
        "cvp_launches": cvp_launches, "trace": trace, "peak_mem_gb_batch": peak_batch,
        "peak_mem_gb_cvp_server": cvp_srv_peak,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9 if cuda else None,
    }
    return out, {"launches": launches}


SCANNED_BATCH = 128          # lanes per scanned_map batch GetPath
SCANNED_KERNELS = ("banded_pass", "class_pred")   # the file-loaded grid map's banded batch
SCANNED_SLOW_S = 20.0        # a default solve slower than this: timed calls at ordered_rounds 2
SCANNED_ROUNDS = 2           # the ordered rounds of the second setting


def write_binary_ply(path: str, v, f) -> None:
    """A binary little-endian PLY of float32 vertices and uchar-counted
    int32 triangles, as a scanner's exporter writes it."""
    rec = np.dtype([("n", "u1"), ("i", "<i4", (3,))])
    faces = np.empty(len(f), rec)
    faces["n"], faces["i"] = 3, f
    with open(path, "wb") as fh:
        fh.write((f"ply\nformat binary_little_endian 1.0\nelement vertex {len(v)}\n"
                  "property float x\nproperty float y\nproperty float z\n"
                  f"element face {len(f)}\nproperty list uchar int vertex_indices\n"
                  "end_header\n").encode())
        fh.write(np.ascontiguousarray(v, "<f4").tobytes())
        fh.write(faces.tobytes())


def scanned_map(device, mesh_n: int, iters: int, scan, batch: int = SCANNED_BATCH
                ) -> tuple[dict, dict]:
    """Phase 23: maps from files. (a) A scan in its native vertex order: the
    irregular phase's jittered-Delaunay terrain (`scan`: its vertices and
    faces) relabelled by a seeded permutation, written as a binary PLY,
    loaded by io.read_map (import and build_mesh timed), behind a Dijkstra
    MeshNavServer on the steepness layer (cost limit 2.0, edge cost factor
    1.0, the default PlannerConfig: no ordered rounds); its set-up (the
    failed banded and offset classifications) timed, and the third branch
    asserted (no banded plan, offset coverage <= 0.5). One warm-up and
    `iters` timed get_path_batch calls of `batch` lanes (plan_batch's
    hybrid solve and the full result: sweeps, converged, stage times, peak
    memory); timed at ordered_rounds 2 where the warm-up took more than
    SCANNED_SLOW_S. Then one solve with ordered_rounds 2 beside it. Gates:
    converged everywhere; two lanes of the warm-up against the native heap
    Dijkstra (the field's largest relative error, the start vertex's and
    the 99.9th percentile's, and the path cost against the native chain's,
    all below 1%), SUCCESS where the oracle reaches the start. (b) The CLI
    on the main path's terrain written as a PLY: `python -m
    mesh_navigation_torch --mesh ... --planner dijkstra --layers
    steepness,border --out DIR` as a subprocess (exit 0, SUCCESS, the four
    exports); then the same PLY through read_map into a Dijkstra server
    and one banded get_path_batch of `batch` lanes, whose banded_pass and
    class_pred launches are counted."""
    import dataclasses
    import tempfile

    import torch
    from mesh_navigation_torch.api.server import MeshNavServer
    from mesh_navigation_torch.config import (
        LayerConfig, MeshMapConfig, NavConfig, PlannerConfig,
    )
    from mesh_navigation_torch.mesh import io, synthetic
    from mesh_navigation_torch.mesh.arrays import build_mesh, host_array
    from mesh_navigation_torch.ops import kernels
    from mesh_navigation_torch.planners import DijkstraPlanner
    from mesh_navigation_torch.utils.timing import StageTimer

    cuda = torch.device(device).type == "cuda"
    max_len = max(2048, 3 * mesh_n)
    rng = np.random.default_rng(SEED + 11)
    vi, fi = scan
    perm = rng.permutation(len(vi))                 # new id -> the Delaunay's id
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(vi))
    v_scan, f_scan = vi[perm], inv[fi].astype(np.int32)
    cfg = NavConfig(mesh_map=MeshMapConfig(edge_cost_factor=1.0),
                    planner=PlannerConfig(cost_limit=2.0),
                    layers=(LayerConfig(name="steepness", kind="steepness"),))
    out = {"phase": "scanned_map", "mesh": f"{mesh_n}x{mesh_n}", "lanes": batch}
    with tempfile.TemporaryDirectory() as tmp:
        ply = os.path.join(tmp, "scan.ply")
        write_binary_ply(ply, v_scan, f_scan)
        del v_scan, f_scan
        out["ply_mb"] = os.path.getsize(ply) / 1e6
        t0 = time.perf_counter()
        vl, fl = io.import_mesh_file(ply)
        out["import_s"] = time.perf_counter() - t0
        del vl, fl
        t0 = time.perf_counter()
        mesh = io.read_map(ply, device=device)
        sync(device)
        out["read_map_s"] = time.perf_counter() - t0
        out["V"], out["faces"], out["max_degree"] = mesh.num_vertices, mesh.num_faces, mesh.max_degree
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        srv = MeshNavServer(mesh, cfg, planner_kind="dijkstra", max_path_len=max_len,
                            device=device)
        sync(device)
        out["server_setup_s"] = time.perf_counter() - t0
        out["offset_coverage"] = srv.offset_plan.coverage
        if srv.banded_plan is not None or srv.offset_plan.coverage > 0.5:
            raise AssertionError(f"the scan took another branch than plan_batch: {out}")
        log(f"# scanned_map (a): {out}")

        def batch_call(s, g, planner=None, timer=None):
            if planner is None:
                return srv.get_path_batch(torch.from_numpy(s), torch.from_numpy(g), timer=timer)
            return planner.plan_batch(srv.slot_weights, torch.from_numpy(s), torch.from_numpy(g),
                                      timer=timer)

        warm = sample_scenarios(rng, mesh_n, batch)
        t0 = time.perf_counter()
        res = batch_call(*warm[:2])
        sync(device)
        out["warmup_s"] = time.perf_counter() - t0
        solves = [{"sweeps": res.rounds, "converged": bool(res.converged)}]
        n_lanes = 2
        ws = {"potential": res.potential[:n_lanes].cpu().numpy(),
              "pred": res.pred[:n_lanes].cpu().numpy(), "cost": res.cost[:n_lanes].cpu().numpy()}
        outcome = res.outcome[:n_lanes].cpu().numpy()
        del res
        rounds2 = DijkstraPlanner(srv.mesh, dataclasses.replace(cfg.planner,
                                                                ordered_rounds=SCANNED_ROUNDS),
                                  grid=srv.grid, max_path_len=max_len, device=device)
        timed_planner = rounds2 if out["warmup_s"] > SCANNED_SLOW_S else None
        out["timed_ordered_rounds"] = SCANNED_ROUNDS if timed_planner is not None else 0
        if timed_planner is not None:
            log(f"# scanned_map: the default solve took {out['warmup_s']:.1f} s; timed calls "
                f"at ordered_rounds {SCANNED_ROUNDS}")
        timer = StageTimer(device)
        t1 = time.perf_counter()
        for _ in range(iters):
            res = None
            res = batch_call(*sample_scenarios(rng, mesh_n, batch)[:2], planner=timed_planner,
                             timer=timer)
            solves.append({"sweeps": res.rounds, "converged": bool(res.converged)})
        sync(device)
        dt = time.perf_counter() - t1
        out.update(iters=iters, solves_per_s=batch * iters / dt, ms_per_iter=dt * 1e3 / iters,
                   stage_ms_per_iter={k: x / iters for k, x in timer.totals().items()})
        res = None
        if timed_planner is None:
            timer2 = StageTimer(device)
            t1 = time.perf_counter()
            res = batch_call(*sample_scenarios(rng, mesh_n, batch)[:2], planner=rounds2,
                             timer=timer2)
            sync(device)
            r2 = {"ms": (time.perf_counter() - t1) * 1e3, "sweeps": res.rounds,
                  "converged": bool(res.converged), "stage_ms": timer2.totals()}
            solves.append({"sweeps": res.rounds, "converged": bool(res.converged)})
            res = None
        else:
            r2 = {"ms": out["ms_per_iter"], "sweeps": solves[-1]["sweeps"], "converged":
                  solves[-1]["converged"], "stage_ms": out["stage_ms_per_iter"]}
        out["ordered_rounds_2"] = r2
        out["solves"] = solves
        out["ms_per_sweep_default"] = out["warmup_s"] * 1e3 / solves[0]["sweeps"]
        out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
        if not all(x["converged"] for x in solves):
            raise AssertionError(f"a scanned_map solve did not converge: {solves}")
        ctx = {"v": host_array(srv.mesh, "vertices"), "f": host_array(srv.mesh, "faces"),
               "costs_np": srv.vertex_costs.cpu().numpy()}
        lanes = full_result_oracle(ctx, srv.planner, warm[0][:n_lanes], warm[1][:n_lanes], ws)
        for b, lane in enumerate(lanes):
            lane["outcome"] = int(outcome[b])
        gate = full_result_gate("scanned_map_oracle", lanes)
        starts_v = _snapped(srv, warm[0][:n_lanes])
        fields = native_fields(ctx["v"], ctx["f"], ctx["costs_np"],
                               _snapped(srv, warm[1][:n_lanes]))
        for b, (od, _) in enumerate(fields):
            ref = float(od[starts_v[b]])
            lanes[b]["start_rel_err"] = (abs(float(ws["potential"][b, starts_v[b]]) - ref) / ref
                                         if np.isfinite(ref) and ref > 0 else 0.0)
            lanes[b]["p999_rel_err"] = percentile_rel_err(ws["potential"][b], od)
            if (outcome[b] == 0) != bool(np.isfinite(ref)):
                raise AssertionError(f"scanned_map lane {b}: outcome {outcome[b]} where the "
                                     f"oracle's start distance is {ref}")
            if not (lanes[b]["start_rel_err"] < 0.01 and lanes[b]["p999_rel_err"] < 0.01):
                raise AssertionError(f"scanned_map lane {b} against the oracle: {lanes[b]}")
        out["oracle"] = gate
        del srv, rounds2, timed_planner, mesh
        if cuda:
            torch.cuda.empty_cache()

        # (b) the CLI and a banded batch on a file-loaded grid map
        vg, fg = synthetic.terrain_mesh(mesh_n, mesh_n, spacing=0.5, hills=2.0, roughness=0.01,
                                        seed=0)
        grid_ply = os.path.join(tmp, "grid.ply")
        write_binary_ply(grid_ply, vg, fg)
        extent = mesh_n * 0.5
        start = [0.05 * extent, 0.05 * extent, 0.0]
        goal = [0.7 * extent, 0.6 * extent, 0.0]
        exports = os.path.join(tmp, "cli_out")
        cmd = [sys.executable, "-m", "mesh_navigation_torch", "--mesh", grid_ply,
               "--planner", "dijkstra", "--layers", "steepness,border",
               "--start", *map(str, start), "--goal", *map(str, goal), "--out", exports]
        if not cuda:
            cmd += ["--device", "cpu"]
        t0 = time.perf_counter()
        done = subprocess.run(cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                              capture_output=True, text=True, timeout=600)
        cli = {"s": time.perf_counter() - t0, "rc": done.returncode,
               "stderr_tail": done.stderr.strip().splitlines()[-3:]}
        try:
            cli["json"] = json.loads(done.stdout.strip().splitlines()[-1])
        except (IndexError, json.JSONDecodeError):
            cli["json"] = None
        files = ("vertex_costs.ply", "potential.ply", "vector_field.obj", "path.obj")
        cli["exports_mb"] = {x: os.path.getsize(os.path.join(exports, x)) / 1e6
                             for x in files if os.path.exists(os.path.join(exports, x))}
        out["cli"] = cli
        if not (done.returncode == 0 and cli["json"] and cli["json"]["outcome"] == "SUCCESS"
                and len(cli["exports_mb"]) == len(files)):
            raise AssertionError(f"the CLI on the file-loaded map failed: {cli}\n{done.stderr}")
        t0 = time.perf_counter()
        gmesh = io.read_map(grid_ply, device=device)
        gsrv = MeshNavServer(gmesh, cfg, planner_kind="dijkstra", max_path_len=max_len,
                             device=device)
        sync(device)
        out["grid_setup_s"] = time.perf_counter() - t0
        if gsrv.banded_plan is None:
            raise AssertionError("the file-loaded grid map has no banded plan")
        s, g, _ = sample_scenarios(rng, mesh_n, batch)
        kernels.reset_launches()
        gres = gsrv.get_path_batch(torch.from_numpy(s), torch.from_numpy(g))
        sync(device)
        launches = {name: kernels.LAUNCHES[name] for name in SCANNED_KERNELS}
        out["grid_batch"] = {"rounds": gres.rounds, "converged": bool(gres.converged),
                             "reach_rate": float((gres.outcome == 0).float().mean()),
                             "launches": launches}
        if cuda and not all(n > 0 for n in launches.values()):
            raise AssertionError(f"the file-loaded banded batch launched no kernel: {launches}")
        if not gres.converged:
            raise AssertionError("the file-loaded banded batch did not converge")
        del gsrv, gmesh, gres
    return out, {"launches": launches}


def _snapped(srv, points) -> np.ndarray:
    """The server's nearest vertices of [n, 3] points."""
    import torch
    from mesh_navigation_torch.mesh import query

    pts = torch.from_numpy(points).to(srv.device)
    return query.nearest_vertex_batch(srv.mesh, srv.grid, pts)[0].cpu().numpy()


def layers_terrain(device, mesh_n: int) -> dict:
    """The main path's terrain family at mesh_n x mesh_n, as server_layers
    reads it (v, f, mesh and a snap grid): the CPU rehearsal's
    server_layers map, where the main path's tiny map would hold its
    oracle percentile over a few thousand vertices."""
    import types
    from mesh_navigation_torch.mesh import query

    v, f, mesh, *_ = steepness_setup(mesh_n, device)
    return {"v": v, "f": f, "mesh": mesh,
            "planner": types.SimpleNamespace(grid=query.build_grid(mesh))}


# --------------------------------------------------------------------------
# phases 24-26: the banded walks and the row-scan solver, the windowed warm
# resolve, the hybrid CVP transport
# --------------------------------------------------------------------------

WALK_SCAN_BATCH = 16         # lanes of the row-scan solver (ops/banded.py)
WALK_SCAN_SLOW_S = 60.0      # a row-scan solve slower than this moves to a 512 x 512 terrain
REPLAN_WINDOW = 384          # rows of the warm window (bench.py:382-388's measured setting)
WINDOW_COHORTS = (128, 8)    # lanes of the replan draw the window phase runs
WINDOW_KERNELS = ("banded_pass", "check")
HYBRID_KERNELS = ("eik_pass", "banded_pass")


def banded_walks(device, ctx, bctx) -> dict:
    """Phase 24 (after phase 8): the banded walks on banded_full's own
    field and id table (the warm-up draw's 128 lanes, solved and tabled as
    that path does): extract_paths_vb walks the lane-minor [V, Bp] table
    and must give the vertex ids of the path's walk (sweeps.extract_path
    on the [B, V] table) lane for lane; descend_paths descends the [B, V]
    field with no table, and its walked length must stay within 1% of the
    walk's on every lane where both reach the goal. Then the row-scan
    solver (ops/banded.batched_field_banded, plain torch: a loop over rows)
    on the main terrain with 16 lanes of the same draw's goals: its
    rounds, ms and `converged`, and two lanes against the native heap
    Dijkstra (field's largest and 99.9th-percentile relative error below
    1%, the same finite set). Where that solve takes over 60 s it runs
    again on a 512 x 512 terrain, and the line says so."""
    import torch
    from mesh_navigation_torch.mesh import query
    from mesh_navigation_torch.ops import banded as sb
    from mesh_navigation_torch.ops import banded_gpu as bg
    from mesh_navigation_torch.ops import sweeps

    planner, kplan, mesh = ctx["planner"], ctx["kplan"], ctx["mesh"]
    s, g, _ = bctx["warm"]
    B = len(s)
    with uncounted():
        sv = query.nearest_vertex_batch(mesh, planner.grid, torch.from_numpy(s).to(device))[0]
        gv = query.nearest_vertex_batch(mesh, planner.grid, torch.from_numpy(g).to(device))[0]
        d = bg.banded_solve_padded(kplan, gv, max_rounds=max(planner.config.max_sweeps // 2, 64),
                                   atol=ATOL, rtol=RTOL, converge="round").d_pad
        tol = max(ATOL, 1e-6)
        ids = bg.predecessors_banded_ids(kplan, d, tol=tol)
    R, C, V = kplan.n_rows, kplan.n_cols, kplan.num_vertices
    dist = d[:R, :C, :B].reshape(R * C, B)[:V].T.contiguous()
    del d
    L = planner.max_path_len
    pred_bv = ids[:, :B].T.contiguous()
    walks = {}
    for name, fn in (("extract_path", lambda: sweeps.extract_path(pred_bv, sv, gv, L)),
                     ("extract_paths_vb", lambda: bg.extract_paths_vb(ids, sv, gv, L)),
                     ("descend_paths", lambda: bg.descend_paths(kplan, dist, sv, gv, L, tol=tol))):
        sync(device)
        t = time.perf_counter()
        walks[name] = fn()
        sync(device)
        walks[name] = (*walks[name], (time.perf_counter() - t) * 1e3)
    (pa, va, ms_a), (pb, vb, ms_b), (pc, vc, ms_c) = (walks[k] for k in walks)
    ids_equal = bool(torch.equal(pa, pb) and torch.equal(va, vb))
    if not ids_equal:
        raise AssertionError("extract_paths_vb's vertex ids differ from the banded_full walk's")
    la = sweeps.path_cost(mesh.vertices, pa, va)
    lc = sweeps.path_cost(mesh.vertices, pc, vc)
    steps_a, steps_c = va.sum(dim=1), vc.sum(dim=1)
    end_a = pa[torch.arange(B, device=pa.device), (steps_a - 1).clamp(min=0)]
    end_c = pc[torch.arange(B, device=pc.device), (steps_c - 1).clamp(min=0)]
    both = (end_a == gv) & (end_c == gv)
    rel = ((lc - la).abs() / la.clamp(min=1e-6))[both]
    descend = {"lanes_at_goal": int(both.sum()), "max_rel_len_diff": float(rel.max()),
               "same_path_lanes": int((pa == pc).all(dim=1).sum()), "budget": 0.01}
    if not (int(both.sum()) > B // 2 and descend["max_rel_len_diff"] < 0.01):
        raise AssertionError(f"descend_paths against the banded_full walk: {descend}")
    del ids, pred_bv, dist

    def scan_solve(mesh_s, W, v, f, costs_np, n):
        bplan = sb.build_banded_plan(mesh_s, W)
        rng = np.random.default_rng(SEED + 24)
        seeds = torch.from_numpy(rng.integers(0, mesh_s.num_vertices, WALK_SCAN_BATCH)).to(device)
        sync(device)
        t = time.perf_counter()
        res = sb.batched_field_banded(mesh_s, torch.from_numpy(W).to(device), bplan, seeds,
                                      atol=ATOL, rtol=RTOL)
        sync(device)
        secs = time.perf_counter() - t
        if not res.converged:
            raise AssertionError(f"batched_field_banded did not converge in {res.rounds} rounds")
        errs, same = [], []
        for b, (od, _) in enumerate(native_fields(v, f, costs_np, seeds[:2].cpu().numpy())):
            got = res.dist[b].cpu().numpy()
            fin = np.isfinite(od)
            same.append(bool(np.array_equal(np.isfinite(got), fin)))
            errs.append(float(np.max(np.abs(got[fin] - od[fin]) / np.maximum(od[fin], 1e-3))))
            errs.append(percentile_rel_err(got, od))
        oracle = {"lanes": 2, "max_rel_err": float(np.max(errs)), "same_finite_set": same,
                  "budget": 0.01}
        if not (oracle["max_rel_err"] < 0.01 and all(same)):
            raise AssertionError(f"batched_field_banded oracle parity failed: {oracle}")
        return {"mesh": f"{n}x{n}", "V": mesh_s.num_vertices, "lanes": WALK_SCAN_BATCH,
                "rounds": res.rounds, "converged": res.converged, "ms": secs * 1e3,
                "coverage": bplan.coverage, "oracle": oracle}

    mesh_n = int(round(np.sqrt(mesh.num_vertices)))
    W = sweeps.slot_weights_np(mesh, ctx["costs_np"], cost_limit=2.0, edge_cost_factor=1.0)
    scan = scan_solve(mesh, W, ctx["v"], ctx["f"], ctx["costs_np"], mesh_n)
    if scan["ms"] > WALK_SCAN_SLOW_S * 1e3:
        v2, f2, mesh2, costs2, _, W2 = steepness_setup(512, device)
        scan = {"at_main_terrain": scan, "moved_to_512": True,
                **scan_solve(mesh2, W2, v2, f2, costs2, 512)}
    return {"phase": "banded_walks", "lanes": B, "max_len": L,
            "walk_ms": {"extract_path": ms_a, "extract_paths_vb": ms_b, "descend_paths": ms_c},
            "ids_equal": ids_equal, "walk_steps_max": int(steps_a.max()),
            "descend": descend, "row_scan": scan}


def fit_share(records) -> float | None:
    """The share of windowed steps whose window fit; None where no step
    used the window (a field no taller than the window)."""
    fits = [r["fit"] for r in records if r["fit"] is not None]
    return float(np.mean(fits)) if fits else None


def replan_window(device, ctx, rctx, iters: int) -> tuple[dict, dict]:
    """Phase 25 (after phase 10): the windowed warm resolve on the replan
    phase's server and terrain: make_replan_step("obst", warm_window=384)
    and the same step without the window, for two cohorts of the replan
    draw (its 128 lanes, then its first 8). Each cohort starts both steps
    from one cold field, runs one warm-up jump on each, then `iters` rounds
    of the jump / drift / clear clouds; each cloud goes through both steps
    in turns (the order alternates), each step from its own last field.
    Per step: ms (host clock around a synchronised step), rounds, the
    window record, banded_pass and check launches. Gates: every step
    converged and its field against a cold solve on its planes (same
    finite set, < 1%); two lanes of each cohort's last windowed field
    against the native heap Dijkstra (< 1%). Only the windowed steps count
    for the path's launches."""
    import torch
    from mesh_navigation_torch.ops import banded_gpu as bg
    from mesh_navigation_torch.ops import kernels

    srv, draw = rctx["srv"], rctx["seeds"]
    v, mesh = ctx["v"], srv.mesh
    mesh_n = int(round(np.sqrt(mesh.num_vertices)))
    steps = {"on": srv.make_replan_step("obst", warm_window=REPLAN_WINDOW),
             "off": srv.make_replan_step("obst")}
    rng = np.random.default_rng(SEED + 25)
    kernels.reset_launches()
    records, cohorts = [], {}
    for lanes in WINDOW_COHORTS:
        seeds = draw[:lanes]
        with uncounted():
            base = bg.banded_solve_padded(srv.banded_plan, seeds, atol=ATOL, rtol=RTOL).d_pad
        state = {mode: (srv.vertex_costs, base) for mode in steps}

        def one(mode, name, pts, timed=True):
            step = steps[mode]
            costs, d = state[mode]
            with uncounted() if mode == "off" else contextlib.nullcontext():
                before = {k: kernels.LAUNCHES[k] for k in WINDOW_KERNELS}
                sync(device)
                t = time.perf_counter()
                costs, d, rounds = step(pts, costs, d, seeds)
                sync(device)
                ms = (time.perf_counter() - t) * 1e3
                launched = {k: kernels.LAUNCHES[k] - before[k] for k in WINDOW_KERNELS}
            w = step.last["window"]
            where = f"{lanes} lanes, window {mode}, {name}: {w}"
            if not step.last["converged"]:
                raise AssertionError(f"replan_window step did not converge ({where})")
            with uncounted():
                try:
                    gate = warm_vs_cold(step, seeds, d)
                except AssertionError as e:
                    raise AssertionError(f"{e} ({where})") from e
            state[mode] = (costs, d)
            if timed:
                records.append({"cohort": lanes, "mode": mode, "pattern": name, "ms": ms,
                                "rounds": rounds, "launches": launched,
                                "fit": None if w is None else w.fit,
                                "slab_rounds": None if w is None else w.slab_rounds,
                                "seam_abort": None if w is None else w.seam_abort,
                                "done": None if w is None else w.done,
                                "max_rel_err": gate["max_rel_err"],
                                "tol_ratio": gate["tol_ratio"]})

        jump = torch.from_numpy(update_clouds(rng, v, mesh_n)[0][1]).to(device)
        for mode in steps:
            one(mode, "warmup", jump, timed=False)
        for it in range(iters):
            for i, (name, pts) in enumerate(update_clouds(rng, v, mesh_n)):
                pts = torch.from_numpy(pts).to(device)
                for mode in (("on", "off") if (it + i) % 2 == 0 else ("off", "on")):
                    one(mode, name, pts)
        with uncounted():
            costs_np = state["on"][0].cpu().numpy()
            d = state["on"][1]
            R, C, V = srv.banded_plan.n_rows, srv.banded_plan.n_cols, mesh.num_vertices
            errs, same = [], []
            for b, (od, _) in enumerate(native_fields(v, ctx["f"], costs_np,
                                                      seeds[:2].cpu().numpy())):
                pot = d[:R, :C, b].reshape(-1)[:V].cpu().numpy()
                same.append(bool(np.array_equal(np.isfinite(pot), np.isfinite(od))))
                errs.append(percentile_rel_err(pot, od))
            oracle = {"lanes": 2, "max_rel_err": float(np.max(errs)), "same_finite_set": same,
                      "budget": 0.01}
            if not (oracle["max_rel_err"] < 0.01 and all(same)):
                raise AssertionError(f"replan_window oracle parity failed ({lanes} lanes): {oracle}")
        per = {}
        for name in ("jump", "drift", "clear"):
            row = {}
            for mode in steps:
                rs = [r for r in records if r["cohort"] == lanes and r["pattern"] == name
                      and r["mode"] == mode]
                row[mode] = {"ms": [r["ms"] for r in rs], "mean_ms": float(np.mean([r["ms"] for r in rs])),
                             "rounds": [r["rounds"] for r in rs],
                             "launches": {k: sum(r["launches"][k] for r in rs) for k in WINDOW_KERNELS}}
                if mode == "on":
                    row[mode].update(fit_share=fit_share(rs),
                                     slab_rounds=[r["slab_rounds"] for r in rs],
                                     seam_aborts=sum(bool(r["seam_abort"]) for r in rs),
                                     slab_done=sum(bool(r["done"]) for r in rs))
            per[name] = row
        mine = [r for r in records if r["cohort"] == lanes]
        cohorts[lanes] = {
            "per_pattern": per, "oracle": oracle,
            "ms_per_update": {m: float(np.mean([r["ms"] for r in mine if r["mode"] == m]))
                              for m in steps},
            "fit_share": fit_share([r for r in mine if r["mode"] == "on"]),
            "warm_vs_cold_max_rel": max(r["max_rel_err"] for r in mine),
            "warm_vs_cold_tol_ratio_max": max(r["tol_ratio"] for r in mine)}
        for mode in steps:
            log(f"# replan_window {lanes} lanes, window {mode}: "
                f"{cohorts[lanes]['ms_per_update'][mode]:.2f} ms an update")
        log(f"# replan_window {lanes} lanes: the window fit {cohorts[lanes]['fit_share']} "
            f"of the steps")
    launches = {k: kernels.LAUNCHES[k] for k in WINDOW_KERNELS}
    for k, n in launches.items():
        if n <= 0 and torch.device(device).type == "cuda":
            raise AssertionError(f"kernel {k} was not launched on the windowed replan path")
    out = {"phase": "replan_window", "warm_window": REPLAN_WINDOW, "iters": iters,
           "cohorts": {str(k): c for k, c in cohorts.items()}, "launches": launches,
           "gates": {"converged_every_step": True,
                     "warm_vs_cold_max_rel": max(r["max_rel_err"] for r in records)}}
    return out, {"launches": launches}


def cvp_hybrid(device, ctx, cctx) -> tuple[dict, dict]:
    """Phase 26 (after phase 13): the hybrid CVP transport at full width on
    the CVP phase's plan and warm-up draw (128 lanes): eikonal_solve_padded
    with and without graph_plan=the planner's Dijkstra warm plan
    (planners/cvp.py: the same side lengths, the CVP '>=' skip), in two
    settings: cold at orderings 4, and the planner's own (its Dijkstra
    warm start, orderings 2). Each solve timed (host clock around a
    synchronised solve), its rounds and its eik_pass and banded_pass
    launches. Gates: every solve converged; each hybrid field against the
    native CVP fast marching by cvp_oracle_gate (two lanes, 1%; their
    walked costs from the same descent the planner runs). Only the hybrid
    solves count for the path's launches."""
    import types

    import torch
    from mesh_navigation_torch.mesh import query
    from mesh_navigation_torch.ops import eikonal_gpu as eg
    from mesh_navigation_torch.ops import kernels
    from mesh_navigation_torch.planners.common import pose_chain

    planner, kplan, mesh = cctx["planner"], cctx["kplan"], cctx["planner"].mesh
    s, g = cctx["warm"]
    B = len(s)
    with uncounted():
        g_vids, seed_d, _, init = planner.banded_solve_inputs(torch.from_numpy(g).to(device))
        s_v = query.nearest_vertex_batch(mesh, planner.grid, torch.from_numpy(s[:2]).to(device))[0]
    graph = planner._dij_plan
    settings = {"cold": dict(orderings=4), "planner": dict(orderings=2, init_vb=init)}
    kernels.reset_launches()
    runs, gates = {}, {}
    R, Cp = kplan.n_rows, kplan.n_cols_pad
    for name, kw in settings.items():
        for mode in ("plain", "hybrid"):
            with uncounted() if mode == "plain" else contextlib.nullcontext():
                before = {k: kernels.LAUNCHES[k] for k in HYBRID_KERNELS}
                sync(device)
                t = time.perf_counter()
                res = eg.eikonal_solve_padded(kplan, g_vids, seed_d, atol=CVP_ATOL, rtol=CVP_RTOL,
                                              graph_plan=graph if mode == "hybrid" else None, **kw)
                sync(device)
                ms = (time.perf_counter() - t) * 1e3
                launched = {k: kernels.LAUNCHES[k] - before[k] for k in HYBRID_KERNELS}
            if not res.converged:
                raise AssertionError(f"cvp_hybrid {name} {mode} did not converge in {res.rounds}")
            runs[f"{name}_{mode}"] = {"rounds": res.rounds, "ms": ms, "launches": launched}
            log(f"# cvp_hybrid {name} {mode}: {res.rounds} rounds, {ms:.1f} ms, {launched}")
            if mode == "hybrid":
                with uncounted():
                    path, valid = eg.cvp_descend_paths(
                        kplan, mesh, cctx["ew"], res.d_pad.view(R * Cp, -1), s_v, g_vids[:2],
                        planner.max_path_len, tol=5e-3)
                    cost = pose_chain(mesh.vertices[path], valid, mesh.vertex_normals[path])[1]
                    field = types.SimpleNamespace(d_pad=res.d_pad, cost=cost, path_valid=valid,
                                                  lane_map=torch.arange(B, device=device))
                    gates[name] = cvp_oracle_gate(ctx, {**cctx, "warm_res": field},
                                                  phase=f"cvp_hybrid_{name}")
            del res
    launches = {k: kernels.LAUNCHES[k] for k in HYBRID_KERNELS}
    for k, n in launches.items():
        if n <= 0 and torch.device(device).type == "cuda":
            raise AssertionError(f"kernel {k} was not launched on the hybrid CVP path")
    out = {"phase": "cvp_hybrid", "lanes": B, "atol": CVP_ATOL, "rtol": CVP_RTOL,
           "graph_plan": {"n_rows": graph.n_rows, "n_cols": graph.n_cols,
                          "n_cols_pad": graph.n_cols_pad},
           "runs": runs, "launches": launches,
           "gates": {k: {"max_rel_err": x["max_rel_err"],
                         "walked_over_oracle_field_walk": [
                             l["walked_cost"] / l["oracle_field_walked_cost"] for l in x["lanes"]]}
                     for k, x in gates.items()}}
    return out, {"launches": launches}


SHARDS = 4                   # ranks of the sharded phase: 4 row shards, a (2, 2) grid
SHARDED_BATCH = 128          # lanes of each 1M sharded solve
SHARDED_KERNELS = ("banded_pass", "banded_pass_dirty")
GATHER_MESH_N = 320          # the reference dry run's terrain (102,400 vertices)
SHARDED_FIELD_RTOL = 1e-4    # the grid's sharded field against the single-device solve's
ORACLE_GATE = 0.01


class shard_pass_check:
    """Within this block, this rank's first forced down pass is held
    against the plain pass on the same shard input (the shard's field,
    dirty table, planes and lanes): the kernel's launch is the path's own,
    the plain pass runs on copies of its input. `result` holds the
    comparison (compare_fields, the flags, the dirty tables, the elements
    the pass changed, the plain pass's ms)."""

    def __enter__(self):
        from mesh_navigation_torch.ops import banded_gpu as bg

        self.bg, self.orig, self.result = bg, bg.directional_pass, None
        bg.directional_pass = self._pass
        return self

    def __exit__(self, *exc):
        self.bg.directional_pass = self.orig
        return False

    def _pass(self, d, cross, a_fwd, a_bwd, **kw):
        if self.result is not None or not kw.get("force") or kw.get("reverse"):
            return self.orig(d, cross, a_fwd, a_bwd, **kw)
        import torch

        d_in = d.clone()
        d_p = d.clone()
        dirty = kw.get("dirty")
        dirty_p = None if dirty is None else dirty.clone()
        chg = self.orig(d, cross, a_fwd, a_bwd, **kw)
        sync(d.device)
        t0 = time.perf_counter()
        chg_p = self.bg.directional_pass_plain(d_p, cross, a_fwd, a_bwd, **dict(kw, dirty=dirty_p))
        sync(d.device)
        plain_ms = (time.perf_counter() - t0) * 1e3
        cmp = compare_fields(d, d_p, kw["atol"], kw["rtol"])
        cmp.update(shape=list(d.shape), lanes=len(kw.get("xlanes") or ()),
                   flags_equal=bool(chg.item()) == bool(chg_p.item()),
                   dirty_equal=dirty is None or bool(torch.equal(dirty, dirty_p)),
                   elements_changed=int((d_p != d_in).sum()), plain_ms=plain_ms)
        self.result = cmp
        return chg


def sharded_field_tier(dev, mesh_n: int) -> dict:
    """sharded_field_solve on a (2, 2) grid of the ranks: the reference dry
    run's terrain (mesh_n x mesh_n) with steepness costs, four lanes from
    the seed, against the native heap Dijkstra (max |err| < 1e-3)."""
    from mesh_navigation_torch.mesh import synthetic
    from mesh_navigation_torch.mesh.arrays import build_mesh
    from mesh_navigation_torch.parallel import comm, make_device_mesh, shard_weights
    from mesh_navigation_torch.parallel import sharded_field_solve
    from mesh_navigation_torch.parallel.dryrun import oracle_max_err

    v, f = synthetic.terrain_mesh(mesh_n, mesh_n, spacing=0.5, hills=1.5, roughness=0.01, seed=0)
    mesh = build_mesh(v, f, device=dev)
    costs_np, _, W = steepness_weights(mesh)
    V = mesh.num_vertices
    seeds = np.random.default_rng(0).integers(0, V, 4)
    grid = make_device_mesh(2, 2)
    sw = shard_weights(mesh, W, 2)
    comm.reset_sent_bytes()
    sync(dev)
    t0 = time.perf_counter()
    d = sharded_field_solve(sw, seeds, grid, device=dev)
    sync(dev)
    solve_ms = (time.perf_counter() - t0) * 1e3
    sent = dict(comm.SENT_BYTES)
    err = oracle_max_err(v, f, costs_np, seeds, d[:, :V].T.cpu().numpy(), "sharded field solve")
    if not err < 1e-3:
        raise AssertionError(f"sharded_field_solve parity fail: {err}")
    return {"V": V, "grid": [2, 2], "lanes": 4, "solve_ms": solve_ms,
            "all_gather_bytes": sent["all_gather"], "oracle_max_abs_err": err}


def sharded_rank(rank: int, store: str, out_dir: str, backend: str, device, n: int,
                 gather_n: int) -> None:
    """One rank of phase 27, in a process of its own (spawned): the gather
    tiers (the reference's dry run, then sharded_field_solve on a (2, 2)
    grid), then the row-sharded banded solve of each 1M plan in
    `store`/plans.pt (each rank moves its own shard), rank 0 holding its
    first forced down pass against the plain pass. Launches and bytes are
    counted from a reset just before each 1M solve. Writes
    `out_dir`/rank{rank}.json; rank 0 also each solve's [V, B] field."""
    import torch
    import torch.distributed as tdist
    from mesh_navigation_torch.ops import kernels
    from mesh_navigation_torch.parallel import comm, distributed, make_device_mesh
    from mesh_navigation_torch.parallel import sharded_banded_solve
    from mesh_navigation_torch.parallel.dryrun import dryrun_multichip

    torch.set_num_threads(1)
    sys.stdout = sys.stderr          # the dry run's lines: standard output holds the phases' JSON
    distributed.initialize(backend, init_method=f"file://{out_dir}/rendezvous", world_size=n,
                           rank=rank)
    try:
        dev = distributed.local_device(device)
        cuda = dev.type == "cuda"
        out = {"rank": rank, "device": str(dev), "backend": backend}
        t0 = time.perf_counter()
        out["dryrun"] = dryrun_multichip(n, mesh_n=gather_n, device=dev)
        out["dryrun"]["s"] = time.perf_counter() - t0
        out["sharded_field"] = sharded_field_tier(dev, gather_n)
        plans = torch.load(os.path.join(store, "plans.pt"), mmap=True, weights_only=False)
        row_grid = make_device_mesh(n, 1)
        for name, p in plans.items():
            check = shard_pass_check() if rank == 0 else contextlib.nullcontext()
            kernels.reset_launches()
            comm.reset_sent_bytes()
            if cuda:
                torch.cuda.reset_peak_memory_stats(dev)
            tdist.barrier()
            t0 = time.perf_counter()
            with check:
                d, rounds, conv = sharded_banded_solve(p["splan"], p["seeds"], row_grid,
                                                       atol=p["atol"], rtol=p["rtol"], device=dev)
                sync(dev)
            solve_ms = (time.perf_counter() - t0) * 1e3
            out[name] = {"rounds": rounds, "converged": conv, "solve_ms": solve_ms,
                         "launches": {k: kernels.LAUNCHES[k] for k in SHARDED_KERNELS},
                         "sent_bytes": dict(comm.SENT_BYTES),
                         "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9 if cuda else None,
                         "shard_pass_check": check.result if rank == 0 else None}
            if rank == 0:
                np.save(os.path.join(out_dir, f"{name}.npy"), d.cpu().numpy())
            del d
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
            json.dump(out, fh)
        tdist.barrier()
    finally:
        tdist.destroy_process_group()


def field_agreement(got: np.ndarray, ref, chunk: int = 1 << 17) -> dict:
    """A sharded [V, B] field (host, memory-mapped) against the
    single-device one (a tensor on the card) in row chunks: finite support
    equal, bit for bit, the largest relative difference."""
    import torch

    same_support, bitwise, max_rel = True, True, 0.0
    for i in range(0, got.shape[0], chunk):
        g = torch.from_numpy(np.array(got[i:i + chunk])).to(ref.device)
        r = ref[i:i + chunk]
        fin = torch.isfinite(r)
        same_support &= bool(torch.equal(torch.isfinite(g), fin))
        bitwise &= bool(torch.equal(g, r))
        rel = torch.where(fin, (g - r).abs() / r.abs().clamp(min=1e-6), torch.zeros_like(r))
        max_rel = max(max_rel, float(rel.max()))
    return {"same_finite_support": same_support, "bitwise": bitwise, "max_rel_err": max_rel}


def sharded(device, ctx, grid_kplan, ictx, gather_n: int = GATHER_MESH_N,
            batch: int = SHARDED_BATCH, n: int = SHARDS) -> tuple[dict, dict]:
    """Phase 27 (after phase 19): the parallel/ package on torch.distributed.
    The main terrain's plan (V = 1,048,576, atol = rtol = 0, the
    reference's default) and the irregular phase's plan (its atol / rtol),
    `batch` lanes from the seed each, cut into n row shards; n ranks
    spawned (gloo, every rank on this card; then NCCL, one rank a card,
    where the machine has n cards), each running the gather tiers at
    gather_n and then both sharded solves (sharded_rank). Gates: every rank
    exits 0; the gather tiers' oracle asserts; each solve converged; the
    grid's reachability that of the single-device banded_solve_padded
    (converge="round") at the same tolerance and its fields within 1e-4
    relative of it; two lanes (grid) and eight (irregular) below 1% of the
    native heap Dijkstra at the 99.9th percentile; rank 0's first forced
    down pass of each solve bit for bit its plain pass, dirty tables and
    flags equal; the pass kernel launched. Prints rounds against the
    single-device solve's, ms a round, bytes sent a round a rank, peak
    memory a rank."""
    import shutil
    import tempfile

    import torch
    import torch.multiprocessing as mp
    from mesh_navigation_torch.ops import banded_gpu as bg
    from mesh_navigation_torch.ops import kernels
    from mesh_navigation_torch.parallel import build_sharded_banded_plan

    cuda = torch.device(device).type == "cuda"
    if cuda:
        kernels.build_all()
    singles, plans, oracles, info = {}, {}, {}, {}
    cases = (("grid", ctx, grid_kplan, 0.0, 0.0, 2), ("irregular", ictx, ictx["kplan"],
             IRREGULAR_ATOL, IRREGULAR_RTOL, IRREGULAR_ORACLE_LANES))
    for i, (name, c, kplan, atol, rtol, n_oracle) in enumerate(cases):
        seeds = np.random.default_rng(SEED + 27 + i).integers(0, kplan.num_vertices, batch)
        with uncounted():
            sync(device)
            t0 = time.perf_counter()
            res = bg.banded_solve_padded(kplan, torch.from_numpy(seeds).to(device), atol=atol,
                                         rtol=rtol, converge="round")
            sync(device)
            single_ms = (time.perf_counter() - t0) * 1e3
        R, C, V = kplan.n_rows, kplan.n_cols, kplan.num_vertices
        singles[name] = {"field": res.d_pad[:R, :C, :batch].reshape(-1, batch)[:V],
                         "rounds": res.rounds, "converged": res.converged, "ms": single_ms}
        del res
        t0 = time.perf_counter()
        splan = build_sharded_banded_plan(kplan, n)
        plans[name] = {"splan": splan, "seeds": seeds, "atol": atol, "rtol": rtol}
        oracles[name] = native_fields(c["v"], c["f"], c["costs_np"], seeds[:n_oracle])
        info[name] = {"V": V, "R": R, "Cp": kplan.n_cols_pad, "atol": atol, "rtol": rtol,
                      "ghost": splan.ghost, "rows_per_shard": splan.rows_per_shard,
                      "rp_local": splan.rp_local, "xlanes": [len(kplan.xlanes_down),
                                                             len(kplan.xlanes_up)],
                      "n_residual": kplan.n_residual, "n_far": splan.n_far,
                      "near_usable_per_shard": torch.isfinite(splan.res_w).sum(1).tolist(),
                      "plan_s": time.perf_counter() - t0,
                      "single_rounds": singles[name]["rounds"], "single_ms": single_ms}
        log(f"# sharded {name}: {info[name]}")
    backends = [("gloo", "cuda:0" if cuda else "cpu")]
    if cuda and torch.cuda.device_count() >= n:
        backends.append(("nccl", None))
    runs = {}
    store = tempfile.mkdtemp(prefix="chip_smoke_sharded_")
    try:
        torch.save(plans, os.path.join(store, "plans.pt"))
        for backend, dev_arg in backends:
            out_dir = os.path.join(store, backend)
            os.makedirs(out_dir)
            t0 = time.perf_counter()
            mp.spawn(sharded_rank, args=(store, out_dir, backend, dev_arg, n, gather_n),
                     nprocs=n, join=True)
            spawn_s = time.perf_counter() - t0
            ranks = []
            for r in range(n):
                with open(os.path.join(out_dir, f"rank{r}.json")) as fh:
                    ranks.append(json.load(fh))
            run = {"backend": backend, "ranks": n,
                   "cards": len({x["device"] for x in ranks}), "devices": [x["device"] for x in ranks],
                   "spawn_s": spawn_s, "dryrun": ranks[0]["dryrun"],
                   "sharded_field": ranks[0]["sharded_field"]}
            for name in plans:
                per = [x[name] for x in ranks]
                rounds = per[0]["rounds"]
                if not all(p["converged"] and p["rounds"] == rounds for p in per):
                    raise AssertionError(f"sharded {name} ({backend}): not converged or ranks "
                                         f"disagree: {[(p['rounds'], p['converged']) for p in per]}")
                got = np.load(os.path.join(out_dir, f"{name}.npy"), mmap_mode="r")
                agree = field_agreement(got, singles[name]["field"])
                lanes, cols = [], np.ascontiguousarray(got[:, :len(oracles[name])])
                for b, (od, _) in enumerate(oracles[name]):
                    col = cols[:, b]
                    if not np.array_equal(np.isfinite(col), np.isfinite(od)):
                        raise AssertionError(f"sharded {name} ({backend}) lane {b}: reachability "
                                             f"differs from the native heap Dijkstra")
                    lanes.append(percentile_rel_err(col, od))
                del got
                check = per[0]["shard_pass_check"]
                launches = {k: sum(p["launches"][k] for p in per) for k in SHARDED_KERNELS}
                check_ms = check["plain_ms"] if check else 0.0
                solve_ms = max(p["solve_ms"] for p in per)
                run[name] = {
                    **info[name], "rounds": rounds, "converged": True,
                    "solve_ms": solve_ms, "solve_ms_less_check": solve_ms - check_ms,
                    "ms_per_round": (solve_ms - check_ms) / rounds,
                    "p2p_bytes_per_round": [p["sent_bytes"]["p2p"] / rounds for p in per],
                    "all_reduce_bytes_per_round": [p["sent_bytes"]["all_reduce"] / rounds
                                                   for p in per],
                    "peak_mem_gb": [p["peak_mem_gb"] for p in per], "launches": launches,
                    "vs_single": agree, "oracle_rel_err": lanes, "shard_pass_check": check,
                }
                if name == "grid" and not (agree["same_finite_support"]
                                           and agree["max_rel_err"] <= SHARDED_FIELD_RTOL):
                    raise AssertionError(f"sharded grid ({backend}) against the single-device "
                                         f"solve: {agree}")
                if not max(lanes) < ORACLE_GATE:
                    raise AssertionError(f"sharded {name} ({backend}) oracle {lanes} exceeds 1%")
                if not (check and check["bitwise"] and check["flags_equal"]
                        and check["dirty_equal"] and check["elements_changed"] > 0):
                    raise AssertionError(f"sharded {name} ({backend}): the shard's pass kernel "
                                         f"disagrees with its plain version: {check}")
                if cuda and launches["banded_pass"] <= 0:
                    raise AssertionError(f"sharded {name}: the pass kernel was not launched")
                log(f"# sharded {name} ({backend}, {n} ranks, {run['cards']} card(s)): "
                    f"{rounds} rounds (single {info[name]['single_rounds']}), "
                    f"{run[name]['ms_per_round']:.2f} ms a round")
            runs[backend] = run
    finally:
        shutil.rmtree(store, ignore_errors=True)
    out = {"phase": "sharded", "shards": n, "lanes": batch, "gather_n": gather_n, "runs": runs}
    gloo = runs["gloo"]
    return out, {"launches": {k: gloo["grid"]["launches"][k] + gloo["irregular"]["launches"][k]
                              for k in SHARDED_KERNELS},
                 "max_abs_err": max(gloo[k]["shard_pass_check"]["max_abs_err"]
                                    for k in ("grid", "irregular"))}


SOLVE_MODES_BATCH = 128      # lanes of the exact modes, four_dir and structured bf16
SOLVE_MODES_STEPS = 5        # partial scan depth (pallas_banded.py:1460-1463: 5-6 useful)
SOLVE_MODES_KERNELS = ("banded_pass", "banded_pass_dirty", "banded_pass_bf16",
                       "banded_pass_partial", "banded_pass_defer", "banded_pass_noskip",
                       "class_pred", "class_pred_bf16", "check", "check_bf16", "fused_sweep",
                       "fused_sweep_bf16")
PROBE_ROUNDS = 6             # rounds of each solve whose launches are timed one by one
# exact modes read, not gated, at the main path's tolerance and gated at 1e-5 (solve_modes)
TOLERANCE_READ_ONLY = ("scan_dirs_up", f"scan_steps_{SOLVE_MODES_STEPS}")
BF16_NOTE = ("bf16 distance fields are approximate: the reference measured 63% max relative "
             "error at 1M (NOTES_ROUND3.md:111-116; ~0.5 edge increments round away at "
             "ulp(256) = 2); reported, not gated")


def slab_check(pass_fn, d, cross, a_fwd, a_bwd, kw: dict, r0: int, device,
               rows: int = IRREGULAR_SLAB_ROWS) -> dict:
    """A pass kernel (`pass_fn`, any mode in `kw`) against its plain version
    on rows r0 .. r0 + rows of one launch's own input, at the launch's full
    width and lanes, with its dirty table, extended lanes and flags; rows
    outside the slab read as +inf to both. Fields bit for bit, dirty
    tables, flags and rows walked equal; also the plain version's time."""
    import torch
    from mesh_navigation_torch.ops import banded_gpu as bg

    r1 = min(r0 + rows, d.shape[0])
    sl = lambda t: None if t is None else t[r0:r1].contiguous()   # noqa: E731
    d_k = d[r0:r1].clone()
    d_p = d_k.clone()
    xlist = kw.get("xlist")
    kw_s = dict(kw, xcross=sl(kw.get("xcross")),
                xlist=None if xlist is None else xlist.rows(r0, r1))
    dirty = kw.get("dirty")
    dirty_k = None if dirty is None else dirty[:, r0:r1].clone()
    dirty_p = None if dirty is None else dirty_k.clone()
    wk = torch.zeros(1, dtype=torch.int32, device=d.device)
    wp = torch.zeros(1, dtype=torch.int64, device=d.device)
    chg_k = pass_fn(d_k, sl(cross), sl(a_fwd), sl(a_bwd),
                    **dict(kw_s, dirty=dirty_k, rows_walked=wk))
    got = []
    plain_ms = time_ms(lambda: got.append(bg.directional_pass_plain(
        d_p, sl(cross), sl(a_fwd), sl(a_bwd), bb=bg.PASS_LANES,
        **dict(kw_s, dirty=dirty_p, rows_walked=wp))), device)
    cmp = compare_fields(d_k.float(), d_p.float(), kw["atol"], kw["rtol"])
    cmp.update(rows=[r0, r1], shape=list(d_k.shape), dtype=str(d.dtype).split(".")[-1],
               force=bool(kw.get("force")), reverse=bool(kw["reverse"]),
               modes={k: kw[k] for k in ("skip", "scan_steps", "defer") if k in kw},
               flags_equal=bool(chg_k.item()) == bool(got[0].item()),
               dirty_equal=dirty is None or bool(torch.equal(dirty_k, dirty_p)),
               rows_walked=int(wk.item()), rows_walked_equal=int(wk.item()) == int(wp.item()),
               elements_changed=int((d_p != sl(d)).sum()), plain_ms=plain_ms)
    cmp["bitwise"] = bool(torch.equal(d_k, d_p))
    if not (cmp["bitwise"] and cmp["flags_equal"] and cmp["dirty_equal"]
            and cmp["rows_walked_equal"] and cmp["elements_changed"] > 0):
        raise AssertionError(f"the pass kernel disagrees with its plain version on a slab of "
                             f"the solve_modes phase's input: {cmp}")
    return cmp


class PassProbe:
    """Inside the block, every directional_pass launch is timed by its own
    event pair (ms, rows walked, a bound from what that launch's data
    needs: one read of the field and the planes it reads, the dirty table
    read and written, one write of each element it changed, against the
    pass's operations: PASS_OPS an element, or 10 + 4 * scan_steps at
    partial depth, plus XLANE_OPS a lane's edge and lane of the batch; the
    extended lanes' bytes and edges are their lists'), and the first launch of each
    wanted key (`want(kw, d)` -> key or None) with labels to change is held
    against the plain version on a slab of its own input (slab_check). Not
    counted for any path."""

    def __init__(self, device, want):
        self.device, self.want = device, want
        self.ms, self.bound, self.walked, self.slabs = [], [], [], {}

    def __enter__(self):
        from mesh_navigation_torch.ops import banded_gpu as bg

        self.bg, self.orig = bg, bg.directional_pass
        self.counts = uncounted()
        self.counts.__enter__()
        bg.directional_pass = self._pass
        return self

    def __exit__(self, *exc):
        self.bg.directional_pass = self.orig
        self.counts.__exit__(*exc)
        return False

    def _pass(self, d, cross, a_fwd, a_bwd, **kw):
        import torch

        bg = self.bg
        Rp, Cp, Bp = d.shape
        nb = Bp // bg.PASS_LANES
        key = self.want(kw, d)
        slab = key is not None and key not in self.slabs
        if slab:
            d_in = d.clone()
            dirty_in = None if kw.get("dirty") is None else kw["dirty"].clone()
        before = d.clone()
        nw = torch.zeros(1, dtype=torch.int32, device=d.device)
        got = []
        self.ms.append(time_ms(lambda: got.append(self.orig(d, cross, a_fwd, a_bwd,
                                                            **dict(kw, rows_walked=nw))),
                               self.device))
        diff = d != before
        del before
        n_written = int(diff.sum())
        es = d.element_size()
        steps = 0 if kw.get("defer") else kw.get("scan_steps", 0)
        ops = (10 + 4 * steps) if steps else PASS_OPS
        xl_bytes, xl_edges = xlist_size(kw.get("xlist"), Cp)
        planes = 5 * Rp * Cp * 4 + xl_bytes
        dirty_b = 2 * nb * Rp * 4 if kw.get("dirty") is not None else 0
        bytes_s = (Rp * Cp * Bp * es + planes + dirty_b + n_written * es) / HBM_BYTES_PER_S
        ops_s = (ops * Rp * Cp + XLANE_OPS * xl_edges) * Bp / F32_OPS_PER_S
        self.bound.append(max(bytes_s, ops_s) * 1e3)
        self.walked.append(int(nw.item()) / (Rp * nb))
        if slab and n_written:
            rows = diff.any(dim=2).any(dim=1).nonzero()[:, 0]
            r = int(rows[len(rows) // 2])
            r0 = max(0, min(r - IRREGULAR_SLAB_ROWS // 2, Rp - IRREGULAR_SLAB_ROWS))
            self.slabs[key] = slab_check(self.orig, d_in, cross, a_fwd, a_bwd,
                                         dict(kw, dirty=dirty_in), r0, self.device)
        return got[0]

    def summary(self) -> dict:
        return {"launches": len(self.ms), "ms": float(np.mean(self.ms)) if self.ms else None,
                "bound_ms": float(np.mean(self.bound)) if self.bound else None,
                "rows_walked_share": float(np.mean(self.walked)) if self.walked else None,
                "max_abs_err": max((c["max_abs_err"] for c in self.slabs.values()), default=0.0)}


def oracle_reading(native, pot, sv) -> float:
    """The larger of the start vertex's relative error and the field's
    99.9th-percentile one over lanes pot [n, V] against `native`, the
    native heap Dijkstra's (dist, pred) from each lane's goal (bench.py:
    169-204)."""
    errs = []
    for b, (od, _) in enumerate(native):
        ref, got = od[sv[b]], pot[b, sv[b]]
        if np.isfinite(ref) and ref > 0:
            errs.append(abs(got - ref) / ref)
        errs.append(percentile_rel_err(pot[b], od))
    return float(np.max(errs))


def _field_lanes(plan, d_pad, lanes) -> np.ndarray:
    """[len(lanes), V] f32 potential of a padded field's lanes (no grouping)."""
    R, C, V = plan.n_rows, plan.n_cols, plan.num_vertices
    return d_pad[:R, :C, lanes].reshape(R * C, -1)[:V].T.float().cpu().numpy()


def solve_modes(device, ctx, grid_kplan, ictx, sp: dict, batch: int = SOLVE_MODES_BATCH,
                main_batch: int = BATCH) -> tuple[dict, dict]:
    """The solver's opt-in modes at full width (V = 1,048,576).
    1. The main pipeline (plan_batch_banded(light=True) +
       compute_velocity_banded, `main_batch` lanes, the main path's draw)
       with dtype=bfloat16 (the controller at tol 1e-2) and with
       scan_steps=SOLVE_MODES_STEPS in f32: one warm-up and one timed
       iteration each (a bf16 solve that runs to max_rounds is not run
       twice): solves/s, stages, rounds, `converged`; the pass launches
       of a third solve of the draw timed one by one against their bounds
       (PassProbe). Gates: partial depth 1% on 2 lanes against the native
       heap Dijkstra; bf16 no NaN and the f32 field's finite support, its
       oracle reading printed, not gated.
    2. The exact modes on the grid plan, `batch` lanes, converge="round",
       at the main path's tolerance: the default, skip_rows=False,
       scan_dirs="up", scan_steps: rounds, ms, each field's distance to
       the default's and 1% on 2 lanes against the native heap Dijkstra,
       gated for the default and skip_rows=False (also within twice the
       stopping tolerance of the default) and read for the deferring and
       partial-depth passes, which run again at atol = rtol = 1e-5 gated
       at 1%.
    3. four_dir on the irregular phase's plan, `batch` lanes at its
       tolerance: transpose_banded_plan (timed; its lanes and the lanes it
       leaves out printed), then two-direction and four-direction solves:
       rounds, ms, the transposes' ms; 1% on 2 lanes.
    4. The structured tier in bf16, `batch` lanes: sweeps, ms, solves/s
       beside the structured phase's f32 figures (`sp`); its oracle
       reading printed.
    5. Each new kernel mode against its plain version, bit for bit, on the
       phase's own inputs: the pass on 48-row slabs of a launch of each
       mode (bf16 main and dirty, partial depth, defer, no-skip, the
       transposed field), class_pred in bf16 (int8, certificate, ids) and
       check in bf16 on the bf16 main field, fused_sweep in bf16 on the
       structured solve's matrix; each timed against its bound (a bf16
       element is 2 bytes).
    Launches are counted over 1-4 (reset before 1, read after 4)."""
    import torch
    from mesh_navigation_torch.config import ControllerConfig
    from mesh_navigation_torch.control import MeshController
    from mesh_navigation_torch.control.controller import initial_state
    from mesh_navigation_torch.mesh import query
    from mesh_navigation_torch.ops import banded_gpu as bg
    from mesh_navigation_torch.ops import kernels, sweeps
    from mesh_navigation_torch.ops import structured as st
    from mesh_navigation_torch.ops import sweep_gpu as sg
    from mesh_navigation_torch.planners.dijkstra import potential_lanes
    from mesh_navigation_torch.utils.timing import StageTimer

    t_phase = time.perf_counter()
    cuda = torch.device(device).type == "cuda"
    bf16 = torch.bfloat16
    planner, mesh, v, f, costs_np = (ctx[k] for k in ("planner", "mesh", "v", "f", "costs_np"))
    kplan = grid_kplan
    mesh_n = int(round(np.sqrt(mesh.num_vertices)))
    costs = torch.from_numpy(costs_np).to(device)
    ctrl = MeshController(mesh, ControllerConfig(), grid=planner.grid, device=device)
    out = {"phase": "solve_modes", "V": mesh.num_vertices}
    detail = {}
    kernels.reset_launches()

    # 1. the main pipeline at bf16 and at partial depth
    s_all, g_all, q_all = ctx["warm"]
    s, g, q = s_all[:main_batch], g_all[:main_batch], q_all[:main_batch]
    gv2 = query.nearest_vertex_batch(mesh, planner.grid, torch.from_numpy(g[:2]).to(device))[0]
    sv2 = query.nearest_vertex_batch(mesh, planner.grid, torch.from_numpy(s[:2]).to(device))[0]
    gv2, sv2 = gv2.cpu().numpy(), sv2.cpu().numpy()
    native_main = native_fields(v, f, costs_np, gv2)
    pipes, fields = {}, {}
    for name, kw, tol in (("bf16", dict(dtype=bf16), 1e-2),
                          (f"scan_steps_{SOLVE_MODES_STEPS}", dict(scan_steps=SOLVE_MODES_STEPS),
                           1e-5)):
        def step(timer=None, kw=kw, tol=tol):
            st0 = initial_state(torch.from_numpy(g).to(device), torch.tensor([1.0, 0.0, 0.0]))
            res = planner.plan_batch_banded(kplan, torch.from_numpy(s), torch.from_numpy(g),
                                            atol=ATOL, rtol=RTOL, timer=timer, **kw)
            cmds, _ = ctrl.compute_velocity_banded(
                kplan, res.d_pad.reshape(-1, res.d_pad.shape[-1]), costs, torch.from_numpy(s),
                torch.from_numpy(q), st0, tol=tol, lane_map=res.lane_map, timer=timer)
            return res, cmds

        before = kernels.LAUNCHES["banded_pass"]
        t0 = time.perf_counter()
        res, cmds = step()
        sync(device)
        first_s = time.perf_counter() - t0
        runs = [{"rounds": res.rounds, "converged": bool(res.converged)}]
        timer = StageTimer(device)
        if res.converged:
            t0 = time.perf_counter()
            res, cmds = step(timer)
            sync(device)
            dt = time.perf_counter() - t0
            runs.append({"rounds": res.rounds, "converged": bool(res.converged)})
            stages = timer.totals()
        else:
            dt, stages = first_s, {}
        launches = kernels.LAUNCHES["banded_pass"] - before
        pot = potential_lanes(kplan, res.d_pad, res.lane_map, [0, 1])
        err = oracle_reading(native_main, pot, sv2)
        fields[name] = res.d_pad
        pipes[name] = {
            "lanes": main_batch, "atol": max(ATOL, bg.BF16_ATOL) if "bf16" in name else ATOL,
            "rtol": max(RTOL, bg.BF16_RTOL) if "bf16" in name else RTOL,
            "runs": runs, "warmup_s": first_s, "timed_s": dt,
            "solves_per_s": main_batch / dt, "stage_ms": stages,
            "pass_launches": launches, "oracle_rel_err": err,
            "commands_finite": bool(torch.isfinite(cmds.linear).all()),
            "reach_rate": float((res.outcome == 0).float().mean())}
        res = cmds = None
    part = pipes[f"scan_steps_{SOLVE_MODES_STEPS}"]
    if not (part["runs"][-1]["converged"] and part["oracle_rel_err"] < ORACLE_GATE):
        raise AssertionError(f"solve_modes: the partial-depth pipeline failed its gate: {part}")
    half, full = fields["bf16"], fields[f"scan_steps_{SOLVE_MODES_STEPS}"]
    pipes["bf16"].update(
        note=BF16_NOTE, has_nan=bool(torch.isnan(half).any()),
        support_equal_f32=bool(torch.equal(torch.isfinite(half), torch.isfinite(full))))
    if pipes["bf16"]["has_nan"] or not pipes["bf16"]["support_equal_f32"]:
        raise AssertionError(f"solve_modes: the bf16 field failed its gates: {pipes['bf16']}")
    del full, fields[f"scan_steps_{SOLVE_MODES_STEPS}"]
    out["main_pipeline"] = pipes

    # 2. the exact modes on the grid plan: at the main path's tolerance, and
    # the two that drop sub-tolerance gains again at the reference solve's
    # default tolerance
    rng = np.random.default_rng(SEED + 14)
    gv = torch.from_numpy(rng.integers(0, mesh.num_vertices, batch)).to(device)
    sv = torch.from_numpy(rng.integers(0, mesh.num_vertices, batch)).to(device)
    max_rounds = max(planner.config.max_sweeps // 2, 64)
    modes = {"default": {}, "skip_rows_false": {"skip_rows": False},
             "scan_dirs_up": {"scan_dirs": "up"},
             f"scan_steps_{SOLVE_MODES_STEPS}": {"scan_steps": SOLVE_MODES_STEPS}}
    # (the deferring pass moves a row of progress a round: at 1e-5 it takes
    # more than the planner's 64 rounds)
    tight = {f"{name}_tol_1e-5": dict(kw, atol=1e-5, rtol=1e-5, max_rounds=256)
             for name, kw in modes.items() if name in TOLERANCE_READ_ONLY}
    exact, ref_field = {}, None
    native_exact = native_fields(v, f, costs_np, gv[:2].cpu().numpy())
    sv_exact = sv[:2].cpu().numpy()
    for name, kw in {**modes, **tight}.items():
        kw = dict(dict(atol=ATOL, rtol=RTOL, max_rounds=max_rounds), **kw)
        t0 = time.perf_counter()
        res = bg.banded_solve_padded(kplan, gv, converge="round", **kw)
        sync(device)
        ms = (time.perf_counter() - t0) * 1e3
        row = {"rounds": res.rounds, "converged": bool(res.converged), "ms": ms,
               "atol": kw["atol"], "rtol": kw["rtol"]}
        if ref_field is None:
            ref_field = res.d_pad
        elif name in modes:
            cmp = compare_fields(res.d_pad, ref_field, 2 * ATOL, 2 * RTOL)
            row["vs_default"] = {k: cmp[k] for k in ("same_finite_support", "max_rel_err",
                                                     "within_tol", "tol")}
        row["oracle_rel_err"] = oracle_reading(native_exact, _field_lanes(kplan, res.d_pad, [0, 1]),
                                               sv_exact)
        exact[name] = row
        # the deferring and partial-depth passes drop sub-tolerance gains
        # the default's scans keep (the deferring down pass writes a row
        # only where a gain passes the tolerance, and scans nothing), so at a
        # loose tolerance their quiet round can stop several tolerances
        # above the fixed point (the reference's own deferring solve stops
        # 0.33% from the heap Dijkstra on a 32 x 32 terrain at the main
        # path's tolerance, its default 3e-7): read there, gated at the
        # reference solve's default tolerance
        if name in TOLERANCE_READ_ONLY:
            continue
        if not (row["converged"] and row["oracle_rel_err"] < ORACLE_GATE
                and row.get("vs_default", {"within_tol": True})["within_tol"]):
            raise AssertionError(f"solve_modes: exact mode {name} failed its gates: {row}")
        res = None
    out["exact_modes"] = {"lanes": batch, "converge": "round", "modes": exact,
                          "read_not_gated": list(TOLERANCE_READ_ONLY)}

    # 3. four_dir on the irregular plan
    iplan = ictx["kplan"]
    t0 = time.perf_counter()
    plan_t = bg.transpose_banded_plan(iplan)
    sync(device)
    t_transpose_plan = time.perf_counter() - t0
    irng = np.random.default_rng(SEED + 15)
    igv = torch.from_numpy(irng.integers(0, iplan.num_vertices, batch)).to(device)
    isv = torch.from_numpy(irng.integers(0, iplan.num_vertices, batch)).to(device)
    four = {"plan_t": {"n_rows": plan_t.n_rows, "n_cols": plan_t.n_cols,
                       "n_cols_pad": plan_t.n_cols_pad, "build_s": t_transpose_plan,
                       "xlanes_down": [list(x) for x in plan_t.xlanes_down],
                       "xlanes_up": [list(x) for x in plan_t.xlanes_up],
                       "dropped": [list(x) for x in plan_t.xlanes_dropped]},
            "lanes": batch, "atol": IRREGULAR_ATOL, "rtol": IRREGULAR_RTOL}
    native_irr = native_fields(ictx["v"], ictx["f"], ictx["costs_np"], igv[:2].cpu().numpy())
    for name, kw in (("two_dir", {}), ("four_dir", {"four_dir": True, "plan_t": plan_t})):
        timer = StageTimer(device)
        t0 = time.perf_counter()
        res = bg.banded_solve_padded(iplan, igv, max_rounds=256, atol=IRREGULAR_ATOL,
                                     rtol=IRREGULAR_RTOL, timer=timer, **kw)
        sync(device)
        row = {"rounds": res.rounds, "converged": bool(res.converged),
               "ms": (time.perf_counter() - t0) * 1e3, "stage_ms": timer.totals()}
        row["oracle_rel_err"] = oracle_reading(native_irr, _field_lanes(iplan, res.d_pad, [0, 1]),
                                               isv[:2].cpu().numpy())
        four[name] = row
        if not (row["converged"] and row["oracle_rel_err"] < ORACLE_GATE):
            raise AssertionError(f"solve_modes: {name} failed its gates: {row}")
        res = None
    out["four_dir"] = four

    # 4. the structured tier in bf16
    W = sweeps.slot_weights_np(mesh, costs_np, cost_limit=2.0, edge_cost_factor=1.0)
    t0 = time.perf_counter()
    oplan = planner.prepare_offset_plan(W)
    sync(device)
    oplan_s = time.perf_counter() - t0
    Wt = torch.from_numpy(W).to(device)
    srng = np.random.default_rng(SEED + 16)
    sgv = [torch.from_numpy(srng.integers(0, mesh.num_vertices, batch)).to(device)
           for _ in range(2)]
    runs = []
    timer = StageTimer(device)
    for i, goals in enumerate(sgv):
        t0 = time.perf_counter()
        fres = st.batched_field_structured(mesh, Wt, oplan, goals, dtype=bf16,
                                           max_sweeps=planner.config.max_sweeps,
                                           block_sweeps=max(planner.config.block_sweeps, 16),
                                           timer=timer if i else None)
        sync(device)
        runs.append({"sweeps": fres.sweeps, "converged": bool(fres.converged),
                     "ms": (time.perf_counter() - t0) * 1e3})
        if i == 0:
            s_err = oracle_reading(native_fields(v, f, costs_np, sgv[0][:2].cpu().numpy()),
                                   fres.dist[:2].cpu().numpy(), sgv[0][2:4].cpu().numpy())
        fres = None
    if not all(r["converged"] for r in runs):
        raise AssertionError(f"solve_modes: a bf16 structured solve did not converge: {runs}")
    out["structured_bf16"] = {
        "lanes": batch, "offset_plan_s": oplan_s, "runs": runs,
        "solves_per_s": batch / (runs[-1]["ms"] / 1e3), "stage_ms": timer.totals(),
        "f32_solves_per_s": sp.get("solves_per_s"), "f32_sweeps": sp.get("solves"),
        "oracle_rel_err": s_err, "note": BF16_NOTE.replace("bf16 distance fields are",
                                                         "bf16 structured fields are")}
    launches = {k: kernels.LAUNCHES[k] for k in SOLVE_MODES_KERNELS}
    out["launches"] = launches
    if cuda:
        for k in ("banded_pass_bf16", "banded_pass_partial", "banded_pass_defer",
                  "banded_pass_noskip", "class_pred_bf16", "fused_sweep_bf16"):
            if launches[k] <= 0:
                raise AssertionError(f"kernel mode {k} was not launched in solve_modes")

    # 5. each new kernel mode against its plain version, timed against its bound
    def want(kw, d):
        if kw.get("defer"):
            return "defer"
        if not kw.get("skip", True):
            return "noskip"
        if kw.get("scan_steps"):
            return "partial"
        if d.dtype == bf16:
            return "bf16_dirty" if kw.get("dirty") is not None else "bf16_main"
        return None

    # the probes' solves run at most PROBE_ROUNDS rounds: a launch's time
    # does not depend on how many follow it
    probes = {}
    gvm = query.nearest_vertex_batch(mesh, planner.grid, torch.from_numpy(g).to(device))[0]
    order, _ = bg.group_lanes(gvm, mesh.num_vertices)
    with PassProbe(device, want) as pr:
        bg.banded_solve_padded(kplan, gvm[order], max_rounds=PROBE_ROUNDS, atol=ATOL, rtol=RTOL,
                               dtype=bf16)
    probes["bf16_main"] = pr
    with PassProbe(device, want) as pr:
        bg.banded_solve_padded(iplan, igv, max_rounds=PROBE_ROUNDS, atol=IRREGULAR_ATOL,
                               rtol=IRREGULAR_RTOL, dtype=bf16)
    probes["bf16_dirty"] = pr
    for name, kw in (("partial", {"scan_steps": SOLVE_MODES_STEPS}),
                     ("defer", {"scan_dirs": "up"}), ("noskip", {"skip_rows": False})):
        with PassProbe(device, want) as pr:
            bg.banded_solve_padded(kplan, gv, max_rounds=PROBE_ROUNDS, atol=ATOL, rtol=RTOL,
                                   converge="round", **kw)
        probes[name] = pr
    in_columns = [False]
    col_passes = bg._column_passes

    def marked(*a, **kw):
        in_columns[0] = True
        try:
            return col_passes(*a, **kw)
        finally:
            in_columns[0] = False

    bg._column_passes = marked
    try:
        with PassProbe(device, lambda kw, d: "transposed" if in_columns[0] else None) as pr:
            bg.banded_solve_padded(iplan, igv, max_rounds=PROBE_ROUNDS, atol=IRREGULAR_ATOL,
                                   rtol=IRREGULAR_RTOL, four_dir=True, plan_t=plan_t)
    finally:
        bg._column_passes = col_passes
    probes["transposed"] = pr
    pass_modes = {}
    for name, pr in probes.items():
        summ = pr.summary()
        if name not in pr.slabs:
            raise AssertionError(f"solve_modes: no {name} pass launch to hold against plain")
        pass_modes[name] = dict(summ, slab=pr.slabs[name])
    detail["pass_modes"] = pass_modes

    d = fields.pop("bf16")
    Rp, Cp, Bp = d.shape
    N = Rp * Cp * Bp
    V = kplan.num_vertices
    with uncounted():
        pred = check_pred_pair(kplan, d, max(ATOL, bg.BF16_ATOL), max(RTOL, bg.BF16_RTOL),
                               tol=1e-2)
        w8 = bg._w8_planes(kplan, Rp)
        kw = dict(R=kplan.n_rows, C=kplan.n_cols, V=V, tol=1e-2)
        pk = dict(kw, check=(bg.BF16_ATOL, bg.BF16_RTOL))
        ik = dict(kw, as_class=False)
        time_ms(lambda: bg.class_pred(d, w8, **pk), device)                    # warm
        pred_ms = time_ms(lambda: bg.class_pred(d, w8, **pk), device, reps=5)
        ids_ms = time_ms(lambda: bg.class_pred(d, w8, **ik), device, reps=5)
        pred_plain_ms = time_ms(lambda: bg.class_pred_plain(d, w8, **pk), device)
        chk = check_flag_pair(d, w8, bg.BF16_ATOL, bg.BF16_RTOL)
        time_ms(lambda: bg.check(d, w8, atol=bg.BF16_ATOL, rtol=bg.BF16_RTOL), device)
        check_ms = time_ms(lambda: bg.check(d, w8, atol=bg.BF16_ATOL, rtol=bg.BF16_RTOL),
                           device, reps=5)
        check_plain_ms = time_ms(lambda: bg.check_plain(d, w8, atol=bg.BF16_ATOL,
                                                        rtol=bg.BF16_RTOL), device)
    pred_bound = max((N * 2 + V * Bp + 8 * Rp * Cp * 4) / HBM_BYTES_PER_S,
                     PRED_OPS * N / F32_OPS_PER_S) * 1e3
    ids_bound = max((N * 2 + V * Bp * 4 + 8 * Rp * Cp * 4) / HBM_BYTES_PER_S,
                    PRED_OPS * N / F32_OPS_PER_S) * 1e3
    check_bound = max((N * 2 + 8 * Rp * Cp * 4) / HBM_BYTES_PER_S,
                      CHECK_OPS * N / F32_OPS_PER_S) * 1e3
    detail["class_pred_bf16"] = {"field": [Rp, Cp, Bp], "pair": pred, "ms": pred_ms,
                                 "ids_ms": ids_ms, "plain_ms": pred_plain_ms,
                                 "bound_ms": pred_bound, "ids_bound_ms": ids_bound}
    detail["check_bf16"] = {"pair": chk, "ms": check_ms, "plain_ms": check_plain_ms,
                            "bound_ms": check_bound}
    del d

    tile = st.default_tile(oplan)
    n_inner = st.default_n_inner(oplan, tile)
    K = len(oplan.offsets)
    Vp = -(-V // tile) * tile
    planes = torch.full((K, Vp), np.inf, dtype=bf16, device=device)
    planes[:, :V] = oplan.planes.to(bf16)
    with uncounted():
        dm = st.seeded_padded(V, sgv[0], tile, bf16)
        spare = torch.empty_like(dm)
        for _ in range(STRUCTURED_WAVE_SWEEPS):
            dm, spare = sg.fused_sweep(dm, planes, oplan.offsets, tile=tile, n_inner=n_inner,
                                       out=spare), dm
        sweep_cmp = sweep_pair(dm, planes, oplan.offsets, tile, n_inner)
        run = lambda: sg.fused_sweep(dm, planes, oplan.offsets, tile=tile,   # noqa: E731
                                     n_inner=n_inner, out=spare)
        time_ms(run, device)                                                  # warm
        sweep_ms = time_ms(run, device, reps=10)
        sweep_plain_ms = time_ms(lambda: sg._fused_sweep_plain(dm, planes, oplan.offsets, tile,
                                                               n_inner), device)
    sweep_bound = max((2 * (Vp + 2 * tile) * batch + K * Vp) * 2 / HBM_BYTES_PER_S,
                      n_inner * K * 2 * Vp * batch / F32_OPS_PER_S) * 1e3
    detail["fused_sweep_bf16"] = {"matrix": list(dm.shape), "tile": tile, "n_inner": n_inner,
                                  "pair": sweep_cmp, "ms": sweep_ms, "plain_ms": sweep_plain_ms,
                                  "bound_ms": sweep_bound}
    del dm, spare, planes
    out["kernel_modes"] = {k: {kk: vv for kk, vv in val.items() if kk != "slab"}
                           for k, val in pass_modes.items()}
    out["wall_s"] = time.perf_counter() - t_phase
    entries = {
        "banded_pass": {name: {k: pm[k] for k in ("ms", "bound_ms", "max_abs_err")}
                        | {"probe_launches": pm["launches"], "plain_ms": pm["slab"]["plain_ms"],
                           "plain_shape": pm["slab"]["shape"]}
                        for name, pm in pass_modes.items()},
        "class_pred": {"bf16": {"ms": pred_ms, "ids_ms": ids_ms, "bound_ms": pred_bound,
                                "ids_bound_ms": ids_bound, "plain_ms": pred_plain_ms,
                                "max_abs_err": float(pred["max_abs_err"])}},
        "check": {"bf16": {"ms": check_ms, "bound_ms": check_bound, "plain_ms": check_plain_ms,
                           "max_abs_err": float(chk["abs_err"])}},
        "fused_sweep": {"bf16": {"ms": sweep_ms, "bound_ms": sweep_bound,
                                 "plain_ms": sweep_plain_ms,
                                 "max_abs_err": sweep_cmp["max_abs_err"]}},
    }
    for name, e in entries.items():
        e["launches"] = {k: launches[k] for k in launches if k.startswith(name)}
    log(f"# solve_modes {out['wall_s']:.1f} s")
    return out, dict(detail=detail, entries=entries)


def run(device, mesh_n=MESH_N, batch=BATCH, iters=ITERS, small=(128, 64),
        eik_small=(40, 36, 16), cvp_batch=CVP_BATCH,
        structured_batch=STRUCTURED_BATCH, full_batch=FULL_BATCH,
        irregular_batch=IRREGULAR_BATCH, nav_dist=25.0, max_cycles=3000,
        layers_n=None, scanned_batch=SCANNED_BATCH, gather_n=GATHER_MESH_N) -> list:
    """Phases 2-27 on `device`; returns the kernels line. `layers_n` runs
    server_layers on a terrain of its own size (default: the main path's);
    `gather_n` is the sharded phase's gather-tier terrain."""
    import torch

    kc = kernel_check(device, *small)
    emit(kc)
    eik_detail, eik_check = eik_kernel_check(device, *eik_small)
    emit(eik_detail)
    sweep_detail, sweep_err = sweep_kernel_check(device)
    emit(sweep_detail)
    mp, ctx = main_path(device, mesh_n, batch, iters)
    emit(mp)
    ctx["launches"] = mp["launches"]
    emit(oracle_gate(ctx))
    detail, line = kernels_at_main_shapes(ctx, device)
    emit(detail)
    for key in ("res", "warm_res"):
        ctx.pop(key)
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    bp, bctx = banded_full(device, ctx, iters, full_batch)
    emit(bp)
    emit(banded_full_oracle_gate(ctx, bctx))
    fdetail, fk = kernels_at_full_shapes(ctx, bctx, device)
    emit(fdetail)
    line[1].update(ids_launches=bctx["launches"]["class_pred_ids"],
                   pass_launches_full=bctx["launches"]["banded_pass"],
                   **{k: v for k, v in fk.items() if k != "max_abs_err"})
    line[1]["max_abs_err"] = max(line[1]["max_abs_err"], fk["max_abs_err"])
    emit(banded_walks(device, ctx, bctx))
    del bctx
    grid_kplan = ctx.pop("kplan")      # for the sharded phase
    rp, rctx = replan(device, ctx, iters)
    emit(rp)
    rdetail, rk = kernels_at_replan_shapes(rctx, device)
    emit(rdetail)
    line[0].update(warm_ms=rk["warm_ms"], warm_bound_ms=rk["warm_bound_ms"],
                   warm_launches=rctx["launches"]["banded_pass_dirty"],
                   warm_rows_walked_share=rk["warm_rows_walked_share"])
    line[0]["max_abs_err"] = max(line[0]["max_abs_err"], rk["warm_max_abs_err"],
                                 *(w["max_abs_err"] for w in kc["wide_pass"].values()))
    line.append({"name": "check", "route": "cuda",
                 "source": "mesh_navigation_torch/csrc/check.cu",
                 "replaces": "mesh_navigation_tpu/ops/pallas_banded.py:2310",
                 "launches": rctx["launches"]["check"], **rk["check"],
                 "library_ms": None})
    wp, wctx = replan_window(device, ctx, rctx, iters)
    emit(wp)
    line[0]["replan_window_launches"] = wctx["launches"]["banded_pass"]
    line[-1]["replan_window_launches"] = wctx["launches"]["check"]
    dsrv = rctx["srv"]          # the Dijkstra server, for server_single
    del rctx
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    cp, cctx = cvp(device, ctx, iters, cvp_batch)
    emit(cp)
    emit(cvp_oracle_gate(ctx, cctx))
    cdetail, ck = kernels_at_cvp_shapes(cctx, device)
    emit(cdetail)
    line[0]["cvp_launches"] = cctx["launches"]["banded_pass"]
    line.append({"name": "eik_pass", "route": "cuda",
                 "source": "mesh_navigation_torch/csrc/eik_pass.cu",
                 "replaces": "mesh_navigation_tpu/ops/pallas_eikonal.py:278",
                 "launches": cctx["launches"]["eik_pass"],
                 "launches_per_solve": cctx["launches"]["eik_pass"] / (iters + 1),
                 **ck, "max_abs_err": max(eik_check["max_abs_err"], ck["slab_max_abs_err"]),
                 "plain_ms": eik_check["plain_ms"], "plain_shape": eik_check["check_shape"],
                 "ms_at_plain_shape": eik_check["check_shape_ms"],
                 "library_ms": None,
                 "library_note": "no single PyTorch call computes the unfolding pass"})
    hp, hctx = cvp_hybrid(device, ctx, cctx)
    emit(hp)
    line[0]["cvp_hybrid_launches"] = hctx["launches"]["banded_pass"]
    line[-1]["cvp_hybrid_launches"] = hctx["launches"]["eik_pass"]
    del cctx
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    sp, sctx = structured(device, ctx, iters, structured_batch)
    emit(sp)
    emit(structured_oracle_gate(ctx, sctx))
    sdetail, sk = kernels_at_structured_shapes(sctx, device)
    emit(sdetail)
    line.append({"name": "fused_sweep", "route": "cuda",
                 "source": "mesh_navigation_torch/csrc/fused_sweep.cu",
                 "replaces": "mesh_navigation_tpu/ops/pallas_sweep.py:40",
                 "launches": sctx["launches"]["fused_sweep"],
                 "launches_per_solve": sctx["launches"]["fused_sweep"] / (iters + 1),
                 **sk, "max_abs_err": max(sweep_err, sk["max_abs_err"]),
                 "library_ms": None,
                 "library_note": "no single PyTorch call computes a fused K-offset min-plus sweep"})
    del sctx
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    ip, ictx = irregular(device, mesh_n, iters, irregular_batch)
    emit(ip)
    emit(oracle_gate(ictx, IRREGULAR_ORACLE_LANES, phase="irregular_oracle"))
    ictx.pop("warm_res")
    idetail, ik = kernels_at_irregular_shapes(ictx, device)
    emit(idetail)
    line[0].update(irregular_launches=ictx["launches"]["banded_pass"],
                   irregular_ms=ik["ms"], irregular_bound_ms=ik["bound_ms"],
                   irregular_rows_walked_share=ik["rows_walked_share"],
                   irregular_prescan_ms=ik["prescan_ms"], irregular_walker_ms=ik["walker_ms"],
                   irregular_walker_us_per_walked_row=ik["walker_us_per_walked_row"],
                   irregular_forced_us_per_row=ik["forced_us_per_row"],
                   main_walker_us_per_row_at_irregular_lanes=ik["main_walker_us_per_row"])
    line[0]["max_abs_err"] = max(line[0]["max_abs_err"], ik["max_abs_err"])
    line[1].update(irregular_launches=ictx["launches"]["class_pred"],
                   irregular_ms=ik["pred_ms"], irregular_bound_ms=ik["pred_bound_ms"])
    line[1]["max_abs_err"] = max(line[1]["max_abs_err"], ik["pred_max_abs_err"])
    line[2].update(irregular_launches=ictx["launches"]["walk"], irregular_ms=ik["walk"]["ms"],
                   irregular_plain_ms=ik["walk"]["plain_ms"],
                   irregular_bound_ms=ik["walk"]["bound_ms"],
                   irregular_bound_by=ik["walk"]["bound_by"],
                   irregular_longest_chain_loads=ik["walk"]["longest_chain_loads"],
                   irregular_first_touch_share=ik["walk"]["first_touch_share"],
                   irregular_class9_steps=ik["walk"]["class9_steps"])
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    mo, mctx = solve_modes(device, ctx, grid_kplan, ictx, sp, main_batch=batch)
    emit(mctx["detail"])
    emit(mo)
    for k in line:
        if k["name"] in mctx["entries"]:
            k["solve_modes"] = mctx["entries"][k["name"]]
            k["max_abs_err"] = max(k["max_abs_err"], *(e["max_abs_err"] for n, e in
                                                       k["solve_modes"].items()
                                                       if n != "launches"))
    del mctx
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    shp, shk = sharded(device, ctx, grid_kplan, ictx, gather_n)
    emit(shp)
    line[0]["sharded_launches"] = shk["launches"]["banded_pass"]
    line[0]["max_abs_err"] = max(line[0]["max_abs_err"], shk["max_abs_err"])
    del grid_kplan
    scan = ictx.pop("scan")       # the Delaunay terrain, for scanned_map
    del ictx
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    vp, vctx = server_cvp(device, ctx, iters, cvp_batch)
    emit(vp)
    emit(server_single(device, ctx, vctx, dsrv, nav_dist=nav_dist, max_cycles=max_cycles))
    line[0]["server_launches"] = vctx["launches"]["banded_pass"]
    eik = next(k for k in line if k["name"] == "eik_pass")
    eik["server_launches"] = vctx["launches"]["eik_pass"]
    eik["max_abs_err"] = max(eik["max_abs_err"], vctx["slab_max_abs_err"])
    del vctx, dsrv
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    lp, lctx = server_layers(device, ctx if layers_n is None else layers_terrain(device, layers_n),
                             iters, cvp_batch, nav_dist=nav_dist)
    emit(lp)
    for k in line:
        if k["name"] in ("banded_pass", "eik_pass", "class_pred", "check"):
            k["server_layers_launches"] = lctx["launches"][k["name"]]
    del lctx
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    mp_out, mctx = scanned_map(device, mesh_n, 2, scan, scanned_batch)
    emit(mp_out)
    for k in line:
        if k["name"] in SCANNED_KERNELS:
            k["scanned_map_launches"] = mctx["launches"][k["name"]]
    return line


def main() -> int:
    t_main = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device is available")
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from mesh_navigation_torch.device import probe
        from mesh_navigation_torch.ops import kernels
    except ImportError as e:
        log(f"chip_smoke: the port is not importable here ({e})")
        return 2
    pr = probe()
    smi = nvidia_smi_line()
    if not pr.ready:
        log(f"chip_smoke: the card or toolchain is not ready for the kernels: {pr}")
        return 3
    t0 = time.perf_counter()
    build_log = kernels.build_all()
    build_s = time.perf_counter() - t0
    for name, text in build_log.items():
        log(f"# nvcc {name}:\n{text}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "device", "name": pr.device_name, "capability": list(pr.capability),
          "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0], "nvcc": pr.nvcc, "kernel_build_s": build_s})
    try:
        line = run(torch.device("cuda"))
    except BaseException:
        # a failed phase: its traceback, then leave at once, so that the
        # destructors of a broken CUDA context do not bury it
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
    emit({"phase": "total", "wall_s": time.perf_counter() - t_main})
    emit({"kernels": line})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
