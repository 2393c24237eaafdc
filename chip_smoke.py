#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mesh_navigation_torch) on one NVIDIA card.

Run from the repository root: `python3 chip_smoke.py`. It needs a CUDA
device and `nvcc`; without them it exits non-zero and prints no result.
Phases, each printed as one JSON line on standard output:

1. device: the card, `nvidia-smi`'s name and power limit, kernel build time
   (every csrc/*.cu is compiled by its own nvcc, all at once).
2. kernel_check: on a 128x128 terrain with 64 lanes, the pass kernel against
   its plain PyTorch version (one forced down pass, one up pass; fields
   within atol + rtol*|d|, flags equal) and the class-pred kernel against its
   plain version on the same fields (int8 tables and flags identical).
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
   the bound; then the `{"kernels": [...]}` line.

The line before the last is `nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`; the last is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failed check raises, and the script exits non-zero.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

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


def device_busy(fn, device) -> dict:
    """Run fn() once under torch.profiler; the device's busy time is the
    union of the traced kernels' intervals, its idle share the rest of the
    host's wall time (which the profiler's own host cost lengthens)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sync(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync(device)
        wall_us = (time.perf_counter() - t0) * 1e6
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in kern):
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name: dict[str, float] = {}
    for e in kern:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"traced_wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
            "kernels_traced": len(kern),
            "idle_share": 1.0 - busy / wall_us if kern else None,
            "top_kernels_ms": {k[:60]: v for k, v in top}}


def steepness_setup(mesh_n: int, device, cost_limit: float = 2.0):
    """Terrain -> mesh -> steepness costs -> slot weights -> banded plan."""
    import torch
    from mesh_navigation_torch.mesh import synthetic
    from mesh_navigation_torch.mesh.arrays import build_mesh, host_array
    from mesh_navigation_torch.ops import sweeps

    v, f = synthetic.terrain_mesh(
        mesh_n, mesh_n, spacing=0.5, hills=2.0, roughness=0.01, seed=0
    )
    mesh = build_mesh(v, f, device=device)
    nz = np.clip(host_array(mesh, "vertex_normals")[:, 2], -1.0, 1.0)
    costs_np = np.arccos(nz).astype(np.float32)
    W = sweeps.slot_weights_np(mesh, costs_np, cost_limit=cost_limit, edge_cost_factor=1.0)
    return v, f, mesh, costs_np, torch.from_numpy(costs_np).to(device), W


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
        "same_finite_support": same_support,
        "max_abs_err": float(diff.max()),
        "max_rel_err": float(rel.max()),
        "within_tol": same_support and bool((diff <= bound).all()),
        "tol": f"|kernel - plain| <= {atol} + {rtol} * |plain|",
    }


def check_pass_pair(prob, device, atol, rtol) -> dict:
    """Forced down pass then up pass, kernel vs plain, from prob.d0."""
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
        if not (cmp["within_tol"] and cmp["flags_equal"]):
            raise AssertionError(f"pass kernel disagrees with its plain version: {name} {cmp}")
    del d_k, d_p
    return out


def check_pred_pair(plan, d_pad, atol, rtol) -> dict:
    """Class-pred kernel vs plain on one field: identical tables and flags."""
    import torch
    from mesh_navigation_torch.ops import banded_gpu as bg

    w8 = bg._w8_planes(plan, d_pad.shape[0])
    kw = dict(R=plan.n_rows, C=plan.n_cols, V=plan.num_vertices,
              tol=max(atol, 3.0 * rtol), atol=atol, rtol=rtol)
    cls_k, viol_k = bg.class_pred(d_pad, w8, **kw)
    cls_p, viol_p = bg.class_pred_plain(d_pad, w8, **kw)
    res = {
        "tables_identical": bool(torch.equal(cls_k, cls_p)),
        "n_mismatch": int((cls_k != cls_p).sum()),
        "max_abs_err": int((cls_k.int() - cls_p.int()).abs().max()),
        "flags_equal": bool(viol_k.any()) == bool(viol_p.any()),
        "violation": bool(viol_p.any()),
    }
    if not (res["tables_identical"] and res["flags_equal"]):
        raise AssertionError(f"pred kernel disagrees with its plain version: {res}")
    return res


def kernel_check(device, mesh_n: int = 128, batch: int = 64) -> dict:
    """Phase 2: both kernels against their plain versions at a small size."""
    import torch
    from mesh_navigation_torch.ops import banded_gpu as bg

    _, _, mesh, _, _, W = steepness_setup(mesh_n, device)
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
    return {"phase": "kernel_check", "mesh": f"{mesh_n}x{mesh_n}", "lanes": batch,
            "pass": passes, "pred_after_one_round": pred_partial,
            "pred_converged": pred_conv, "rounds": full.rounds}


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
    launches = dict(kernels.LAUNCHES)
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


def oracle_gate(ctx, n_lanes: int = 2) -> dict:
    """Phase 4: path-cost parity against the native heap Dijkstra
    (bench.py:169-204), gated at 1%."""
    import torch
    from mesh_navigation_torch.mesh import query
    from mesh_navigation_torch.native import NativeMesh
    from mesh_navigation_torch.planners.dijkstra import potential_lanes

    planner, kplan, mesh = ctx["planner"], ctx["kplan"], ctx["mesh"]
    s, g, _ = ctx["warm"]
    dev = planner.device
    sv = query.nearest_vertex_batch(mesh, planner.grid, torch.from_numpy(s[:n_lanes]).to(dev))[0].cpu().numpy()
    gv = query.nearest_vertex_batch(mesh, planner.grid, torch.from_numpy(g[:n_lanes]).to(dev))[0].cpu().numpy()
    res = ctx["warm_res"]
    pot = potential_lanes(kplan, res.d_pad, res.lane_map, list(range(n_lanes)))
    costs_np = ctx["costs_np"]
    nm = NativeMesh(ctx["v"], ctx["f"])
    try:
        edges = nm.tables()["edges"]
        v = ctx["v"]
        dist = np.linalg.norm(v[edges[:, 1]] - v[edges[:, 0]], axis=1).astype(np.float32)
        c1, c2 = costs_np[edges[:, 0]], costs_np[edges[:, 1]]
        ew = np.where(np.isfinite(c1) & np.isfinite(c2),
                      dist + dist * (c1 + c2) * 0.5, np.inf).astype(np.float32)
        errs = []
        for b in range(n_lanes):
            od, _ = nm.dijkstra(ew, costs_np, int(gv[b]), 2.0)
            ref, got = od[sv[b]], pot[b, sv[b]]
            if np.isfinite(ref) and ref > 0:
                errs.append(abs(got - ref) / ref)
            fin = np.isfinite(od)
            rel = np.abs(pot[b][fin] - od[fin]) / np.maximum(od[fin], 1e-3)
            errs.append(float(np.percentile(rel, 99.9)))
    finally:
        nm.close()
    err = float(np.max(errs))
    if not err < 0.01:
        raise AssertionError(f"oracle parity {err:.3e} exceeds the 1% budget")
    return {"phase": "oracle", "lanes": n_lanes, "max_rel_err": err, "budget": 0.01}


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
              tol=max(ATOL, 3.0 * RTOL), atol=ATOL, rtol=RTOL)
    time_ms(lambda: bg.class_pred(d_conv, w8, **kw), device)          # warm
    pred_ms = time_ms(lambda: bg.class_pred(d_conv, w8, **kw), device, reps=5)
    plain_pred_ms = time_ms(lambda: bg.class_pred_plain(d_conv, w8, **kw), device)
    pred_bytes = N * 4 + kplan.num_vertices * Bp + 8 * Rp * Cp * 4
    pred_bound = max(pred_bytes / HBM_BYTES_PER_S, PRED_OPS * N / F32_OPS_PER_S) * 1e3

    detail = {"phase": "kernels_at_main_shapes", "field": [Rp, Cp, Bp],
              "pass": pass_cmp, "pass_launch_ms": times,
              "pass_bound_ms": [b * 1e3 for b in bounds_by_bytes], "pred": pred_cmp}
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
         "library_ms": None},
    ]
    return detail, line


def run(device, mesh_n=MESH_N, batch=BATCH, iters=ITERS, small=(128, 64)) -> list:
    """Phases 2-5 on `device`; returns the kernels line."""
    emit(kernel_check(device, *small))
    mp, ctx = main_path(device, mesh_n, batch, iters)
    emit(mp)
    ctx["launches"] = mp["launches"]
    emit(oracle_gate(ctx))
    detail, line = kernels_at_main_shapes(ctx, device)
    emit(detail)
    return line


def main() -> int:
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
    line = run(torch.device("cuda"))
    emit({"kernels": line})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
