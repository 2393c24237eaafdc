"""How far the live-replan step's warm field drifts from an exact solve.

Drives MeshNavServer.make_replan_step("obst") (chip_smoke.py's replan
configuration, with a warm window of `--warm-window` rows or none) for the
first `--lanes` seeds of chip_smoke.py's replan draw over a chain of jump /
drift / clear updates (chip_smoke.update_clouds, from the seed of
chip_smoke.py's replan_window phase) and, after each update, compares the
warm field with a cold solve at the replan tolerance and with an exact
solve (atol 1e-7, rtol 1e-8) on that update's planes. Prints one JSON line
per update: the window's record, the largest relative difference of warm
and cold against exact, where the warm one is largest (row, column, lane),
both values there, the previous field's value there, whether the update's
warm cut took it, how many labels the cut took, and, past 0.5%, the native
heap Dijkstra's distance there.

Run from the tree's root:

    python3 scripts/replan_drift_probe.py [--mesh-n 1024] [--lanes 128]
        [--updates 10] [--warm-window 384] [--device cuda]

It imports the package of the working directory, so from the root of
another tree it probes that tree.

On the 1M terrain with 128 lanes, a warm resolve whose first round is not
forced and whose dirty pass writes `simp ? scan : base` (the reference's
rules) sat 1.59% above the exact field after six updates (PERF.md,
section 6).
"""
import argparse
import dataclasses
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.getcwd())
import chip_smoke as c  # noqa: E402
from mesh_navigation_torch.api.server import MeshNavServer  # noqa: E402
from mesh_navigation_torch.ops import banded_gpu as bg  # noqa: E402


def compare(a, b) -> dict:
    fin = torch.isfinite(b)
    rel = torch.where(fin, (a - b).abs() / b.abs().clamp(min=1e-3), 0.0)
    r, col, lane = np.unravel_index(int(torch.argmax(rel)), tuple(b.shape))
    return {"max_rel": float(rel.max()), "at": [int(r), int(col), int(lane)],
            "value": float(a[r, col, lane]), "exact": float(b[r, col, lane]),
            "over_1pct": int((rel > 0.01).sum())}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh-n", type=int, default=c.MESH_N)
    ap.add_argument("--lanes", type=int, default=c.REPLAN_BATCH)
    ap.add_argument("--updates", type=int, default=10)
    ap.add_argument("--warm-window", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    dev = torch.device(a.device)
    if dev.type == "cuda":
        from mesh_navigation_torch.ops import kernels
        kernels.build_all()
        print(c.nvidia_smi_line(), flush=True)
    v, f, mesh, _, _, _ = c.steepness_setup(a.mesh_n, dev)
    srv = MeshNavServer(mesh, c.replan_config(), planner_kind="dijkstra", device=dev)
    draw = np.random.default_rng(c.SEED + 2)
    seeds = np.sort(draw.integers(0, mesh.num_vertices, c.REPLAN_BATCH))[:a.lanes]
    seeds = torch.from_numpy(seeds).to(dev)
    step = srv.make_replan_step("obst", warm_window=a.warm_window)
    C = srv.banded_plan.n_cols
    rng = np.random.default_rng(c.SEED + 25)
    clouds = [("warmup", c.update_clouds(rng, v, a.mesh_n)[0][1])]
    while len(clouds) < a.updates:
        clouds += c.update_clouds(rng, v, a.mesh_n)
    costs = srv.vertex_costs
    d = bg.banded_solve_padded(srv.banded_plan, seeds, atol=c.ATOL, rtol=c.RTOL).d_pad
    pos = bg.position_planes(srv.banded_plan, mesh)
    for k, (name, pts) in enumerate(clouds[:a.updates]):
        prev_costs, prev_d = costs, d
        costs, d, rounds = step(torch.from_numpy(pts).to(dev), costs, d, seeds)
        plan = step.last["plan"]
        exact = bg.banded_solve_padded(plan, seeds, atol=1e-7, rtol=1e-8, max_rounds=500)
        cold = bg.banded_solve_padded(plan, seeds, atol=c.ATOL, rtol=c.RTOL).d_pad
        win = step.last["window"]
        rec = {"update": k, "cloud": name, "rounds": rounds, "exact_converged": exact.converged,
               "window": None if win is None else dataclasses.asdict(win),
               "warm_vs_exact": compare(d, exact.d_pad), "cold_vs_exact": compare(cold, exact.d_pad)}
        w = rec["warm_vs_exact"]
        r, col, lane = w["at"]
        _, _, (lb, th, _) = bg._warm_start(
            plan, seeds, prev_d, bg.changed_plane_from_costs(srv.banded_plan, prev_costs, costs),
            bg.raised_plane_from_costs(srv.banded_plan, prev_costs, costs), pos,
            Rp=d.shape[0], bb=bg.PASS_LANES, atol=c.ATOL, rtol=c.RTOL)
        w["previous"] = float(prev_d[r, col, lane])
        w["cut"] = bool(prev_d[r, col, lane] >= lb[r, col] + th[lane])
        w["cut_labels"] = int(((prev_d >= lb[:, :, None] + th) & torch.isfinite(prev_d)).sum())
        if w["max_rel"] > 0.005:
            r, col, lane = w["at"]
            od, _ = c.native_fields(v, f, costs.cpu().numpy(), [int(seeds[lane])])[0]
            w["native"] = float(od[r * C + col])
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
