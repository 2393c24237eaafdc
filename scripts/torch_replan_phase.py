"""chip_smoke.py's main path and replan phase alone, on the card, for the tree
in the working directory; with --irregular also its irregular phase. Run from
the tree's root:

    python3 scripts/torch_replan_phase.py NAME [--irregular]

It builds the kernels, runs the main path (for the mesh and snap grid), the
replan phase and the warm passes of kernels_at_replan_shapes, and prints one
JSON line tagged NAME; with --irregular it then runs the irregular phase (the
jittered-Delaunay 1M terrain, 512 lanes) and prints a second line. Two trees
(a `git archive` of each) run in turns in one call compare the replan and
irregular paths on one card.
"""
import argparse
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.getcwd())
import chip_smoke as c  # noqa: E402
from mesh_navigation_torch.ops import kernels  # noqa: E402

ap = argparse.ArgumentParser()
ap.add_argument("name")
ap.add_argument("--irregular", action="store_true")
a = ap.parse_args()
t0 = time.perf_counter()
kernels.build_all()
dev = torch.device("cuda")
mp, ctx = c.main_path(dev, 1024, 1024, 1)
for key in ("res", "warm_res", "kplan"):
    ctx.pop(key, None)
torch.cuda.empty_cache()
rp, rctx = c.replan(dev, ctx, 3)
_, rk = c.kernels_at_replan_shapes(rctx, dev)
print(json.dumps({"tree": a.name, "ms_per_update": rp["ms_per_update"],
                  "per_pattern_ms": {k: v["mean_ms"] for k, v in rp["per_pattern"].items()},
                  "stage_ms_per_update": rp["stage_ms_per_update"],
                  "launches_per_update": rp["launches_per_update"],
                  "warm_ms": rk["warm_ms"], "warm_rows_walked_share": rk["warm_rows_walked_share"],
                  "main_solves_per_s": mp["solves_per_s"], "wall_s": time.perf_counter() - t0}),
      flush=True)
if a.irregular:
    del ctx, rctx
    torch.cuda.empty_cache()
    ip, _ = c.irregular(dev, 1024, 3)
    print(json.dumps({"tree": a.name, "phase": "irregular", "ms_per_iter": ip["ms_per_iter"],
                      "solve_ms_per_iter": ip["stage_ms_per_iter"]["solve"],
                      "solves": ip["solves"], "launches": ip["launches"],
                      "wall_s": time.perf_counter() - t0}), flush=True)
