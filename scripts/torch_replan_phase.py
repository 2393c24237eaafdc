"""chip_smoke.py's main path and replan phase alone, on the card, for the tree
in the working directory. Run from the tree's root:

    python3 scripts/torch_replan_phase.py NAME

It builds the kernels, runs the main path (for the mesh and snap grid), the
replan phase and the warm passes of kernels_at_replan_shapes, and prints one
JSON line tagged NAME. Two trees (a `git archive` of each) run in turns in
one call compare the replan path on one card.
"""
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.getcwd())
import chip_smoke as c  # noqa: E402
from mesh_navigation_torch.ops import kernels  # noqa: E402

t0 = time.perf_counter()
kernels.build_all()
dev = torch.device("cuda")
mp, ctx = c.main_path(dev, 1024, 1024, 1)
for key in ("res", "warm_res", "kplan"):
    ctx.pop(key, None)
torch.cuda.empty_cache()
rp, rctx = c.replan(dev, ctx, 3)
_, rk = c.kernels_at_replan_shapes(rctx, dev)
print(json.dumps({"tree": sys.argv[1], "ms_per_update": rp["ms_per_update"],
                  "per_pattern_ms": {k: v["mean_ms"] for k, v in rp["per_pattern"].items()},
                  "stage_ms_per_update": rp["stage_ms_per_update"],
                  "warm_ms": rk["warm_ms"], "warm_rows_walked_share": rk["warm_rows_walked_share"],
                  "main_solves_per_s": mp["solves_per_s"], "wall_s": time.perf_counter() - t0}),
      flush=True)
