"""Launch the banded pass kernel's warm mode many times on a field whose
dirty rows lie three to nine rows apart, so that its blocks jump between
rows again and again while a prefetched row stage is in flight. The first,
the last and every 97th launch are held against the plain pass.

Run from the tree's root on a machine with the card:

    python3 scripts/banded_jump_stress.py [--launches N] [--rows R] [--cols C] [--lanes B]

The default rows of 1,024 columns give the kernel blocks of eight warps
whose rows are staged by TMA (rows of at most 1,024 columns are).

Prints one JSON line: launches, rows walked a launch, ms a launch, and
whether each result held against the plain pass was equal. Exits 1 on a
mismatch; a kernel that deadlocks fails its stage barrier's device
assertion instead.
"""
import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.getcwd())
from mesh_navigation_torch.mesh import synthetic  # noqa: E402
from mesh_navigation_torch.mesh.arrays import build_mesh, host_array  # noqa: E402
from mesh_navigation_torch.ops import banded_gpu as bg  # noqa: E402
from mesh_navigation_torch.ops import kernels, sweeps  # noqa: E402

ATOL, RTOL = 1e-4, 2e-3


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--launches", type=int, default=2000)
    ap.add_argument("--rows", type=int, default=256)
    ap.add_argument("--cols", type=int, default=1024)
    ap.add_argument("--lanes", type=int, default=128)
    ap.add_argument("--seed", type=int, default=3)
    a = ap.parse_args()
    dev = torch.device("cuda")
    kernels.build_all()
    v, f = synthetic.terrain_mesh(a.rows, a.cols, spacing=0.5, hills=2.0, roughness=0.01, seed=0)
    mesh = build_mesh(v, f, device=dev)
    costs = np.arccos(np.clip(host_array(mesh, "vertex_normals")[:, 2], -1.0, 1.0))
    W = sweeps.slot_weights_np(mesh, costs.astype(np.float32), cost_limit=2.0,
                               edge_cost_factor=1.0)
    plan = bg.build_banded_kernel_plan(mesh, W)
    rng = np.random.default_rng(a.seed)
    seeds = torch.from_numpy(rng.integers(0, plan.num_vertices, a.lanes)).to(dev)
    d0 = bg.banded_solve_padded(plan, seeds, atol=ATOL, rtol=RTOL, converge="check").d_pad
    Rp, nb = d0.shape[0], d0.shape[2] // bg.PASS_LANES
    # each block its own dirty rows, 3 to 9 apart: every gap of 3 or more
    # is a jump made while the row after the walked one sits prefetched
    dirty0 = torch.zeros((nb, Rp), dtype=torch.int32)
    for j in range(nb):
        r = int(rng.integers(0, 4))
        while r < Rp:
            dirty0[j, r] = 1
            r += int(rng.integers(3, 10))
    dirty0 = dirty0.to(dev)
    prob = bg.prepare_padded(plan, seeds, seeded=False)
    kw = dict(reverse=False, atol=ATOL, rtol=RTOL)

    d_p, dirty_p = d0.clone(), dirty0.clone()
    bg.directional_pass_plain(d_p, prob.down, prob.a_fwd, prob.a_bwd, bb=8, dirty=dirty_p, **kw)
    ok, walked = True, torch.zeros(1, dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(a.launches):
        d, dirty = d0.clone(), dirty0.clone()
        bg.directional_pass(d, prob.down, prob.a_fwd, prob.a_bwd, dirty=dirty,
                            rows_walked=walked if i == 0 else None, **kw)
        if i == 0 or i == a.launches - 1 or i % 97 == 0:
            ok &= bool(torch.equal(d, d_p)) and bool(torch.equal(dirty, dirty_p))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / a.launches
    print(json.dumps({"launches": a.launches, "rows": Rp, "lane_blocks": nb,
                      "rows_walked_per_launch": int(walked.item()),
                      "ms_per_launch_with_copies": ms, "equal_to_plain": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
