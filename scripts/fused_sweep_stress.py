"""Stress the fused sweep kernel's shared-memory ring (csrc/fused_sweep.cu):
while a block relaxes tile i, the rows (and, with two plane buffers, the
planes) of tile i + 1 are copied by cp.async into the ring slots tile i - 1
used; each tile waits for its copies (`__pipeline_wait_prior`) and the
block's barrier, and a barrier at the tile's end frees its slots.

Launches the shipped kernel many times, then a lagging copy
(scripts/lagging_copy.py) in which, tile by tile in turn, warps sleep ~80
us before the next tile's copies, before the wait, before the barrier
between relaxations and before the slot-free barrier, and holds the
first, the last and every `--every`-th result against the plain version,
bit for bit. The shapes take each streaming layout: the structured path's
own (tile 1,280, 128 lanes, the 1M terrain's offsets), 24 lanes on the
same offsets, one plane buffer (tile 4,096) and no spare ring rows (tile
5,632); and the bfloat16 instantiation's: the structured path's shape and
24 lanes (lane groups of 16 bf16, 32-byte rows) and 3 lanes (2-byte
copies, which are plain stores).

Run from the tree's root on a machine with the card:

    python3 scripts/fused_sweep_stress.py [--launches N] [--copy-launches M] [--every K]

Prints one JSON line; exits 1 on a mismatch or a failed launch.
"""
import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import lagging_copy as lc  # noqa: E402
from mesh_navigation_torch.ops import structured as st  # noqa: E402
from mesh_navigation_torch.ops import sweep_gpu as sg  # noqa: E402

GRID_1M = (1, -1, 1024, -1024, 1025, -1025)
# (tile, V, lanes, n_inner, offsets, dtype)
SHAPES = (
    (1280, 200_000, 128, 2, GRID_1M, torch.float32),
    (1280, 400_000, 24, 2, GRID_1M, torch.float32),
    (4096, 40_960, 2, 2, (1, -1, 4095, -4095, 4096, -4096), torch.float32),
    (5632, 56_320, 1, 2, (1, -1, 5631, -5631, 5632, -5632), torch.float32),
    (1280, 200_000, 128, 2, GRID_1M, torch.bfloat16),
    (1280, 400_000, 24, 2, GRID_1M, torch.bfloat16),
    (4096, 40_960, 3, 2, (1, -1, 4095, -4095, 4096, -4096), torch.bfloat16),
)
WARP_TILE = "(((threadIdx.x >> 5) + (int)t) & 15) == "
PATCHES = [
    ("    if (nxt && s.pr) copy_rows(", "    " + lc.lag(WARP_TILE + "3")),
    ("    __pipeline_wait_prior(1);   // this tile's rows and planes",
     "    " + lc.lag(WARP_TILE + "5")),
    ("      if (!last) __syncthreads();",
     "      " + lc.lag("(((threadIdx.x >> 5) + j + (int)t) & 15) == 9")),
    ("    __syncthreads();   // this tile's ring slots and planes are free",
     "    " + lc.lag(WARP_TILE + "7")),
]


def inputs(tile, V, B, offsets, device, seed):
    """A [T + Vp + T, B] matrix, 30% of it +inf, and [K, Vp] planes with
    20% +inf entries."""
    rng = np.random.default_rng(seed)
    Vp = -(-V // tile) * tile
    d = st.seeded_padded(V, torch.from_numpy(rng.integers(0, V, B)), tile).numpy()
    body = rng.uniform(0, 10, (V, B)).astype(np.float32)
    body[rng.uniform(size=body.shape) < 0.3] = np.inf
    d[tile:tile + V] = np.minimum(d[tile:tile + V], body)
    planes = np.full((len(offsets), Vp), np.inf, np.float32)
    planes[:, :V] = rng.uniform(0, 1, (len(offsets), V))
    planes[:, :V][rng.uniform(size=(len(offsets), V)) < 0.2] = np.inf
    return torch.from_numpy(d).to(device), torch.from_numpy(planes).to(device)


def cases(device):
    for tile, V, B, n_inner, offsets, dtype in SHAPES:
        d, planes = inputs(tile, V, B, offsets, device, seed=V + B)
        d, planes = d.to(dtype), planes.to(dtype)
        want = sg._fused_sweep_plain(d, planes, offsets, tile, n_inner)
        out = torch.empty_like(d)

        def launch(d=d, planes=planes, offsets=offsets, tile=tile, n_inner=n_inner, out=out):
            return sg.fused_sweep(d, planes, offsets, tile=tile, n_inner=n_inner, out=out)

        name = f"tile{tile}_V{V}_B{B}" + ("_bf16" if dtype == torch.bfloat16 else "")
        yield name, launch, (lambda got, want=want: torch.equal(got, want))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--launches", type=int, default=1000)
    ap.add_argument("--copy-launches", type=int, default=200)
    ap.add_argument("--every", type=int, default=7)
    a = ap.parse_args()

    def run(out):
        all_cases = list(cases(torch.device("cuda")))
        for name, launch, same in all_cases:
            out[name] = {"shipped": lc.run_launches(launch, same, a.launches, a.every)}
        copy = lc.build("fused_sweep", PATCHES)
        with lc.swapped("fused_sweep", copy):
            for name, launch, same in all_cases:
                out[name]["lagging_copy"] = lc.run_launches(launch, same, a.copy_launches, 1)

    return lc.main("fused_sweep", run)


if __name__ == "__main__":
    sys.exit(main())
