"""Stress the class-pred kernel's ring of row slots (csrc/class_pred.cu):
each step issues the cp.async copies of two rows ahead into the slots of
two steps ago, waits for its own copies (cp.async.wait_group) and meets the
block's barrier before it reads.

Launches the shipped kernel many times, then a lagging copy
(scripts/lagging_copy.py) in which, step by step in turn, one warp sleeps
~80 us before its refill and another before its wait, and holds the first,
the last and every `--every`-th table and flag against the plain version,
bit for bit, in both modes (int8 classes with the certificate, int32 ids).
Fields: 256 x 1,024 x 128 (lane groups of 8 threads) and 130 x 300 x 32
(groups of 4, a ragged last run).

Run from the tree's root on a machine with the card:

    python3 scripts/class_pred_stress.py [--launches N] [--copy-launches M] [--every K]

Prints one JSON line; exits 1 on a mismatch or a failed launch.
"""
import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import lagging_copy as lc  # noqa: E402
from mesh_navigation_torch.ops import banded_gpu as bg  # noqa: E402

ATOL, RTOL = 1e-4, 2e-3
SHAPES = ((256, 1024, 128), (130, 300, 32))
# in the step loop (two rows a step, warps 0-3 of 128 threads): one warp
# lags before the two refills, another before the wait and the barrier
PATCHES = [
    ("    issue();\n    issue();\n    cp_async_wait_depth();",
     "    " + lc.lag("(((threadIdx.x >> 5) + (r >> 1)) & 3) == 3")),
    ("    cp_async_wait_depth();                     // position 2t + 3 has landed",
     "    " + lc.lag("(((threadIdx.x >> 5) + (r >> 1)) & 3) == 1")),
]


def field(Rp, Cp, Bp, device, seed):
    """A field with +inf (20%) and zero (5%) elements, weights with +inf
    (10%) entries."""
    gen = torch.Generator().manual_seed(seed)
    d = torch.rand((Rp, Cp, Bp), generator=gen) * 100
    u = torch.rand(d.shape, generator=gen)
    d[u < 0.2] = torch.inf
    d[u > 0.95] = 0.0
    w8 = torch.rand((Rp, 8, Cp), generator=gen) * 3
    w8[torch.rand(w8.shape, generator=gen) < 0.1] = torch.inf
    return d.to(device), w8.to(device)


def cases(device):
    for Rp, Cp, Bp in SHAPES:
        d, w8 = field(Rp, Cp, Bp, device, seed=Rp + Cp + Bp)
        kw = dict(R=Rp - 1, C=Cp - 1, V=(Rp - 1) * (Cp - 1) - 1, tol=6e-3)
        for as_class, check in ((True, (ATOL, RTOL)), (False, None)):
            t_p, f_p = bg.class_pred_plain(d, w8, **kw, check=check, as_class=as_class)
            name = f"{Rp}x{Cp}x{Bp}_{'class_checked' if as_class else 'ids'}"

            def launch(d=d, w8=w8, kw=kw, as_class=as_class, check=check):
                return bg.class_pred(d, w8, **kw, check=check, as_class=as_class)

            def same(out, t_p=t_p, f_p=f_p):
                t, f = out
                return torch.equal(t, t_p) and (f is None) == (f_p is None) and (
                    f is None or bool(f.any()) == bool(f_p))

            yield name, launch, same


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
        copy = lc.build("class_pred", PATCHES)
        with lc.swapped("class_pred", copy):
            for name, launch, same in all_cases:
                out[name]["lagging_copy"] = lc.run_launches(launch, same, a.copy_launches, 1)

    return lc.main("class_pred", run)


if __name__ == "__main__":
    sys.exit(main())
