"""Stress the eikonal pass kernel's progress words (csrc/eik_pass.cu): a
block publishes each strip-row it finishes with st.release.gpu after a
fence and a barrier, and thread 0 of the block of the next strip (and of
the strip before, one row on) spins on ld.acquire.gpu until the word says
the row is done.

Launches the shipped kernel many times, then a lagging copy
(scripts/lagging_copy.py) in which, row by row, some blocks sleep ~80 us
before their wait and others before their release (so consumers both
outrun and trail their producers), with the wait's assertion cut to ~2 s
of the SM's cycles, and holds the first, the last and every `--every`-th
result (field, dirty table, flag) against the plain version, bit for bit.
Inputs: each of the four orderings, forced and then driven by the forced
pass's dirty table, on a 64 x 200 terrain with 128 lanes at strip width 4
(more strip-rows than resident blocks) and on a 40 x 36 terrain with 16
lanes at the default width.

Run from the tree's root on a machine with the card:

    python3 scripts/eik_pass_stress.py [--launches N] [--copy-launches M] [--every K]

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
from mesh_navigation_torch.ops import eikonal_gpu as eg  # noqa: E402
from mesh_navigation_torch.ops import sweeps  # noqa: E402

ATOL, RTOL = 1e-4, 2e-3
# (nx, ny, lanes, strip width or None for the default)
SHAPES = ((64, 200, 128, 4), (40, 36, 16, None))
PATCHES = [
    ("      if (tid == 0) {\n        words[0] = s > 0 ? wait_rows(",
     "      " + lc.lag("tid == 0 && ((blockIdx.x * 5 + blockIdx.y * 3 + it) % 7) == 0")),
    ("        st_release(prog + s,",
     "        " + lc.lag("((blockIdx.x * 3 + blockIdx.y + it) % 5) == 0")),
]
REPLACE = [("#define WAIT_LIMIT_CYCLES 40000000000LL", "#define WAIT_LIMIT_CYCLES 4000000000LL")]


def field(nx, ny, B, device):
    """The eikonal plan of a small terrain with steepness side lengths and a
    seeded field raised by a loose upper bound in 30% of its unseeded
    elements, so that a forced pass has work in every row."""
    v, f = synthetic.terrain_mesh(nx, ny, spacing=0.5, hills=2.0, roughness=0.01, seed=1)
    mesh = build_mesh(v, f, device=device)
    nz = torch.clamp(mesh.vertex_normals[:, 2], -1.0, 1.0)
    ew = sweeps.compute_edge_weights(mesh, torch.arccos(nz), 1.0)
    plan = eg.build_eikonal_kernel_plan(mesh, ew.cpu().numpy())
    rng = np.random.default_rng(nx * ny)
    seed_v = torch.from_numpy(host_array(mesh, "faces")[rng.integers(0, mesh.num_faces, B)])
    seed_d = torch.from_numpy(rng.uniform(0.05, 0.4, tuple(seed_v.shape)).astype(np.float32))
    d = eg.seeded_field(plan, seed_v, seed_d)
    gen = torch.Generator().manual_seed(B)
    far = (torch.rand(d.shape, generator=gen) * 50 + 100).to(device)
    some = (torch.rand(d.shape, generator=gen) < 0.3).to(device)
    return plan, torch.where(torch.isinf(d) & some, far, d)


def cases(device):
    for nx, ny, B, width in SHAPES:
        plan, d = field(nx, ny, B, device)
        cls = eg.class_sources(plan)
        dirty0 = torch.zeros((d.shape[2] // eg.EIK_LANES, d.shape[0]), dtype=torch.int32,
                             device=device)
        extra = {} if width is None else {"strip_width": width}
        for rev, cdir in (*eg._PAIR_A, *eg._PAIR_B):
            d_in, dirty_in = d, dirty0
            for force in (True, False):
                kw = dict(reverse=rev, chunk_dir=cdir, atol=ATOL, rtol=RTOL, force=force, **extra)
                want = eg._eik_pass_plain(d_in, plan.abc, cls, dirty_in, **kw)

                def launch(d_in=d_in, dirty_in=dirty_in, kw=kw, abc=plan.abc, cls=cls):
                    return eg.eik_pass(d_in, abc, cls, dirty_in, **kw)

                def same(got, want=want):
                    return (torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
                            and int(got[1].item()) == int(want[1].item()))

                name = f"{nx}x{ny}x{B}_w{width or 'default'}_{'up' if rev else 'down'}" \
                       f"{cdir:+d}_{'forced' if force else 'dirty'}"
                yield name, launch, same
                d_in, dirty_in = want[0], want[2]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--launches", type=int, default=300)
    ap.add_argument("--copy-launches", type=int, default=40)
    ap.add_argument("--every", type=int, default=7)
    a = ap.parse_args()

    def run(out):
        all_cases = list(cases(torch.device("cuda")))
        for name, launch, same in all_cases:
            out[name] = {"shipped": lc.run_launches(launch, same, a.launches, a.every)}
        copy = lc.build("eik_pass", PATCHES, REPLACE)
        with lc.swapped("eik_pass", copy):
            for name, launch, same in all_cases:
                out[name]["lagging_copy"] = lc.run_launches(launch, same, a.copy_launches, 1)

    return lc.main("eik_pass", run)


if __name__ == "__main__":
    sys.exit(main())
