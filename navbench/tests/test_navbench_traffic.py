"""The traffic repeats for a seed and differs across seeds."""

import numpy as np
import pytest

from conftest import ROOT  # noqa: F401  (puts the checkout on the path)
from navbench import spec
from mesh_navigation_torch.mesh import synthetic

BIG = 2**31 + 977   # the driver's seeds pass 32 signed bits
MIXES = sorted({w["traffic"] for w in spec.benchmark()["workloads"]})


@pytest.fixture(scope="module")
def grid():
    return synthetic.terrain_mesh(24, 24, spacing=0.5, hills=2.0, roughness=0.01, seed=0)


def draws(mix, grid, seed, n=3):
    v, f = grid
    gen = spec.kind(mix).Traffic(mix, v, f, seed)
    return [gen.draw() for _ in range(n)]


def flat(items):
    return [np.asarray(it[k]) for it in items for k in sorted(it)]


@pytest.mark.parametrize("mix_name", MIXES)
def test_same_seed_same_draws_other_seed_other_draws(mix_name, grid):
    mix = dict(spec.traffic(mix_name), lanes=16)
    a, b, c = (flat(draws(mix, grid, s)) for s in (BIG, BIG, BIG + 1))
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not all(np.array_equal(x, y) for x, y in zip(a, c))


def test_fleet_poses_lie_inside_their_faces(grid):
    v, f = grid
    mix = dict(spec.traffic("fleet4096"), lanes=64)
    d = spec.kind(mix).Traffic(mix, v, f, BIG).draw()
    assert d["starts"].shape == d["goals"].shape == (64, 3)
    assert (d["start_bary"] >= mix["bary_margin"] - 1e-12).all()
    np.testing.assert_allclose(d["start_bary"].sum(axis=1), 1.0, rtol=1e-12)
    want = np.einsum("nk,nkc->nc", d["start_bary"], v[f[d["start_face"]]].astype(np.float64))
    np.testing.assert_allclose(d["starts"], want, rtol=1e-6, atol=1e-6)
