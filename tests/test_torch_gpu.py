"""The CUDA kernels against their plain PyTorch versions on the card.

Marked `gpu`: each test skips where no CUDA device is present. The kernels
have no CPU mode, so these run only on a machine with the card:
`python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py`
(--noconftest: the suite's conftest imports JAX, which the card's machine
need not have). Shapes are small and irregular on purpose: row widths that
are not a multiple of 32 leave idle threads in the pass kernel's blocks.
"""

import numpy as np
import pytest
import torch

from mesh_navigation_torch.mesh import synthetic
from mesh_navigation_torch.mesh.arrays import build_mesh, host_array
from mesh_navigation_torch.ops import banded_gpu as bg
from mesh_navigation_torch.ops import kernels, sweeps

pytestmark = pytest.mark.gpu
ATOL, RTOL = 1e-4, 2e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _plan(nx, ny, device):
    v, f = synthetic.terrain_mesh(nx, ny, spacing=0.5, hills=2.0, roughness=0.01, seed=0)
    mesh = build_mesh(v, f, device=device)
    nz = np.clip(host_array(mesh, "vertex_normals")[:, 2], -1.0, 1.0)
    costs = np.arccos(nz).astype(np.float32)
    costs[(np.arange(len(costs)) % 97) == 5] = np.inf          # scattered walls
    W = sweeps.slot_weights_np(mesh, costs, cost_limit=2.0, edge_cost_factor=1.0)
    return mesh, bg.build_banded_kernel_plan(mesh, W)


@pytest.mark.parametrize("nx,ny,B", [(20, 40, 16), (33, 96, 24), (64, 64, 8)])
def test_pass_and_pred_kernels_match_plain(cuda, nx, ny, B):
    mesh, plan = _plan(nx, ny, cuda)
    rng = np.random.default_rng(nx)
    seeds = torch.from_numpy(rng.integers(0, mesh.num_vertices, B)).to(cuda)
    prob = bg.prepare_padded(plan, seeds)
    d_k, d_p = prob.d0.clone(), prob.d0.clone()
    before = kernels.LAUNCHES["banded_pass"]
    for rnd in range(3):
        for reverse, cross in ((False, prob.down), (True, prob.up)):
            force = rnd == 0 and not reverse
            ck = bg.directional_pass(d_k, cross, prob.a_fwd, prob.a_bwd,
                                     reverse=reverse, atol=ATOL, rtol=RTOL, force=force)
            cp = bg.directional_pass_plain(d_p, cross, prob.a_fwd, prob.a_bwd, reverse=reverse,
                                           bb=prob.bb, atol=ATOL, rtol=RTOL, force=force)
            torch.cuda.synchronize()
            assert bool(ck.item()) == bool(cp.item())
            fin = torch.isfinite(d_p)
            assert torch.equal(fin, torch.isfinite(d_k))
            err = (d_k[fin] - d_p[fin]).abs()
            assert bool((err <= ATOL + RTOL * d_p[fin].abs()).all()), float(err.max())
            d_k.copy_(d_p)     # next pass from the same field on both sides
    assert kernels.LAUNCHES["banded_pass"] == before + 6
    w8 = bg._w8_planes(plan, d_p.shape[0])
    kw = dict(R=plan.n_rows, C=plan.n_cols, V=plan.num_vertices,
              tol=max(ATOL, 3 * RTOL), atol=ATOL, rtol=RTOL)
    cls_k, viol_k = bg.class_pred(d_p, w8, **kw)
    cls_p, viol_p = bg.class_pred_plain(d_p, w8, **kw)
    assert torch.equal(cls_k, cls_p)
    assert bool(viol_k.any()) == bool(viol_p.any())


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    _, plan = _plan(8, 16, cuda)
    prob = bg.prepare_padded(plan, torch.zeros(4, dtype=torch.int64, device=cuda), bb=4)
    with pytest.raises(ValueError):
        bg.directional_pass(prob.d0, prob.down, prob.a_fwd, prob.a_bwd, reverse=False,
                            bb=4, atol=ATOL, rtol=RTOL)
