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
from mesh_navigation_torch.ops import eikonal_gpu as eg
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
    prob = bg.prepare_padded(plan, torch.zeros(8, dtype=torch.int64, device=cuda))
    Rp, Cp, Bp = prob.d0.shape
    cut = (torch.zeros(Rp, Cp, device=cuda), torch.full((Bp,), torch.inf, device=cuda),
           torch.full((2, Bp), -1, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError, match="dirty"):   # a cut needs the dirty table
        bg.directional_pass(prob.d0, prob.down, prob.a_fwd, prob.a_bwd, reverse=False,
                            atol=ATOL, rtol=RTOL, warm_cut=cut)


def _fields(plan, seeds):
    """A converged field and the same field after one round."""
    conv = bg.banded_solve_padded(plan, seeds, atol=ATOL, rtol=RTOL).d_pad
    one = bg.banded_solve_padded(plan, seeds, atol=ATOL, rtol=RTOL, max_rounds=1).d_pad
    return conv, one


@pytest.mark.parametrize("nx,ny,B", [(20, 40, 16), (33, 96, 24), (64, 64, 8)])
def test_check_kernel_matches_plain(cuda, nx, ny, B):
    _, plan = _plan(nx, ny, cuda)
    rng = np.random.default_rng(nx + 1)
    seeds = torch.from_numpy(rng.integers(0, plan.num_vertices, B)).to(cuda)
    conv, one = _fields(plan, seeds)
    w8 = bg._w8_planes(plan, conv.shape[0])
    fin = torch.nonzero(torch.isfinite(conv[:plan.n_rows, :plan.n_cols]))
    r, c, b = fin[len(fin) // 2].tolist()
    lowered, raised, inf_lane = conv.clone(), conv.clone(), conv.clone()
    lowered[r, c, b] = torch.clamp(lowered[r, c, b] - 1.0, min=0.0) * 0.5
    raised[r, c, b] = raised[r, c, b] * 1.5 + 1.0
    inf_lane[:, :, 1] = torch.inf
    before = kernels.LAUNCHES["check"]
    for name, d, want in (("converged", conv, False), ("one_round", one, None),
                          ("lowered", lowered, True), ("raised", raised, True),
                          ("inf_lane", inf_lane, False)):
        got = bool(bg.check(d, w8, atol=ATOL, rtol=RTOL).item())
        plain = bool(bg.check_plain(d, w8, atol=ATOL, rtol=RTOL))
        assert got == plain, name
        if want is not None:
            assert got == want, name
    assert kernels.LAUNCHES["check"] == before + 5


@pytest.mark.parametrize("nx,ny,B,clear", [(24, 40, 16, False), (48, 96, 24, False),
                                           (24, 40, 16, True)])
def test_warm_pass_kernel_matches_plain(cuda, nx, ny, B, clear):
    mesh, plan = _plan(nx, ny, cuda)
    rng = np.random.default_rng(ny)
    seeds = torch.from_numpy(rng.integers(0, plan.num_vertices, B)).to(cuda)
    # new costs: a raised patch in the middle rows (none for a clear update)
    costs = np.arccos(np.clip(host_array(mesh, "vertex_normals")[:, 2], -1.0, 1.0))
    costs = costs.astype(np.float32)
    new = costs.copy()
    if not clear:
        for r in range(nx // 2 - 1, nx // 2 + 2):
            new[r * ny + np.arange(ny // 3, ny // 3 + 5)] = np.inf
    new[2 * ny + np.arange(3, 7)] = 0.0
    old_t, new_t = torch.from_numpy(costs).to(cuda), torch.from_numpy(new).to(cuda)
    kw = dict(edge_cost_factor=1.0, cost_limit=2.0)
    plan0 = bg.refresh_banded_planes_from_costs(plan, old_t, **kw)
    plan1 = bg.refresh_banded_planes_from_costs(plan, new_t, **kw)
    d_prev = bg.banded_solve_padded(plan0, seeds, atol=ATOL, rtol=RTOL).d_pad
    changed = bg.changed_plane_from_costs(plan, old_t, new_t)
    raised = bg.raised_plane_from_costs(plan, old_t, new_t)
    Rp = d_prev.shape[0]
    d_k, dirty_k, cut = bg._warm_start(plan1, seeds, d_prev, changed, raised,
                                       bg.position_planes(plan, mesh), Rp=Rp, bb=8,
                                       atol=ATOL, rtol=RTOL)
    assert bool(torch.isinf(cut[1]).all()) == clear
    d_p, dirty_p = d_k.clone(), dirty_k.clone()
    prob = bg.prepare_padded(plan1, seeds, seeded=False)
    before = kernels.LAUNCHES["banded_pass_dirty"]
    for rnd in range(2):
        for reverse, cross in ((False, prob.down), (True, prob.up)):
            wc = cut if (rnd == 0 and not reverse) else None
            ck = bg.directional_pass(d_k, cross, prob.a_fwd, prob.a_bwd, reverse=reverse,
                                     atol=ATOL, rtol=RTOL, dirty=dirty_k, warm_cut=wc)
            cp = bg.directional_pass_plain(d_p, cross, prob.a_fwd, prob.a_bwd, reverse=reverse,
                                           bb=8, atol=ATOL, rtol=RTOL, dirty=dirty_p, warm_cut=wc)
            torch.cuda.synchronize()
            assert bool(ck.item()) == bool(cp.item())
            assert torch.equal(dirty_k, dirty_p)
            fin = torch.isfinite(d_p)
            assert torch.equal(fin, torch.isfinite(d_k))
            assert not bool(torch.isnan(d_k).any())
            err = (d_k[fin] - d_p[fin]).abs()
            assert bool((err <= ATOL + RTOL * d_p[fin].abs()).all()), float(err.max())
            d_k.copy_(d_p)
    assert kernels.LAUNCHES["banded_pass_dirty"] == before + 4
    # and the warm solve through the kernels converges to the cold field, at
    # twice the tolerance as in tests/test_torch_replan.py: the warm field is
    # certified only edge by edge
    res = bg.banded_solve_padded(plan1, seeds, atol=ATOL, rtol=RTOL, converge="check",
                                 warm_d=d_prev, warm_changed=changed, warm_raised=raised,
                                 warm_pos=bg.position_planes(plan, mesh))
    cold = bg.banded_solve_padded(plan1, seeds, atol=ATOL, rtol=RTOL).d_pad
    assert res.converged
    fin = torch.isfinite(cold)
    assert torch.equal(fin, torch.isfinite(res.d_pad))
    err = (res.d_pad[fin] - cold[fin]).abs()
    assert bool((err <= 2 * (ATOL + RTOL * cold[fin].abs())).all()), float(err.max())


def _eik_field(nx, ny, B, device):
    """An eikonal plan on a small terrain with steepness side lengths, B
    goal-face seed triples, and their seeded field raised by a loose upper
    bound in 30% of the unseeded elements, so that a forced pass has work in
    every row."""
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
    return plan, seed_v, seed_d, torch.where(torch.isinf(d) & some, far, d)


@pytest.mark.parametrize("nx,ny,B", [(40, 36, 16), (21, 52, 40)])
def test_eik_pass_kernel_matches_plain(cuda, nx, ny, B):
    """Each of the four orderings, forced and then driven by the forced
    pass's dirty table, on the same inputs: fields bit for bit (the kernel
    is built without multiply-add contraction), dirty tables and flags
    equal. Row widths 36 and 52 are not multiples of 32."""
    plan, _, _, d = _eik_field(nx, ny, B, cuda)
    cls = eg.class_sources(plan)
    dirty = torch.zeros((d.shape[2] // eg.EIK_LANES, d.shape[0]), dtype=torch.int32,
                        device=cuda)
    before = kernels.LAUNCHES["eik_pass"]
    n_dirty_rows = []
    for rev, cdir in (*eg._PAIR_A, *eg._PAIR_B):
        for force in (True, False):
            kw = dict(reverse=rev, chunk_dir=cdir, atol=ATOL, rtol=RTOL, force=force)
            out_k, chg_k, dirty_k = eg.eik_pass(d, plan.abc, cls, dirty, **kw)
            out_p, chg_p, dirty_p = eg._eik_pass_plain(d, plan.abc, cls, dirty, **kw)
            torch.cuda.synchronize()
            assert int(chg_k.item()) == int(chg_p.item()), (rev, cdir, force)
            assert torch.equal(dirty_k, dirty_p), (rev, cdir, force)
            fin = torch.isfinite(out_p)
            assert torch.equal(fin, torch.isfinite(out_k))
            assert torch.equal(out_k, out_p), float((out_k[fin] - out_p[fin]).abs().max())
            n_dirty_rows.append(int(dirty_p.sum()))
            d, dirty = out_p, dirty_p
    assert kernels.LAUNCHES["eik_pass"] == before + 8
    assert n_dirty_rows[0] > 0 and min(n_dirty_rows) < d.shape[0] * dirty.shape[0]


def test_eik_solve_through_the_kernel_matches_the_plain_solve(cuda, monkeypatch):
    """The whole solve on the card, once through the kernel and once with
    the plain version in its place: the same rounds and the same field bit
    for bit."""
    plan, seed_v, seed_d, _ = _eik_field(24, 36, 8, cuda)
    kw = dict(atol=1e-5, rtol=1e-5, orderings=2)
    got = eg.eikonal_solve_padded(plan, seed_v, seed_d, **kw)
    monkeypatch.setattr(eg, "eik_pass", eg._eik_pass_plain)
    want = eg.eikonal_solve_padded(plan, seed_v, seed_d, **kw)
    assert got.converged and want.converged and got.rounds == want.rounds
    assert torch.equal(got.d_pad, want.d_pad)


def test_eik_pass_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    plan, _, _, d = _eik_field(12, 20, 8, cuda)
    cls = eg.class_sources(plan)
    dirty = torch.zeros((1, d.shape[0]), dtype=torch.int32, device=cuda)
    kw = dict(reverse=False, atol=ATOL, rtol=RTOL)
    with pytest.raises(ValueError, match="lanes"):
        eg.eik_pass(d[:, :, :16].contiguous(), plan.abc, cls, dirty, chunk_dir=1, **kw)
    with pytest.raises(ValueError, match="chunk_dir"):
        eg.eik_pass(d, plan.abc, cls, dirty, chunk_dir=2, **kw)
    with pytest.raises(ValueError, match="dirty"):
        eg.eik_pass(d, plan.abc, cls, dirty.to(torch.int64), chunk_dir=1, **kw)


def test_cvp_descent_graph_matches_eager(cuda):
    """The descent's CUDA-graph replay walks the same paths as its eager
    steps, on a converged field through the kernel."""
    plan, seed_v, seed_d, _ = _eik_field(24, 36, 8, cuda)
    v, f = synthetic.terrain_mesh(24, 36, spacing=0.5, hills=2.0, roughness=0.01, seed=1)
    mesh = build_mesh(v, f, device=cuda)
    nz = torch.clamp(mesh.vertex_normals[:, 2], -1.0, 1.0)
    ew = sweeps.compute_edge_weights(mesh, torch.arccos(nz), 1.0)
    res = eg.eikonal_solve_padded(plan, seed_v, seed_d, atol=1e-5, rtol=1e-5)
    d_flat = res.d_pad.reshape(-1, res.d_pad.shape[-1])
    starts = torch.from_numpy(np.random.default_rng(5).integers(0, mesh.num_vertices, 8)).to(cuda)
    kw = dict(tol=5e-3, chunk=64)
    p_g, v_g = eg.cvp_descend_paths(plan, mesh, ew, d_flat, starts, seed_v.to(cuda), 200,
                                    graph=True, **kw)
    p_e, v_e = eg.cvp_descend_paths(plan, mesh, ew, d_flat, starts, seed_v.to(cuda), 200,
                                    graph=False, **kw)
    assert torch.equal(p_g, p_e) and torch.equal(v_g, v_e)
    assert int(v_e.sum(dim=1).max()) > 32        # the replays ran
