"""The CUDA kernels against their plain PyTorch versions on the card.

Marked `gpu`: each test skips where no CUDA device is present. The kernels
have no CPU mode, so these run only on a machine with the card:
`python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py`
(--noconftest: the suite's conftest imports JAX, which the card's machine
need not have). Shapes are small and irregular on purpose: row widths that
are not a multiple of 32 leave idle threads in the pass kernel's blocks.
"""

import dataclasses

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
            assert torch.equal(d_k, d_p)   # the plain pass sums in the kernel's order
    assert kernels.LAUNCHES["banded_pass"] == before + 6
    w8 = bg._w8_planes(plan, d_p.shape[0])
    kw = dict(R=plan.n_rows, C=plan.n_cols, V=plan.num_vertices, tol=max(ATOL, 3 * RTOL))
    _pred_pair(d_p, w8, kw)


def _pred_pair(d, w8, kw) -> bool:
    """The class-pred kernel against its plain version on one field, in both
    modes, with and without the flag: tables identical, flags equal, and each
    mode counted under its own name. Returns the flag."""
    flags = set()
    for as_class, name in ((True, "class_pred"), (False, "class_pred_ids")):
        for check in (None, (ATOL, RTOL)):
            before = dict(kernels.LAUNCHES)
            tk, fk = bg.class_pred(d, w8, **kw, check=check, as_class=as_class)
            tp, fp = bg.class_pred_plain(d, w8, **kw, check=check, as_class=as_class)
            torch.cuda.synchronize()
            assert tk.dtype == (torch.int8 if as_class else torch.int32)
            assert torch.equal(tk, tp), (as_class, check, int((tk != tp).sum()))
            assert kernels.LAUNCHES[name] == before[name] + 1
            bf16 = d.dtype == torch.bfloat16        # counted under class_pred_bf16 too
            assert sum(kernels.LAUNCHES.values()) == sum(before.values()) + 1 + bf16
            if check is None:
                assert fk is None and fp is None
            else:
                assert bool(fk.any()) == bool(fp)
                flags.add(bool(fp))
    assert len(flags) == 1
    return flags.pop()


def _random_field(Rp, Cp, Bp, device, seed=0):
    """A field with +inf (20%) and zero (5%) elements and weight planes with
    +inf (10%) entries."""
    gen = torch.Generator().manual_seed(seed)
    d = torch.rand((Rp, Cp, Bp), generator=gen) * 100
    u = torch.rand(d.shape, generator=gen)
    d[u < 0.2] = torch.inf
    d[u > 0.95] = 0.0
    w8 = torch.rand((Rp, 8, Cp), generator=gen) * 3
    w8[torch.rand(w8.shape, generator=gen) < 0.1] = torch.inf
    return d.to(device), w8.to(device)


@pytest.mark.parametrize("Rp,Cp,Bp", [
    (1, 1, 4), (1, 37, 8), (2, 1, 128), (2, 300, 1024), (45, 1, 8), (45, 37, 4),
    (45, 3000, 8), (70, 33, 128), (33, 300, 1024), (9, 3000, 128), (3, 3000, 1024),
    (65, 17, 32), (129, 40, 36), (130, 70, 1024),
])
def test_class_pred_kernel_matches_plain_on_ragged_tiles(cuda, Rp, Cp, Bp):
    """Rows of 1, 2 and lengths that are not a multiple of the 64-row run
    (an odd last run leaves its last step one row), columns of 1, widths
    that are not a multiple of the strip (16 or 32 columns) and 3,000
    columns, 4 to 1,024 lanes (lane groups of 32 and 64 lanes, ragged at 36
    lanes); the trim drops the last rows and columns and a few vertices."""
    d, w8 = _random_field(Rp, Cp, Bp, cuda, seed=Rp * Cp + Bp)
    R, C = max(Rp - 1, 1), max(Cp - 1, 1)
    kw = dict(R=R, C=C, V=R * C - (1 if R * C > 1 else 0), tol=6e-3)
    _pred_pair(d, w8, kw)


def test_class_pred_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    d, w8 = _random_field(4, 8, 16, cuda)
    kw = dict(R=4, C=8, V=32, tol=6e-3)
    with pytest.raises(ValueError, match="lanes"):
        bg.class_pred(d[..., :6].contiguous(), w8, **kw)
    with pytest.raises(ValueError, match="aligned"):
        bg.class_pred(d.view(-1)[1:1 + 4 * 8 * 12].view(4, 8, 12), w8, **kw)
    with pytest.raises(ValueError, match="w8"):
        bg.class_pred(d, w8[:, :7].contiguous(), **kw)
    with pytest.raises(ValueError, match="exceed"):
        bg.class_pred(d, w8, R=5, C=8, V=40, tol=6e-3)


def test_class_pred_flag_from_one_element_on_a_tile_edge(cuda):
    """A converged field with 128 lanes (lane groups of 32 lanes, strips of
    32 columns, runs of 32 rows) and one raised element on a run's last row,
    on a run's first row, on a strip's first and last column, and on a
    corner: the flag turns on in kernel and plain version alike, and the
    tables stay identical."""
    _, plan = _plan(70, 80, cuda)
    rng = np.random.default_rng(3)
    seeds = torch.from_numpy(rng.integers(0, plan.num_vertices, 128)).to(cuda)
    conv = bg.banded_solve_padded(plan, seeds, atol=ATOL, rtol=RTOL).d_pad
    w8 = bg._w8_planes(plan, conv.shape[0])
    kw = dict(R=plan.n_rows, C=plan.n_cols, V=plan.num_vertices, tol=max(ATOL, 3 * RTOL))
    assert not _pred_pair(conv, w8, kw)
    for r, c, b0 in ((31, 40, 33), (32, 40, 64), (40, 31, 127), (40, 32, 0), (63, 63, 96)):
        ok = torch.nonzero(torch.isfinite(conv[r, c]) & (conv[r, c] > 0)).flatten()
        b = int(ok[torch.argmin((ok - b0).abs())])       # the finite lane nearest b0
        old = conv[r, c, b].clone()
        conv[r, c, b] = old * 1.5 + 1.0
        assert _pred_pair(conv, w8, kw), (r, c, b)
        conv[r, c, b] = old


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
            assert not bool(torch.isnan(d_k).any())
            assert torch.equal(d_k, d_p)
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


def _pass_pair(d_k, d_p, cross, prob, *, reverse, force=False, dirty=None, cut=None,
               xcross=None, xlanes=(), xlist=None, **modes):
    """One pass through the kernel on (d_k, dirty) and through the plain
    version on (d_p, a copy of dirty), with the row and scan `modes`
    (skip, scan_steps, defer): fields, dirty tables, flags and rows walked
    equal. The kernel reads the extended lanes from `xlist` (default: the
    lists of xcross's finite weights), the plain version from xcross.
    Returns (the plain side's dirty table, rows walked)."""
    dirty_p = None if dirty is None else dirty.clone()
    wk = torch.zeros(1, dtype=torch.int32, device=d_k.device)
    wp = torch.zeros(1, dtype=torch.int64, device=d_k.device)
    if xlanes and xlist is None:
        xlist = bg.xlane_list_from_dense(xcross, xlanes)
    kw = dict(reverse=reverse, atol=ATOL, rtol=RTOL, force=force, warm_cut=cut,
              xcross=xcross, xlanes=xlanes, xlist=xlist, **modes)
    ck = bg.directional_pass(d_k, cross, prob.a_fwd, prob.a_bwd, dirty=dirty, rows_walked=wk, **kw)
    cp = bg.directional_pass_plain(d_p, cross, prob.a_fwd, prob.a_bwd, bb=8, dirty=dirty_p,
                                   rows_walked=wp, **kw)
    torch.cuda.synchronize()
    assert bool(ck.item()) == bool(cp.item())
    assert torch.equal(d_k, d_p), float((d_k.float() - d_p.float()).abs().nan_to_num(0.0).max())
    if dirty is not None:
        assert torch.equal(dirty, dirty_p)
    assert int(wk.item()) == int(wp.item())
    return dirty_p, int(wk.item())


@pytest.mark.parametrize("ny", [1000, 1500, 3000, bg.PASS_MAX_COLS])
def test_pass_kernel_on_wide_rows_matches_plain_bit_for_bit(cuda, ny):
    """Rows past the old 1,024-column limit, up to PASS_MAX_COLS (the 1,500
    columns pad to 1,504; 3,000 and more read rows from device memory
    instead of staging them): two rounds of the main mode, then a warm
    resolve's cut pass and dirty pass, kernel against plain bit for bit with
    the same dirty tables, flags and rows walked."""
    nx, B = 8, 16
    mesh, plan = _plan(nx, ny, cuda)
    assert plan.n_cols_pad == -(-ny // 8) * 8
    rng = np.random.default_rng(ny)
    seeds = torch.from_numpy(rng.integers(0, plan.num_vertices, B)).to(cuda)
    prob = bg.prepare_padded(plan, seeds)
    d_k, d_p = prob.d0.clone(), prob.d0.clone()
    for rnd in range(2):
        for reverse, cross in ((False, prob.down), (True, prob.up)):
            _, walked = _pass_pair(d_k, d_p, cross, prob, reverse=reverse,
                                   force=rnd == 0 and not reverse)
            assert walked == nx * B // 8     # the main mode walks every row
    costs = np.arccos(np.clip(host_array(mesh, "vertex_normals")[:, 2], -1.0, 1.0))
    costs = costs.astype(np.float32)
    new = costs.copy()
    new[(nx // 2) * ny + np.arange(ny // 3, ny // 3 + 40)] = np.inf
    old_t, new_t = torch.from_numpy(costs).to(cuda), torch.from_numpy(new).to(cuda)
    kw = dict(edge_cost_factor=1.0, cost_limit=2.0)
    plan0 = bg.refresh_banded_planes_from_costs(plan, old_t, **kw)
    plan1 = bg.refresh_banded_planes_from_costs(plan, new_t, **kw)
    d_prev = bg.banded_solve_padded(plan0, seeds, atol=ATOL, rtol=RTOL).d_pad
    d_k, dirty, cut = bg._warm_start(
        plan1, seeds, d_prev, bg.changed_plane_from_costs(plan, old_t, new_t),
        bg.raised_plane_from_costs(plan, old_t, new_t), bg.position_planes(plan, mesh),
        Rp=d_prev.shape[0], bb=8, atol=ATOL, rtol=RTOL)
    d_p = d_k.clone()
    prob1 = bg.prepare_padded(plan1, seeds, seeded=False)
    dirty, _ = _pass_pair(d_k, d_p, prob1.down, prob1, reverse=False, dirty=dirty, cut=cut)
    assert not torch.equal(d_k, d_prev)
    _pass_pair(d_k, d_p, prob1.up, prob1, reverse=True, dirty=dirty)


def test_warm_pass_jumps_between_far_apart_dirty_rows(cuda):
    """A converged 128-row field, clean but for three dirty rows far apart
    and one row raised above its fixed point: the kernel's prescan lets its
    blocks jump over the clean rows. Kernel and plain agree bit for bit, and
    the rows walked (needed rows and the row after each) are a small share
    of all rows."""
    nx, ny, B = 128, 40, 16
    _, plan = _plan(nx, ny, cuda)
    rng = np.random.default_rng(3)
    seeds = torch.from_numpy(rng.integers(0, plan.num_vertices, B)).to(cuda)
    d = bg.banded_solve_padded(plan, seeds, atol=ATOL, rtol=RTOL, converge="check").d_pad
    Rp = d.shape[0]
    nb = d.shape[2] // 8
    d[60] = torch.where(torch.isfinite(d[60]), d[60] + 1.0, d[60])
    dirty = torch.zeros((nb, Rp), dtype=torch.int32, device=cuda)
    dirty[:, [5, 90, 121]] = 1
    prob = bg.prepare_padded(plan, seeds, seeded=False)
    d_k, d_p = d.clone(), d.clone()
    dirty, walked = _pass_pair(d_k, d_p, prob.down, prob, reverse=False, dirty=dirty)
    assert not torch.equal(d_k[60], d[60])           # the raised row was repaired
    assert 4 * nb <= walked < Rp * nb // 8
    _, walked_up = _pass_pair(d_k, d_p, prob.up, prob, reverse=True, dirty=dirty)
    assert walked_up < Rp * nb // 8


def test_warm_pass_jumps_in_eight_warp_blocks_launch_after_launch(cuda):
    """Rows of 1,024 columns (eight warps a block, rows staged by TMA) with
    dirty rows 3 to 9 apart: every jump drops a prefetched row stage and
    reloads its slot. Two hundred launches on the same input all equal the
    plain pass, dirty tables included."""
    nx, ny, B = 64, 1024, 16
    _, plan = _plan(nx, ny, cuda)
    rng = np.random.default_rng(11)
    seeds = torch.from_numpy(rng.integers(0, plan.num_vertices, B)).to(cuda)
    d0 = bg.banded_solve_padded(plan, seeds, atol=ATOL, rtol=RTOL, converge="check").d_pad
    Rp, nb = d0.shape[0], d0.shape[2] // 8
    dirty0 = torch.zeros((nb, Rp), dtype=torch.int32)
    for j in range(nb):
        r = int(rng.integers(0, 4))
        while r < Rp:
            dirty0[j, r] = 1
            r += int(rng.integers(3, 10))
    dirty0 = dirty0.to(cuda)
    prob = bg.prepare_padded(plan, seeds, seeded=False)
    kw = dict(reverse=False, atol=ATOL, rtol=RTOL)
    d_p, dirty_p = d0.clone(), dirty0.clone()
    bg.directional_pass_plain(d_p, prob.down, prob.a_fwd, prob.a_bwd, bb=8, dirty=dirty_p, **kw)
    for _ in range(200):
        d, dirty = d0.clone(), dirty0.clone()
        bg.directional_pass(d, prob.down, prob.a_fwd, prob.a_bwd, dirty=dirty, **kw)
        assert torch.equal(d, d_p)
        assert torch.equal(dirty, dirty_p)


def test_pass_wrapper_and_kernel_agree_on_the_column_limit(cuda):
    """PASS_MAX_COLS is the kernel's own limit; a wider row raises."""
    assert kernels.query("banded_pass")() == bg.PASS_MAX_COLS
    Cp = bg.PASS_MAX_COLS + 8
    d = torch.full((2, Cp, 8), torch.inf, device=cuda)
    cross = torch.zeros((2, 3, Cp), device=cuda)
    a = torch.zeros((2, 1, Cp), device=cuda)
    with pytest.raises(ValueError, match="at most"):
        bg.directional_pass(d, cross, a, a, reverse=False, atol=ATOL, rtol=RTOL)


# extended lanes of all three kinds: the second carried row (sel 2), the
# carried row (sel 1) and the row's own values (sel 0), shifts up to 4
XLANES = ((2, 0), (2, -1), (1, 2), (1, -2), (0, -3), (0, 2), (0, 4), (0, -4))


def _xl_problem(Rp, Cp, Bp, xlanes, device, seed=0):
    """Random pass inputs with extended lanes: weights in [0.5, 1.5] (the
    lanes' in [1, 3]) with some +inf, chain weights from random laterals,
    and a field of +inf with a few zero seeds a lane and some loose upper
    bounds. Returns (d, down, up, a_fwd, a_bwd, xdown, xup)."""
    gen = torch.Generator().manual_seed(seed)

    def w(shape, lo, hi, p_inf):
        x = torch.rand(shape, generator=gen) * (hi - lo) + lo
        return torch.where(torch.rand(shape, generator=gen) < p_inf, torch.inf, x)

    lat_f, lat_b = w((Rp, Cp), 0.5, 1.5, 0.05), w((Rp, Cp), 0.5, 1.5, 0.05)
    S = max(1, int(np.ceil(np.log2(max(Cp, 2)))))
    a_fwd, a_bwd = bg._chain_weights(lat_f, lat_b, S)
    d = torch.full((Rp, Cp, Bp), torch.inf)
    for b in range(Bp):
        r = torch.randint(0, Rp, (2,), generator=gen)
        c = torch.randint(0, Cp, (2,), generator=gen)
        d[r, c, b] = 0.0
    far = torch.rand(d.shape, generator=gen) * 50 + 30
    d = torch.where(torch.rand(d.shape, generator=gen) < 0.1, far, d)
    L = len(xlanes)
    out = (d, w((Rp, 3, Cp), 0.5, 1.5, 0.1), w((Rp, 3, Cp), 0.5, 1.5, 0.1), a_fwd, a_bwd,
           w((Rp, L, Cp), 1.0, 3.0, 0.3), w((Rp, L, Cp), 1.0, 3.0, 0.3))
    return tuple(t.contiguous().to(device) for t in out)


class _XLProb:
    def __init__(self, a_fwd, a_bwd):
        self.a_fwd, self.a_bwd = a_fwd, a_bwd


# 16 and 32 columns: one column a thread; 1,000 and 1,024: staged rows with
# two carried rows; 2,048: eight columns a thread, rows from device memory
@pytest.mark.parametrize("Cp", [16, 32, 1000, 1024, 2048])
def test_extended_lane_pass_kernel_matches_plain_bit_for_bit(cuda, Cp):
    """The extended-lane pass against its plain version: a forced down pass
    and an up pass without the dirty table, then with it a forced down
    pass, a dirty-driven up pass and a warm-cut down pass: fields bit for
    bit, dirty tables, flags and rows walked equal. Then the lanes without
    sel 2 (one carried row) on the same field."""
    Rp, Bp = 40, 16
    d, down, up, a_fwd, a_bwd, xdown, xup = _xl_problem(Rp, Cp, Bp, XLANES, cuda, seed=Cp)
    prob = _XLProb(a_fwd, a_bwd)
    d_k, d_p = d.clone(), d.clone()
    for reverse, force, cross, xc in ((False, True, down, xdown), (True, False, up, xup)):
        _, walked = _pass_pair(d_k, d_p, cross, prob, reverse=reverse, force=force,
                               xcross=xc, xlanes=XLANES)
        assert walked == Rp * Bp // 8
    d_k, d_p = d.clone(), d.clone()
    dirty = torch.zeros((Bp // 8, Rp), dtype=torch.int32, device=cuda)
    dirty, _ = _pass_pair(d_k, d_p, down, prob, reverse=False, force=True, dirty=dirty,
                          xcross=xdown, xlanes=XLANES)
    dirty, _ = _pass_pair(d_k, d_p, up, prob, reverse=True, dirty=dirty, xcross=xup,
                          xlanes=XLANES)
    cutlb = torch.zeros((Rp, Cp), device=cuda)
    cutth = torch.full((Bp,), 40.0, device=cuda)
    seedrc = torch.stack([torch.arange(Bp) % Rp, torch.arange(Bp) % Cp]).to(cuda, torch.int32)
    dirty, _ = _pass_pair(d_k, d_p, down, prob, reverse=False, dirty=dirty,
                          cut=(cutlb, cutth, seedrc), xcross=xdown, xlanes=XLANES)
    one_row = tuple(lane for lane in XLANES if lane[0] != 2)
    keep = [i for i, lane in enumerate(XLANES) if lane[0] != 2]
    _pass_pair(d_k, d_p, up, prob, reverse=True, dirty=dirty,
               xcross=xup[:, keep].contiguous(), xlanes=one_row)


def test_extended_lane_walk_goes_on_two_rows_after_a_needed_row(cuda):
    """Labels of 100 everywhere but a 0 at row 10, column 20, and row 10
    dirty. The dirty pass scans row 10, which lowers column 40 to 20; that
    reaches row 12 only through a sel-2 lane at column 40, where the prescan
    saw 100, and row 11 has no in-edges (it stays clean). The walker must
    walk row 12 after the clean row 11: kernel and plain agree bit for bit,
    rows walked included, rows 0-9 are jumped over and row 12 changed."""
    Rp, Cp, Bp = 24, 64, 8
    xl = ((2, 0),)
    d = torch.full((Rp, Cp, Bp), 100.0, device=cuda)
    d[10, 20] = 0.0
    down = torch.ones((Rp, 3, Cp), device=cuda)
    down[11] = torch.inf                    # no cross edges from row 10 into row 11
    ones = torch.ones((Rp, 1, Cp), device=cuda)
    xdown = torch.full((Rp, 1, Cp), torch.inf, device=cuda)
    xdown[12, 0, 40] = 0.25                 # row 10 -> row 12 at column 40 only
    dirty = torch.zeros((1, Rp), dtype=torch.int32, device=cuda)
    dirty[0, 10] = 1
    d_k, d_p = d.clone(), d.clone()
    _, walked = _pass_pair(d_k, d_p, down, _XLProb(ones, ones), reverse=False, dirty=dirty,
                           xcross=xdown, xlanes=xl)
    assert float(d_p[12, 40, 0]) == 20.25
    assert torch.equal(d_p[11], d[11])
    assert walked == Rp - 10


def test_pass_refuses_a_second_carried_row_past_its_column_limit(cuda):
    """PASS_MAX_COLS_X2 is the kernel's own limit for lanes of sel 2: past
    it the wrapper raises; lanes without sel 2 take the width."""
    assert kernels.query("banded_pass", "banded_pass_max_cols_x2")() == bg.PASS_MAX_COLS_X2
    Cp, Bp = bg.PASS_MAX_COLS_X2 + 8, 8
    d, down, up, a_fwd, a_bwd, xdown, _ = _xl_problem(4, Cp, Bp, XLANES, cuda)
    with pytest.raises(ValueError, match="at most"):
        bg.directional_pass(d, down, a_fwd, a_bwd, reverse=False, atol=ATOL, rtol=RTOL,
                            xcross=xdown, xlanes=XLANES)
    keep = [i for i, lane in enumerate(XLANES) if lane[0] != 2]
    one_row = tuple(XLANES[i] for i in keep)
    d_p = d.clone()
    _pass_pair(d, d_p, down, _XLProb(a_fwd, a_bwd), reverse=False, force=True,
               xcross=xdown[:, keep].contiguous(), xlanes=one_row)


def _irregular_plan(nx, ny, device, seed=1):
    """The banded plan of a band-reordered jittered-Delaunay terrain."""
    from mesh_navigation_torch.mesh import reorder

    v, f = synthetic.irregular_terrain_mesh(nx, ny, spacing=0.5, jitter=0.45, hills=1.0,
                                            seed=seed)
    mesh = reorder.build_reordered_mesh(v, f, device=device)
    nz = np.clip(host_array(mesh, "vertex_normals")[:, 2], -1.0, 1.0)
    W = sweeps.slot_weights_np(mesh, np.arccos(nz).astype(np.float32), cost_limit=2.0,
                               edge_cost_factor=1.0)
    return bg.build_banded_kernel_plan(mesh, W)


def _plan_pass_pair(plan, prob, d_k, d_p, name, **kw):
    """_pass_pair on the `name` ("down" / "up") pass of a plan's padded
    problem: the kernel reads the plan's own lists, the plain pass its
    dense planes."""
    return _pass_pair(d_k, d_p, getattr(prob, name), prob, reverse=name == "up",
                      xcross=getattr(prob, f"x{name}"), xlanes=getattr(plan, f"xlanes_{name}"),
                      xlist=getattr(prob, f"xlist_{name}"), **kw)


# 128 x 128: 11 lanes a pass, about 1% of their slots an edge, rows of 128
# columns; 24 x 1,000: 21 lanes, about 4%, rows of 1,008 columns (staged,
# two carried rows) whose fullest rows hold more entries than a stage's
# extended-lane slot takes
@pytest.mark.parametrize("nx,ny", [(128, 128), (24, 1000)])
def test_extended_lane_pass_on_a_real_irregular_plans_lists(cuda, nx, ny):
    """A real irregular plan's own lists through the kernel against the
    plain pass on its dense planes, in f32 and bf16: a forced down pass and
    an up pass without the dirty table, then a forced down pass and a
    dirty-driven up pass with it, then a forced deferring down pass and the
    up pass it leaves rows to; bit for bit, rows walked included."""
    plan = _irregular_plan(nx, ny, cuda)
    assert plan.xlist_down is not None and plan.xlist_up is not None
    assert plan.xlist_down.max_row > 0
    rng = np.random.default_rng(nx)
    seeds = torch.from_numpy(rng.integers(0, plan.num_vertices, 16)).to(cuda)
    for dtype in (torch.float32, torch.bfloat16):
        prob = bg.prepare_padded(plan, seeds, dtype=dtype)
        d_k, d_p = prob.d0.clone(), prob.d0.clone()
        _plan_pass_pair(plan, prob, d_k, d_p, "down", force=True)
        _plan_pass_pair(plan, prob, d_k, d_p, "up")
        for defer in (False, True):
            d_k, d_p = prob.d0.clone(), prob.d0.clone()
            dirty = torch.zeros((2, prob.d0.shape[0]), dtype=torch.int32, device=cuda)
            dirty, _ = _plan_pass_pair(plan, prob, d_k, d_p, "down", force=True, dirty=dirty,
                                       defer=defer)
            _plan_pass_pair(plan, prob, d_k, d_p, "up", dirty=dirty)


@pytest.mark.parametrize("Cp", [1024, 2048])
def test_extended_lane_rows_past_the_staged_cap_match_plain(cuda, Cp):
    """Lanes with an edge at about 1% of their slots, but for two rows
    with one at every slot (8 x Cp entries, more than an extended-lane slot
    takes): at 1,024 columns (staged, two carried rows) the entries past
    the cap come from device memory, at 2,048 every entry does; a forced
    down pass, then dirty-driven up and down passes, bit for bit."""
    Rp, Bp = 40, 16
    d, down, up, a_fwd, a_bwd, xdown, xup = _xl_problem(Rp, Cp, Bp, XLANES, cuda, seed=Cp + 7)
    gen = torch.Generator(device="cpu").manual_seed(Cp)
    full = torch.rand((2, Rp, len(XLANES), Cp), generator=gen).to(cuda) * 2 + 1
    sparse = torch.rand((2, Rp, len(XLANES), Cp), generator=gen).to(cuda) < 0.01
    xs = []
    for i in range(2):
        x = torch.where(sparse[i], full[i], torch.inf)
        x[[5, 30]] = full[i][[5, 30]]
        xs.append(x.contiguous())
    xdown, xup = xs
    assert bg.xlane_list_from_dense(xdown, XLANES).max_row > 1024
    prob = _XLProb(a_fwd, a_bwd)
    d_k, d_p = d.clone(), d.clone()
    dirty = torch.zeros((Bp // 8, Rp), dtype=torch.int32, device=cuda)
    dirty, _ = _pass_pair(d_k, d_p, down, prob, reverse=False, force=True, dirty=dirty,
                          xcross=xdown, xlanes=XLANES)
    dirty, _ = _pass_pair(d_k, d_p, up, prob, reverse=True, dirty=dirty, xcross=xup,
                          xlanes=XLANES)
    _pass_pair(d_k, d_p, down, prob, reverse=False, dirty=dirty, xcross=xdown, xlanes=XLANES)


def test_extended_lane_lists_hold_launch_after_launch(cuda):
    """The lists' handoff (a row's group offsets and first entries copied
    into its stage's extended-lane slot, counted on the stage's barrier,
    read by the row's candidates): 100 launches each of a forced down pass
    and of a dirty-driven up pass over a real irregular plan's lists at
    1,008 columns (staged, two carried rows, its fullest rows past the
    cap) equal the plain version, rows walked included."""
    plan = _irregular_plan(24, 1000, cuda)
    seeds = torch.from_numpy(np.random.default_rng(9).integers(0, plan.num_vertices, 64))
    prob = bg.prepare_padded(plan, seeds.to(cuda))
    Rp = prob.d0.shape[0]
    d1 = prob.d0.clone()
    dirty1 = torch.zeros((8, Rp), dtype=torch.int32, device=cuda)
    bg.directional_pass_plain(d1, prob.down, prob.a_fwd, prob.a_bwd, reverse=False, bb=8,
                              atol=ATOL, rtol=RTOL, force=True, dirty=dirty1,
                              xcross=prob.xdown, xlanes=plan.xlanes_down)
    for name, d0, table, force in (("down", prob.d0, None, True), ("up", d1, dirty1, False)):
        kw = dict(reverse=name == "up", atol=ATOL, rtol=RTOL, force=force,
                  xcross=getattr(prob, f"x{name}"), xlanes=getattr(plan, f"xlanes_{name}"),
                  xlist=getattr(prob, f"xlist_{name}"))
        d_p = d0.clone()
        dirty_p = None if table is None else table.clone()
        wp = torch.zeros(1, dtype=torch.int64, device=cuda)
        chg_p = bg.directional_pass_plain(d_p, getattr(prob, name), prob.a_fwd, prob.a_bwd,
                                          bb=8, dirty=dirty_p, rows_walked=wp, **kw)
        for _ in range(100):
            d_k = d0.clone()
            dirty_k = None if table is None else table.clone()
            wk = torch.zeros(1, dtype=torch.int32, device=cuda)
            chg_k = bg.directional_pass(d_k, getattr(prob, name), prob.a_fwd, prob.a_bwd,
                                        dirty=dirty_k, rows_walked=wk, **kw)
            assert torch.equal(d_k, d_p)
            assert dirty_k is None or torch.equal(dirty_k, dirty_p)
            assert bool(chg_k.item()) == bool(chg_p.item()) and int(wk.item()) == int(wp.item())


def test_pass_refuses_extended_lanes_without_their_lists(cuda):
    """On the card the extended lanes are read from their lists only: a
    pass given the dense planes and no lists raises, and so do lists of
    another row count; a pass given the lists and no dense planes gives
    the plain version's result on the dense planes."""
    d, down, up, a_fwd, a_bwd, xdown, _ = _xl_problem(8, 64, 8, XLANES, cuda)
    kw = dict(reverse=False, atol=ATOL, rtol=RTOL, xcross=xdown, xlanes=XLANES)
    xlist = bg.xlane_list_from_dense(xdown, XLANES)
    with pytest.raises(ValueError, match="lists"):
        bg.directional_pass(d, down, a_fwd, a_bwd, **kw)
    with pytest.raises(ValueError, match="goff"):
        bg.directional_pass(d, down, a_fwd, a_bwd, xlist=xlist.rows(0, 7), **kw)
    d_k, d_p = d.clone(), d.clone()
    bg.directional_pass(d_k, down, a_fwd, a_bwd, xlist=xlist,
                        **dict(kw, xcross=None, force=True))
    bg.directional_pass_plain(d_p, down, a_fwd, a_bwd, bb=8, **dict(kw, force=True))
    assert torch.equal(d_k, d_p)


def _irregular_setup(device, n=32, seed=4):
    from mesh_navigation_torch.mesh import reorder

    v, f = synthetic.irregular_terrain_mesh(n, n, spacing=0.5, hills=1.0, seed=seed)
    mesh = reorder.build_reordered_mesh(v, f, device=device)
    nz = np.clip(host_array(mesh, "vertex_normals")[:, 2], -1.0, 1.0)
    costs = np.arccos(nz).astype(np.float32)
    W = sweeps.slot_weights_np(mesh, costs, cost_limit=2.0, edge_cost_factor=1.0)
    return v, mesh, costs, W


def test_residual_solve_and_classes_on_the_card_match_the_cpu(cuda):
    """An irregular 32 x 32 plan (residual edges, lanes of sel 0 and 2)
    solved on the card (converge "round" and "check") and on the CPU: both
    converged, fields within the stopping tolerance; the residual class
    table and res_choice of the card's field equal the CPU's on the same
    field; the light planner's outcomes equal and its costs within 1e-3."""
    from mesh_navigation_torch.config import PlannerConfig
    from mesh_navigation_torch.planners import DijkstraPlanner

    atol, rtol = 1e-3, 2e-3
    out = {}
    for dev in (cuda, torch.device("cpu")):
        v, mesh, costs, W = _irregular_setup(dev)
        plan = bg.build_banded_kernel_plan(mesh, W, device=dev)
        assert plan.n_residual and bg.pass_needs_two_rows(plan.xlanes_down)
        seeds = torch.from_numpy(np.random.default_rng(1).integers(0, len(v), 24)).to(dev)
        for conv in ("round", "check"):
            res = bg.banded_solve_padded(plan, seeds, atol=atol, rtol=rtol, converge=conv)
            assert res.converged
            out[dev.type, conv] = res.d_pad.cpu()
        if dev.type == "cuda":
            before = kernels.LAUNCHES["class_pred"]
            cls_k, ch_k = bg.predecessors_banded_classes_residual(plan, res.d_pad, tol=6e-3)
            assert kernels.LAUNCHES["class_pred"] == before + 1
            plan_c = bg.build_banded_kernel_plan(mesh, W, device="cpu")
            cls_c, ch_c = bg.predecessors_banded_classes_residual(plan_c, res.d_pad.cpu(),
                                                                   tol=6e-3)
            assert torch.equal(cls_k.cpu(), cls_c) and torch.equal(ch_k.cpu(), ch_c)
            assert int((cls_c == 9).sum()) > 0
        pl = DijkstraPlanner(mesh, PlannerConfig(cost_limit=2.0), max_path_len=256, device=dev)
        ids = np.random.default_rng(2).integers(0, len(v), (2, 16))
        out[dev.type] = pl.plan_batch_banded(plan, torch.from_numpy(v[ids[0]]),
                                             torch.from_numpy(v[ids[1]]), atol=atol, rtol=rtol)
    for conv in ("round", "check"):
        k, c = out["cuda", conv], out["cpu", conv]
        fin = torch.isfinite(c)
        assert torch.equal(fin, torch.isfinite(k))
        assert bool(((k - c).abs()[fin] <= 2 * (atol + rtol * c.abs()[fin])).all())
    k, c = out["cuda"], out["cpu"]
    assert torch.equal(k.outcome.cpu(), c.outcome)
    ok = c.outcome == 0
    torch.testing.assert_close(k.cost.cpu()[ok], c.cost[ok], rtol=1e-3, atol=0.0)


def test_full_banded_plan_on_the_card_matches_the_cpu(cuda):
    """DijkstraPlanner.plan_batch_banded(light=False) on the card against the
    same call on the CPU (the plain versions): outcomes equal, potentials
    within the stopping tolerance, path costs within 1e-4; the id-mode
    kernel launched once and its table equal to the plain version's on the
    card's own field."""
    from mesh_navigation_torch.config import PlannerConfig
    from mesh_navigation_torch.planners import DijkstraPlanner

    v, f = synthetic.terrain_mesh(40, 56, spacing=0.5, hills=2.0, roughness=0.01, seed=0)
    rng = np.random.default_rng(5)
    ids = rng.integers(0, len(v), (2, 24))
    s, g = torch.from_numpy(v[ids[0]]), torch.from_numpy(v[ids[1]])
    out = {}
    for dev in (cuda, torch.device("cpu")):
        mesh = build_mesh(v, f, device=dev)
        nz = np.clip(host_array(mesh, "vertex_normals")[:, 2], -1.0, 1.0)
        W = sweeps.slot_weights_np(mesh, np.arccos(nz).astype(np.float32), cost_limit=2.0,
                                   edge_cost_factor=1.0)
        pl = DijkstraPlanner(mesh, PlannerConfig(cost_limit=2.0), max_path_len=256, device=dev)
        plan = pl.prepare_banded_plan(W)
        before = kernels.LAUNCHES["class_pred_ids"]
        out[dev.type] = pl.plan_batch_banded(plan, s, g, light=False, atol=ATOL, rtol=RTOL)
        torch.cuda.synchronize()
        if dev.type == "cuda":
            assert kernels.LAUNCHES["class_pred_ids"] == before + 1
            goal_v = torch.from_numpy(ids[1]).to(dev)
            d = bg.banded_solve_padded(plan, goal_v, atol=ATOL, rtol=RTOL).d_pad
            w8 = bg._w8_planes(plan, d.shape[0])
            tol = max(ATOL, 1e-6)
            kw = dict(R=plan.n_rows, C=plan.n_cols, V=plan.num_vertices, tol=tol)
            table = bg.predecessors_banded_ids(plan, d, tol=tol)
            assert torch.equal(table, bg.class_pred_plain(d, w8, **kw, as_class=False)[0])
            assert torch.equal(table[:, :24].T, out["cuda"].pred)
    k, c = out["cuda"], out["cpu"]
    assert k.converged and c.converged
    assert torch.equal(k.outcome.cpu(), c.outcome)
    pk, pc = k.potential.cpu(), c.potential
    fin = torch.isfinite(pc)
    assert torch.equal(fin, torch.isfinite(pk))
    assert bool(((pk - pc).abs()[fin] <= ATOL + RTOL * pc.abs()[fin]).all())
    ok = c.outcome == 0
    assert bool(ok.all())
    torch.testing.assert_close(k.cost.cpu()[ok], c.cost[ok], rtol=1e-4, atol=0.0)


def _cpu_plan(plan):
    """A CPU copy of a banded plan."""
    from mesh_navigation_torch import convert

    arrays = {k: None if getattr(plan, k) is None else getattr(plan, k).cpu().numpy()
              for k in bg.PLAN_ARRAYS}
    return convert.plan_from_numpy(arrays, {k: getattr(plan, k) for k in bg.PLAN_META},
                                   device="cpu")


@pytest.mark.parametrize("kind", ["grid", "delaunay"])
def test_full_result_on_the_card_matches_the_cpu(cuda, kind):
    """batched_field_banded_pallas on a 128 x 128 grid plan and a 128 x 128
    band-reordered Delaunay plan (extended lanes, residual edges): the pass
    kernel launched and no class_pred mode, the field bit for bit
    banded_solve_padded's from the same seeds, unpadded, and the
    predecessors bit for bit predecessors_banded's on CPU copies, each
    non-self one explaining its label."""
    import roll_pred_checks as checks

    plan = _plan(128, 128, cuda)[1] if kind == "grid" else _irregular_plan(128, 128, cuda)
    assert bool(plan.n_residual) == (kind == "delaunay")
    seeds = torch.from_numpy(np.random.default_rng(7).integers(0, plan.num_vertices, 24)).to(cuda)
    before = dict(kernels.LAUNCHES)
    res = bg.batched_field_banded_pallas(None, None, plan, seeds, atol=ATOL, rtol=RTOL)
    torch.cuda.synchronize()
    assert res.converged
    assert kernels.LAUNCHES["banded_pass"] > before["banded_pass"]
    for name in ("class_pred", "class_pred_ids", "check"):
        assert kernels.LAUNCHES[name] == before[name], name
    R, C, V, B = plan.n_rows, plan.n_cols, plan.num_vertices, len(seeds)
    d = bg.banded_solve_padded(plan, seeds, atol=ATOL, rtol=RTOL).d_pad
    assert torch.equal(res.dist, d[:R, :C, :B].reshape(R * C, B)[:V].T)
    tol = max(ATOL, 1e-6)
    plan_c = _cpu_plan(plan)
    dist_c = res.dist.T.cpu().contiguous()
    pred_c = bg.predecessors_banded(plan_c, dist_c, tol=tol)
    assert torch.equal(res.pred.cpu(), pred_c.T)
    assert (pred_c != torch.arange(V)[:, None]).float().mean() > 0.9
    assert not checks.unexplained(plan_c, dist_c.numpy(), pred_c.numpy(), tol).any()


def test_server_solves_wide_banded_plans_and_routes_wider_ones_to_the_structured_tier(cuda):
    """Through the server on the card: a 1,600-column terrain keeps its
    banded plan (past the old 1,024-column limit), a terrain wider than
    PASS_MAX_COLS takes the structured tier, and both answer every lane."""
    from mesh_navigation_torch.api.server import MeshNavServer
    from mesh_navigation_torch.config import LayerConfig, MeshMapConfig, NavConfig, PlannerConfig

    cfg = NavConfig(mesh_map=MeshMapConfig(default_layer="steep"),
                    planner=PlannerConfig(cost_limit=2.0),
                    layers=(LayerConfig(name="steep", kind="steepness",
                                        params=(("threshold", 2.0),)),))
    for ny, banded in ((1600, True), (bg.PASS_MAX_COLS + 100, False)):
        v, f = synthetic.terrain_mesh(6, ny, spacing=0.5, hills=2.0, roughness=0.01, seed=0)
        srv = MeshNavServer(build_mesh(v, f, device=cuda), cfg, planner_kind="dijkstra",
                            max_path_len=4 * ny, device=cuda)
        assert (srv.banded_plan is not None) == banded
        assert banded or srv.offset_plan.coverage > 0.5
        rng = np.random.default_rng(ny)
        ext = np.array([2.0, ny * 0.5 - 1.0])
        pts = np.concatenate([rng.uniform(0.5, 1.0, (4, 2)) * ext, np.zeros((4, 1))], 1)
        gls = np.concatenate([rng.uniform(0.5, 1.0, (4, 2)) * ext, np.zeros((4, 1))], 1)
        res = srv.get_path_batch(torch.from_numpy(pts.astype(np.float32)).to(cuda),
                                 torch.from_numpy(gls.astype(np.float32)).to(cuda))
        torch.cuda.synchronize()
        assert (res.potential is None) == banded
        assert bool((res.outcome == 0).all()), res.outcome


def test_class_pred_kernel_past_65535_rows(cuda):
    """A narrow field of 70,000 rows: the grid folds rows into its x
    dimension. Tables and flags identical to the plain version's in both
    modes, and the id table the class table decoded."""
    Rp, Cp, Bp = 70_000, 8, 4
    gen = torch.Generator().manual_seed(7)
    d = torch.rand((Rp, Cp, Bp), generator=gen) * 100
    d[torch.rand(d.shape, generator=gen) < 0.2] = torch.inf
    w8 = torch.rand((Rp, 8, Cp), generator=gen)
    d, w8 = d.to(cuda), w8.to(cuda)
    kw = dict(R=Rp - 3, C=Cp - 2, V=(Rp - 3) * (Cp - 2) - 5, tol=6e-3)
    _pred_pair(d, w8, kw)
    cls_k, _ = bg.class_pred(d, w8, **kw)
    ids_k, _ = bg.class_pred(d, w8, **kw, as_class=False)
    assert int((cls_k[-1000:] != 8).sum()) > 0        # the last rows were computed
    vid = torch.arange(kw["V"], device=cuda)[:, None]
    delta = torch.tensor(bg._class_offsets(kw["C"]) + [0], device=cuda)
    assert torch.equal(ids_k.long(), vid + delta[cls_k.long()])


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


def _eik_kernel_vs_plain(plan, d, orderings, **extra):
    """The kernel and the plain pass on the same inputs, each ordering forced
    and then driven by the forced pass's dirty table, the next one from the
    plain output: fields bit for bit (the kernel is built without
    multiply-add contraction), dirty tables and flags equal. Returns the
    dirty rows of each pass."""
    cls = eg.class_sources(plan)
    dirty = torch.zeros((d.shape[2] // eg.EIK_LANES, d.shape[0]), dtype=torch.int32,
                        device=d.device)
    before = kernels.LAUNCHES["eik_pass"]
    n_dirty_rows = []
    for rev, cdir in orderings:
        for force in (True, False):
            kw = dict(reverse=rev, chunk_dir=cdir, atol=ATOL, rtol=RTOL, force=force, **extra)
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
    assert kernels.LAUNCHES["eik_pass"] == before + 2 * len(orderings)
    return n_dirty_rows


# strip widths: narrow (many strips, a partial last one on the 40- and
# 56-column padded rows at 6), the default, longer than the kernel's
# 16-column tile (written through), and the whole row (the row rule)
@pytest.mark.parametrize("width", [4, 6, None, 24, 4096])
@pytest.mark.parametrize("nx,ny,B", [(40, 36, 16), (21, 52, 40)])
def test_eik_pass_kernel_matches_plain(cuda, nx, ny, B, width):
    """Each of the four orderings, forced and then driven by the forced
    pass's dirty table, at several strip widths. Row widths 36 and 52 are
    not multiples of 32."""
    plan, _, _, d = _eik_field(nx, ny, B, cuda)
    extra = {} if width is None else {"strip_width": width}
    n_dirty_rows = _eik_kernel_vs_plain(plan, d, (*eg._PAIR_A, *eg._PAIR_B), **extra)
    n_blocks = d.shape[2] // eg.EIK_LANES
    assert n_dirty_rows[0] > 0 and min(n_dirty_rows) < d.shape[0] * n_blocks


def test_eik_pass_kernel_with_more_work_than_resident_blocks(cuda):
    """A 64-row, 200-column field with 128 lanes at strip width 4: 12,800
    strip-rows for 200 warps, each waiting on its neighbours'. Kernel and
    plain agree, and two launches on the same input agree bit for bit (a
    race would show as nondeterminism)."""
    plan, _, _, d = _eik_field(64, 200, 128, cuda)
    assert d.shape[0] * eg.eik_pass_grid(d.shape[1], d.shape[2], len(plan.classes), 4)[
        "blocks"] >= 12_800
    _eik_kernel_vs_plain(plan, d, eg._PAIR_A[:1], strip_width=4)
    cls = eg.class_sources(plan)
    dirty = torch.zeros((4, d.shape[0]), dtype=torch.int32, device=cuda)
    kw = dict(reverse=False, chunk_dir=1, atol=ATOL, rtol=RTOL, force=True, strip_width=4)
    a = eg.eik_pass(d, plan.abc, cls, dirty, **kw)
    b = eg.eik_pass(d, plan.abc, cls, dirty, **kw)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_eik_pass_kernel_walks_several_lane_blocks_per_block(cuda):
    """More (strip, lane block) columns than the card holds at once: strip
    width 1 on a 200-column row and one lane block more than fit, so blocks
    walk two lane blocks in turn. Kernel and plain agree."""
    plan, _, _, d = _eik_field(12, 200, 32, cuda)
    K, Cp = len(plan.classes), d.shape[1]
    G = eg.eik_pass_grid(Cp, 32 * 4096, K, 1)["grid"][1]
    plan, _, _, d = _eik_field(12, 200, 32 * (G + 1), cuda)
    grid = eg.eik_pass_grid(Cp, d.shape[2], K, 1)
    assert grid["grid"] == [Cp, G] and grid["lane_blocks"] == G + 1
    _eik_kernel_vs_plain(plan, d, eg._PAIR_A[:1], strip_width=1)


@pytest.mark.parametrize("width", [None, 4])
def test_eik_solve_through_the_kernel_matches_the_plain_solve(cuda, monkeypatch, width):
    """The whole solve on the card, once through the kernel and once with
    the plain version in its place: the same rounds and the same field bit
    for bit, at the default and a narrow strip width."""
    plan, seed_v, seed_d, _ = _eik_field(24, 36, 8, cuda)
    kw = dict(atol=1e-5, rtol=1e-5, orderings=2)
    if width is not None:
        kw["strip_width"] = width
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
    with pytest.raises(ValueError, match="strip_width"):
        eg.eik_pass(d, plan.abc, cls, dirty, chunk_dir=1, strip_width=0, **kw)
    with pytest.raises(ValueError, match="sm_ids"):
        eg.eik_pass(d, plan.abc, cls, dirty, chunk_dir=1, sm_ids=torch.zeros(
            1, dtype=torch.int32, device=cuda), **kw)
    # more strips of width 1 than the card can hold at once: no safe launch
    wide = torch.full((1, 32 * 1024, 32), torch.inf, device=cuda)
    abc = torch.full((1, 3, 32 * 1024), torch.inf, device=cuda)
    one = torch.tensor([[1, 3]], dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="resident"):
        eg.eik_pass(wide, abc, one, torch.zeros((1, 1), dtype=torch.int32, device=cuda),
                    chunk_dir=1, strip_width=1, **kw)


def test_eik_solve_widens_a_strip_whose_strips_cannot_all_be_resident(cuda):
    """A 2,400-column row at strip width 4 has more strips than the card
    holds blocks at once: a single pass at that width raises, and the solve
    widens its strip to resident_strip_width, giving the same field, bit for
    bit, as a solve asked for that width."""
    plan, seed_v, seed_d, d = _eik_field(4, 2400, 32, cuda)
    K, Cp = len(plan.classes), d.shape[1]
    w = eg.resident_strip_width(Cp, d.shape[2], K, 4)
    grid = eg.eik_pass_grid(Cp, d.shape[2], K, Cp)
    assert w > 4 and -(-Cp // w) <= grid["blocks_per_sm"] * grid["sms"]
    with pytest.raises(RuntimeError, match="resident"):
        eg.eik_pass_grid(Cp, d.shape[2], K, 4)
    kw = dict(atol=1e-4, rtol=1e-3, orderings=2, max_rounds=6)
    got = eg.eikonal_solve_padded(plan, seed_v, seed_d, strip_width=4, **kw)
    want = eg.eikonal_solve_padded(plan, seed_v, seed_d, strip_width=w, **kw)
    assert got.rounds == want.rounds and torch.equal(got.d_pad, want.d_pad)
    seeded = eg.seeded_field(plan, seed_v, seed_d)
    assert int(torch.isfinite(got.d_pad).sum()) > int(torch.isfinite(seeded).sum())


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


def _sweep_inputs(tile, V, B, offsets, device, seed=0):
    """A [T + Vp + T, B] matrix with +inf end tiles, 30% of its elements
    +inf and the rest random, and [K, Vp] planes with 20% +inf entries; Vp
    is V rounded up to the tile, the padded rows' planes +inf."""
    from mesh_navigation_torch.ops import structured as st

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


@pytest.mark.parametrize("tile,V,B,n_inner,offsets", [
    (256, 1000, 8, 1, (1, -1, 256, -256)),
    (256, 1500, 24, 2, (1, -1, 40, -40, 41, -41)),
    (256, 2048, 128, 3, (-256, 3, 200, -7)),
    (1280, 5000, 128, 2, (1, -1, 1024, -1024, 1025, -1025)),
    (512, 3000, 5, 12, (1, -512)),
])
def test_fused_sweep_kernel_matches_plain(cuda, tile, V, B, n_inner, offsets):
    from mesh_navigation_torch.ops import sweep_gpu as sg

    d, planes = _sweep_inputs(tile, V, B, offsets, cuda, seed=V + B)
    before = kernels.LAUNCHES["fused_sweep"]
    got = sg.fused_sweep(d, planes, offsets, tile=tile, n_inner=n_inner)
    want = sg._fused_sweep_plain(d, planes, offsets, tile, n_inner)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["fused_sweep"] == before + 1
    assert torch.equal(got, want)
    assert not torch.equal(got, d)
    # into a given buffer, twice in a row between two buffers
    out = torch.empty_like(d)
    again = sg.fused_sweep(got, planes, offsets, tile=tile, n_inner=n_inner, out=out)
    assert again is out
    assert torch.equal(again, sg._fused_sweep_plain(want, planes, offsets, tile, n_inner))


# (tile, V, lanes, n_inner, offsets) chosen so the launcher takes each lane
# group and each layout (csrc/fused_sweep.cu): LG 1, 2, 4 and 8 with both
# the next rows and the next planes streamed; 4 lanes where 8 with two plane
# buffers do not fit (the structured path's 1M shape); one plane buffer
# (4096-row tile, 6 offsets); and no spare ring rows (5632-row tile). Lanes
# 3, 5 and 13 end inside a lane group; the many-tile cases give each block a
# run of several tiles, and 782 tiles of one lane exceed the resident blocks.
@pytest.mark.parametrize("tile,V,B,n_inner,offsets", [
    (256, 200_000, 1, 1, (1, -1, 256, -256)),
    (256, 100_000, 3, 2, (1, -1, 200, -256)),
    (512, 300_000, 5, 3, (1, -512, 7)),
    (256, 50_000, 13, 2, (1, -1, 256, -256)),
    (1280, 400_000, 24, 2, (1, -1, 1024, -1024, 1025, -1025)),
    (4096, 40_960, 2, 2, (1, -1, 4095, -4095, 4096, -4096)),
    (5632, 56_320, 1, 2, (1, -1, 5631, -5631, 5632, -5632)),
    (256, 20_000, 8, 0, (1, -1, 256, -256)),
])
def test_fused_sweep_kernel_walks_runs_of_tiles(cuda, tile, V, B, n_inner, offsets):
    """The persistent sweep on runs of tiles, every lane group and every
    streaming layout: bit for bit the plain version, twice in a row."""
    from mesh_navigation_torch.ops import sweep_gpu as sg

    d, planes = _sweep_inputs(tile, V, B, offsets, cuda, seed=V + B)
    got = sg.fused_sweep(d, planes, offsets, tile=tile, n_inner=n_inner)
    want = sg._fused_sweep_plain(d, planes, offsets, tile, n_inner)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(sg.fused_sweep(d, planes, offsets, tile=tile, n_inner=n_inner), got)


def _rcm_relabel(v, f):
    """(v, f) relabelled in reverse Cuthill-McKee order: no band structure,
    so the offset plan keeps a residual."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    e = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]]).astype(np.int64)
    g = coo_matrix((np.ones(len(e), np.int8), (e[:, 0], e[:, 1])), shape=(len(v), len(v)))
    perm = np.asarray(reverse_cuthill_mckee((g + g.T).tocsr(), symmetric_mode=True), np.int64)
    inv = np.empty(len(v), np.int64)
    inv[perm] = np.arange(len(v))
    return np.ascontiguousarray(v[perm]), inv[f].astype(np.int32)


@pytest.mark.parametrize("kind", ["terrain40x36", "rcm16"])
def test_structured_solve_through_the_kernel_matches_the_plain_solve(cuda, monkeypatch, kind):
    """The whole structured solve on the card, once through the kernel and
    once with the plain sweep in its place: the same sweeps, the same field
    and predecessors bit for bit, and the field equal to the native heap
    Dijkstra's within rtol 1e-4. The RCM-reordered terrain has a residual,
    so its residual scatter-min runs on the kernel's output buffer."""
    from mesh_navigation_torch.native import NativeMesh
    from mesh_navigation_torch.ops import structured as st
    from mesh_navigation_torch.ops import sweep_gpu as sg

    if kind == "rcm16":
        v, f = _rcm_relabel(*synthetic.terrain_mesh(16, 16, spacing=0.5, hills=1.5,
                                                    roughness=0.02, seed=5))
    else:
        v, f = synthetic.terrain_mesh(40, 36, spacing=0.5, hills=2.0, roughness=0.01, seed=0)
    mesh = build_mesh(v, f, device=cuda)
    costs = np.arccos(np.clip(host_array(mesh, "vertex_normals")[:, 2], -1.0, 1.0))
    costs = costs.astype(np.float32)
    W = sweeps.slot_weights_np(mesh, costs, cost_limit=2.0, edge_cost_factor=1.0)
    plan = st.build_offset_plan(mesh, W)
    assert plan.has_residual == (kind == "rcm16")
    seeds = torch.from_numpy(np.random.default_rng(3).integers(0, mesh.num_vertices, 24)).to(cuda)
    Wt = torch.from_numpy(W).to(cuda)
    before = kernels.LAUNCHES["fused_sweep"]
    got = st.batched_field_structured(mesh, Wt, plan, seeds)
    assert kernels.LAUNCHES["fused_sweep"] - before == got.sweeps
    monkeypatch.setattr(sg, "fused_sweep", sg._fused_sweep_plain)
    want = st.batched_field_structured(mesh, Wt, plan, seeds)
    assert got.converged and want.converged and got.sweeps == want.sweeps
    assert torch.equal(got.dist, want.dist) and torch.equal(got.pred, want.pred)
    nm = NativeMesh(v, f)
    try:
        ew = sweeps.compute_edge_weights(mesh, torch.from_numpy(costs).to(cuda), 1.0).cpu().numpy()
        nd = nm.dijkstra(ew, costs, int(seeds[0]), 2.0)[0]
    finally:
        nm.close()
    fin = np.isfinite(nd)
    np.testing.assert_allclose(got.dist[0].cpu().numpy()[fin], nd[fin], rtol=1e-4, atol=1e-6)


def test_fused_sweep_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    from mesh_navigation_torch.ops import sweep_gpu as sg

    offsets = (1, -1, 256, -256)
    d, planes = _sweep_inputs(256, 512, 8, offsets, cuda)
    with pytest.raises(ValueError, match="exceeds the tile"):
        sg.fused_sweep(d, planes, (1, -1, 257, -256), tile=256)
    with pytest.raises(ValueError, match="multiple of the tile"):
        sg.fused_sweep(d, planes[:, :500].contiguous(), offsets, tile=256)
    with pytest.raises(ValueError, match="contiguous f32"):
        sg.fused_sweep(d.double(), planes, offsets, tile=256)
    with pytest.raises(ValueError, match="contiguous f32"):
        sg.fused_sweep(d.T.contiguous().T, planes, offsets, tile=256)
    with pytest.raises(ValueError, match="contiguous f32"):
        sg.fused_sweep(d, planes.cpu(), offsets, tile=256)
    with pytest.raises(ValueError, match="apart from the input"):
        sg.fused_sweep(d, planes, offsets, tile=256, out=d)
    with pytest.raises(ValueError, match="unsupported device"):
        sg.fused_sweep(d.to("meta"), planes.to("meta"), offsets, tile=256)
    with pytest.raises(ValueError, match="shared memory"):
        sg.fused_sweep(*_sweep_inputs(16384, 16384, 1, (16384, -16384), cuda),
                       (16384, -16384), tile=16384)


def _server_pair(kind, cuda, n=64, hills=2.0):
    """The same map served on the card and on the CPU."""
    from mesh_navigation_torch.api.server import MeshNavServer
    from mesh_navigation_torch.config import LayerConfig, MeshMapConfig, NavConfig, PlannerConfig

    cfg = NavConfig(mesh_map=MeshMapConfig(default_layer="steep", edge_cost_factor=1.0),
                    planner=PlannerConfig(cost_limit=2.0),
                    layers=(LayerConfig(name="steep", kind="steepness",
                                        params=(("threshold", 2.0),)),))
    v, f = synthetic.terrain_mesh(n, n, spacing=0.5, hills=hills, roughness=0.01, seed=0)
    return v, [MeshNavServer(build_mesh(v, f, device=dev), cfg, planner_kind=kind,
                             max_path_len=4 * n, device=dev) for dev in (cuda, "cpu")]


def test_cvp_server_batch_on_card_matches_cpu(cuda):
    """The CVP server's get_path_batch (the eikonal pass kernel and the warm
    banded pass) on the card against the plain versions on the CPU, on the
    same 64 x 64 map: the same finite set, fields within twice the stopping
    tolerance (atol 1e-4 + rtol 1e-3 |d|: each side stops within it of the
    fixed point), the same outcomes."""
    v, (gpu, cpu) = _server_pair("cvp", cuda)
    rng = np.random.default_rng(9)
    p = torch.from_numpy(v[rng.integers(0, len(v), 16)].astype(np.float32))
    before = dict(kernels.LAUNCHES)
    got = gpu.get_path_batch(p[:8], p[8:])
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["eik_pass"] > before["eik_pass"]
    assert kernels.LAUNCHES["banded_pass"] > before["banded_pass"]
    ref = cpu.get_path_batch(p[:8], p[8:])
    assert got.converged and ref.converged
    dg, dr = got.d_pad.cpu()[..., :8], ref.d_pad[..., :8]
    assert torch.equal(torch.isfinite(dg), torch.isfinite(dr))
    fin = torch.isfinite(dr)
    assert bool(((dg[fin] - dr[fin]).abs() <= 2 * (1e-4 + 1e-3 * dr[fin].abs())).all())
    assert torch.equal(got.outcome.cpu(), ref.outcome)


@pytest.mark.parametrize("update", ["unfolding", "fmm"])
def test_gather_fields_on_card_match_cpu(cuda, update):
    """eikonal_field and shortest_path_field on the card against the CPU on
    a 64 x 64 terrain: dist within rtol 1e-5 (1e-6 for the Dijkstra field),
    the same sweeps, predecessors equal at 99% of the vertices (a rounding
    step may flip a near-tie)."""
    from mesh_navigation_torch.ops import eikonal

    v, f = synthetic.terrain_mesh(64, 64, spacing=0.5, hills=2.0, roughness=0.01, seed=0)
    mg, mc = build_mesh(v, f, device=cuda), build_mesh(v, f, device="cpu")
    rng = np.random.default_rng(3)
    costs = rng.uniform(0.0, 1.05, len(v)).astype(np.float32)
    side = sweeps.compute_edge_weights(mc, torch.from_numpy(costs), 1.0)
    seed = torch.full((len(v),), torch.inf)
    seed[mc.faces[2000].long()] = torch.tensor([0.1, 0.2, 0.15])
    mask = torch.from_numpy(costs < 1.0)
    a = eikonal.eikonal_field(mg, side.to(cuda), seed.to(cuda), update=update,
                              target_mask=mask.to(cuda))
    b = eikonal.eikonal_field(mc, side, seed, update=update, target_mask=mask)
    W = sweeps.slot_weights(mc, side, torch.from_numpy(costs), 1.0)
    c = sweeps.shortest_path_field(mg, W.to(cuda), 2000)
    d = sweeps.shortest_path_field(mc, W, 2000)
    for x, y, rtol in ((a, b, 1e-5), (c, d, 1e-6)):
        xd, yd = x.dist.cpu(), y.dist
        assert torch.equal(torch.isfinite(xd), torch.isfinite(yd))
        fin = torch.isfinite(yd)
        assert fin.float().mean() > 0.5
        assert bool(((xd[fin] - yd[fin]).abs() <= rtol * yd[fin].abs()).all())
        assert x.sweeps == y.sweeps and x.converged and y.converged
        assert (x.pred.cpu() == y.pred).float().mean() > 0.99


@pytest.mark.parametrize("kind", ["dijkstra", "cvp"])
def test_navigate_on_card_reaches_the_goal(cuda, kind):
    """navigate on the card, flat 64 x 64 map, a start 8 m from the goal:
    SUCCESS without recovery, within the goal tolerance of the plan's goal
    pose; no kernel is launched (GetPath is the gather solve)."""
    v, (srv, _) = _server_pair(kind, cuda, hills=0.0)
    start = torch.from_numpy((v[20 * 64 + 20] + np.float32([0, 0, 0.05])).astype(np.float32))
    goal = torch.from_numpy((v[34 * 64 + 26] + np.float32([0.12, 0.07, 0.05])).astype(np.float32))
    quat = torch.tensor([0.0, 0.0, 0.0, 1.0])
    before = dict(kernels.LAUNCHES)
    out = srv.navigate(start, quat, goal)
    assert out["outcome"] == 0 and out["recoveries"] == 0, out
    target = srv.set_plan(srv.get_path(start, goal)).goal_pos
    assert float(torch.linalg.norm(out["final_position"] - target)) <= 0.3
    assert kernels.LAUNCHES == before


def _terrain_pair(n, cuda):
    v, f = synthetic.terrain_mesh(n, n, spacing=0.5, hills=2.0, roughness=0.01, seed=0)
    return v, build_mesh(v, f, device=cuda), build_mesh(v, f, device="cpu")


@pytest.mark.parametrize("kind,params", [
    ("height_diff", (("radius", 1.0), ("threshold", 0.185))),
    ("roughness", (("radius", 1.0), ("threshold", 0.02))),
    ("ridge", (("radius", 1.0), ("threshold", 0.6))),
    ("border", ()),
    ("clearance", ()),
])
def test_local_layers_on_card_match_cpu(cuda, kind, params):
    """The five local layers at 128 x 128: lethal masks and radius tables
    equal, costs within 1e-5 (arccos may round otherwise on the card)."""
    from mesh_navigation_torch.config import LayerConfig
    from mesh_navigation_torch.layers import LAYER_REGISTRY

    _, mg, mc = _terrain_pair(128, cuda)
    fn = LAYER_REGISTRY[kind](LayerConfig(name="x", kind=kind, params=params))
    sg = fn.prepare(mg) if hasattr(fn, "prepare") else {}
    sc = fn.prepare(mc) if hasattr(fn, "prepare") else {}
    for key in sg:
        if key.startswith("neigh:"):
            assert all(torch.equal(a.cpu(), b) for a, b in zip(sg[key], sc[key]))
    og, oc = fn(mg, {}, sg), fn(mc, {}, sc)
    assert og.costs.device == mg.device and torch.equal(og.lethal.cpu(), oc.lethal)
    torch.testing.assert_close(og.costs.cpu(), oc.costs, rtol=0, atol=1e-5)


def test_raycasts_on_card_match_cpu(cuda):
    """raycast_grid against raycast_bruteforce on the card, and both against
    the CPU, for seeded rays from above a 128 x 128 terrain."""
    from mesh_navigation_torch.ops import raycast

    v, mg, mc = _terrain_pair(128, cuda)
    rng = np.random.default_rng(0)
    n = 512
    o = np.stack([rng.uniform(2, 60, n), rng.uniform(2, 60, n),
                  rng.uniform(v[:, 2].max() + 1.0, v[:, 2].max() + 3.0, n)], axis=1)
    d = rng.normal(size=(n, 3))
    d[:, 2] = -np.abs(d[:, 2]) - 0.3
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    o, d = torch.from_numpy(o.astype(np.float32)), torch.from_numpy(d.astype(np.float32))
    gg, gc = raycast.build_face_grid3d(mg), raycast.build_face_grid3d(mc)
    tg, fg, hg = raycast.raycast_grid(mg, gg, o.to(cuda), d.to(cuda), n_steps=96)
    tc, fc, hc = raycast.raycast_grid(mc, gc, o, d, n_steps=96)
    tb, fb, hb = raycast.raycast_bruteforce(mg, o.to(cuda), d.to(cuda))
    assert int(hb.sum()) > n // 2
    for t, f, h in ((tg, fg, hg), (tb, fb, hb)):
        assert torch.equal(h.cpu(), hc) and torch.equal(f.cpu(), fc)
        torch.testing.assert_close(t.cpu()[hc], tc[hc], rtol=0, atol=1e-5)


@pytest.mark.parametrize("wall", ["row", "patches"])
def test_repulsive_field_on_card_matches_cpu(cuda, wall):
    """The repulsive field on the card and on the CPU from the same
    distances: a straight row of lethal vertices on a flat grid (tied
    winning-face scores) and patches on the terrain."""
    from mesh_navigation_torch.layers import inflation

    n = 128
    if wall == "row":
        v, f = synthetic.terrain_mesh(n, n, spacing=0.5, hills=0.0, roughness=0.0, seed=0)
        mg, mc = build_mesh(v, f, device=cuda), build_mesh(v, f, device="cpu")
    else:
        v, mg, mc = _terrain_pair(n, cuda)
    lethal = np.zeros(len(v), bool)
    if wall == "row":
        lethal[64 * n + np.arange(20, 100)] = True
    else:
        rng = np.random.default_rng(1)
        for c in rng.integers(0, len(v), 12):
            lethal[np.clip(c + np.arange(-2, 3)[:, None] * n + np.arange(-2, 3), 0, len(v) - 1)] = True
    p = inflation.InflationParams(inflation_radius=2.0, inscribed_radius=0.5)
    dist = inflation.inflation_distances(mc, torch.from_numpy(lethal), p)
    rg = inflation.repulsive_field(mg, dist.to(cuda))
    rc = inflation.repulsive_field(mc, dist)
    assert rg.sweeps == rc.sweeps
    vg = rg.vectors.cpu()
    assert torch.equal(vg.ne(0).any(dim=1), rc.vectors.ne(0).any(dim=1))
    assert int(rc.vectors.ne(0).any(dim=1).sum()) > int(lethal.sum())
    torch.testing.assert_close(vg, rc.vectors, rtol=0, atol=1e-5)


# The kernels' handoffs launch after launch (the stress scripts
# scripts/*_stress.py run the same inputs against copies whose warps or
# blocks lag before each handoff): a race shows as a launch that differs
# from the plain version or fails a wait's assertion.

def test_class_pred_ring_of_row_slots_holds_launch_after_launch(cuda):
    """The cp.async ring of row slots (refilled two steps ahead, one barrier
    a step) on 256 x 1,024 x 128 and 130 x 300 x 32 fields: 150 launches in
    each mode equal the plain version."""
    for Rp, Cp, Bp in ((256, 1024, 128), (130, 300, 32)):
        d, w8 = _random_field(Rp, Cp, Bp, cuda, seed=Rp + Cp + Bp)
        kw = dict(R=Rp - 1, C=Cp - 1, V=(Rp - 1) * (Cp - 1) - 1, tol=6e-3)
        for as_class, check in ((True, (ATOL, RTOL)), (False, None)):
            t_p, f_p = bg.class_pred_plain(d, w8, **kw, check=check, as_class=as_class)
            for _ in range(150):
                t_k, f_k = bg.class_pred(d, w8, **kw, check=check, as_class=as_class)
                assert torch.equal(t_k, t_p)
                assert f_k is None or bool(f_k.any()) == bool(f_p)


def test_fused_sweep_ring_holds_launch_after_launch(cuda):
    """The ring of the next tile's rows and planes on the structured path's
    layout (tile 1,280, 128 lanes, the 1M terrain's offsets) and without
    spare ring rows (tile 5,632): 150 launches each equal the plain
    version."""
    from mesh_navigation_torch.ops import sweep_gpu as sg

    for tile, V, B, offsets in ((1280, 200_000, 128, (1, -1, 1024, -1024, 1025, -1025)),
                                (5632, 56_320, 1, (1, -1, 5631, -5631, 5632, -5632))):
        d, planes = _sweep_inputs(tile, V, B, offsets, cuda, seed=V + B)
        want = sg._fused_sweep_plain(d, planes, offsets, tile, 2)
        out = torch.empty_like(d)
        for _ in range(150):
            assert torch.equal(sg.fused_sweep(d, planes, offsets, tile=tile, n_inner=2, out=out),
                               want)


def test_eik_pass_progress_words_hold_launch_after_launch(cuda):
    """The release / acquire progress words between strip blocks, 64 x 200
    x 128 at strip width 4 (more strip-rows than resident blocks): a forced
    pass and the dirty-driven pass after it, 100 launches each, equal the
    plain version."""
    plan, _, _, d = _eik_field(64, 200, 128, cuda)
    cls = eg.class_sources(plan)
    dirty = torch.zeros((d.shape[2] // eg.EIK_LANES, d.shape[0]), dtype=torch.int32, device=cuda)
    for force in (True, False):
        kw = dict(reverse=False, chunk_dir=1, atol=ATOL, rtol=RTOL, force=force, strip_width=4)
        out_p, chg_p, dirty_p = eg._eik_pass_plain(d, plan.abc, cls, dirty, **kw)
        for _ in range(100):
            out_k, chg_k, dirty_k = eg.eik_pass(d, plan.abc, cls, dirty, **kw)
            assert torch.equal(out_k, out_p) and torch.equal(dirty_k, dirty_p)
            assert int(chg_k.item()) == int(chg_p.item())
        d, dirty = out_p, dirty_p


def test_pass_stages_and_carried_rows_hold_launch_after_launch(cuda):
    """The ordinary stage prefetch (a forced pass over 1,024-column rows,
    eight-warp blocks, rows staged by TMA) and the extended lanes' two
    carried rows (staged at 1,024 columns, from device memory at 2,048):
    100 launches each equal the plain version, rows walked included."""
    _, plan = _plan(64, 1024, cuda)
    seeds = torch.from_numpy(np.random.default_rng(5).integers(0, plan.num_vertices, 64))
    prob = bg.prepare_padded(plan, seeds.to(cuda))
    problems = [(prob.d0, prob.down, prob, (), None)]
    for Cp in (1024, 2048):
        d, down, _, a_fwd, a_bwd, xdown, _ = _xl_problem(64, Cp, 64, XLANES, cuda, seed=Cp)
        problems.append((d, down, _XLProb(a_fwd, a_bwd), XLANES, xdown))
    for d0, cross, chains, xlanes, xcross in problems:
        kw = dict(reverse=False, atol=ATOL, rtol=RTOL, force=True, xcross=xcross, xlanes=xlanes,
                  xlist=bg.xlane_list_from_dense(xcross, xlanes) if xlanes else None)
        d_p = d0.clone()
        wp = torch.zeros(1, dtype=torch.int64, device=cuda)
        chg_p = bg.directional_pass_plain(d_p, cross, chains.a_fwd, chains.a_bwd, bb=8,
                                          rows_walked=wp, **kw)
        for _ in range(100):
            d_k = d0.clone()
            wk = torch.zeros(1, dtype=torch.int32, device=cuda)
            chg_k = bg.directional_pass(d_k, cross, chains.a_fwd, chains.a_bwd, rows_walked=wk,
                                        **kw)
            assert torch.equal(d_k, d_p)
            assert bool(chg_k.item()) == bool(chg_p.item()) and int(wk.item()) == int(wp.item())


def test_dirty_pass_writes_its_scan_launch_after_launch(cuda):
    """The dirty mode writes a needed row's scan, its sub-tolerance gains
    included, with no second read of the carried row: every row dirty on a
    field solved to the replan tolerance, down and up, 100 launches each
    equal to the plain version (field, dirty table, flag, rows walked), and
    the pass lowers labels in rows it leaves unflagged."""
    _, plan = _plan(64, 1024, cuda)
    seeds = torch.from_numpy(np.random.default_rng(5).integers(0, plan.num_vertices, 64))
    prob = bg.prepare_padded(plan, seeds.to(cuda))
    d0 = bg.banded_solve_padded(plan, seeds.to(cuda), atol=ATOL, rtol=RTOL).d_pad
    every = torch.ones((d0.shape[2] // bg.PASS_LANES, d0.shape[0]), dtype=torch.int32,
                       device=cuda)
    for reverse, cross in ((False, prob.down), (True, prob.up)):
        kw = dict(reverse=reverse, atol=ATOL, rtol=RTOL)
        d_p, dirty_p = d0.clone(), every.clone()
        wp = torch.zeros(1, dtype=torch.int64, device=cuda)
        chg_p = bg.directional_pass_plain(d_p, cross, prob.a_fwd, prob.a_bwd, bb=8,
                                          dirty=dirty_p, rows_walked=wp, **kw)
        lowered = (d_p < d0).view(d0.shape[0], d0.shape[1], -1, bg.PASS_LANES)
        lowered = lowered.any(dim=3).any(dim=1).T                        # [blocks, rows]
        assert bool((lowered & (dirty_p == 0)).any())
        for _ in range(100):
            d_k, dirty_k = d0.clone(), every.clone()
            wk = torch.zeros(1, dtype=torch.int32, device=cuda)
            chg_k = bg.directional_pass(d_k, cross, prob.a_fwd, prob.a_bwd, dirty=dirty_k,
                                        rows_walked=wk, **kw)
            assert torch.equal(d_k, d_p) and torch.equal(dirty_k, dirty_p)
            assert bool(chg_k.item()) == bool(chg_p.item()) and int(wk.item()) == int(wp.item())


@pytest.mark.parametrize("ordered_rounds", [0, 2])
def test_server_third_branch_on_card_matches_cpu(cuda, ordered_rounds):
    """A Dijkstra server on a 64 x 64 jittered-Delaunay terrain whose vertex
    ids are permuted (no banded plan, offset coverage <= 0.5) answers a batch
    through plan_batch on the card as on the CPU: the fields, predecessors,
    rounds and outcomes equal (adds and minima only, in the same order)."""
    from mesh_navigation_torch.api.server import MeshNavServer
    from mesh_navigation_torch.config import LayerConfig, NavConfig, PlannerConfig

    v, f = synthetic.irregular_terrain_mesh(64, 64, spacing=0.5, jitter=0.45, hills=2.0,
                                            roughness=0.01, seed=1)
    perm = np.random.default_rng(7).permutation(len(v))
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(v))
    v, f = v[perm], inv[f].astype(np.int32)
    cfg = NavConfig(planner=PlannerConfig(cost_limit=2.0, ordered_rounds=ordered_rounds),
                    layers=(LayerConfig(name="steepness", kind="steepness"),))
    rng = np.random.default_rng(2)
    s = torch.from_numpy(v[rng.integers(0, len(v), 16)])
    g = torch.from_numpy(v[rng.integers(0, len(v), 16)])
    res = {}
    for dev in (cuda, torch.device("cpu")):
        srv = MeshNavServer(build_mesh(v, f, device=dev), cfg, planner_kind="dijkstra",
                            max_path_len=256, device=dev)
        assert srv.banded_plan is None and srv.offset_plan.coverage <= 0.5
        res[dev.type] = srv.get_path_batch(s, g)
    a, b = res["cuda"], res["cpu"]
    assert a.converged and b.converged and a.rounds == b.rounds
    assert torch.equal(a.potential.cpu(), b.potential)
    assert torch.equal(a.pred.cpu(), b.pred)
    assert torch.equal(a.outcome.cpu(), b.outcome) and bool((b.outcome == 0).all())
    assert torch.equal(a.path_valid.cpu(), b.path_valid)


@pytest.mark.parametrize("name", ["maze", "wall_clear"])
def test_windowed_solve_on_card_matches_cpu(cuda, name):
    """The windowed warm resolve of tests/window_cases.py on the card and
    on the CPU: the maze refills over several slab rounds with the seam
    intact, the wall clear aborts at the seam and the full loop finishes.
    The same window record and rounds, fields bit for bit (the pass and
    check kernels equal their plain versions); the slab's passes and
    certificates launched on the card."""
    import window_cases as wc

    out = {}
    for dev in (cuda, torch.device("cpu")):
        p0, p1, seeds, old, new, d_prev = wc.case(name, dev)
        before = dict(kernels.LAUNCHES)
        out[dev.type] = wc.warm(p0, p1, seeds, old, new, d_prev, warm_window=128)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert kernels.LAUNCHES["check"] >= before["check"] + out["cuda"].window.slab_rounds
            assert kernels.LAUNCHES["banded_pass_dirty"] >= (
                before["banded_pass_dirty"] + 2 * out["cuda"].window.slab_rounds)
    k, c = out["cuda"], out["cpu"]
    assert k.converged and c.converged and k.window.fit
    assert k.window == c.window and k.rounds == c.rounds
    assert k.window.done == (name == "maze") and k.window.seam_abort == (name != "maze")
    assert torch.equal(k.d_pad.cpu(), c.d_pad)


def test_hybrid_solve_on_card_matches_cpu(cuda):
    """eikonal_solve_padded with the CVP planner's Dijkstra warm plan as its
    graph_plan, on the card and on the CPU, cold at orderings 4: both
    converged, the same finite set, fields within twice the stopping
    tolerance (the eikonal solve's card-vs-CPU agreement, as in
    test_cvp_server_batch_on_card_matches_cpu); eik_pass and banded_pass
    launched on the card."""
    from mesh_navigation_torch.config import PlannerConfig
    from mesh_navigation_torch.planners import CVPPlanner

    v, f = synthetic.terrain_mesh(40, 36, spacing=0.5, hills=2.0, roughness=0.01, seed=1)
    rng = np.random.default_rng(3)
    atol, rtol = 1e-4, 1e-3
    out = {}
    for dev in (cuda, torch.device("cpu")):
        mesh = build_mesh(v, f, device=dev)
        nz = np.clip(host_array(mesh, "vertex_normals")[:, 2], -1.0, 1.0)
        costs = np.arccos(nz).astype(np.float32)
        ew = sweeps.compute_edge_weights(mesh, torch.from_numpy(costs).to(dev), 1.0)
        planner = CVPPlanner(mesh, PlannerConfig(cost_limit=2.0), device=dev)
        plan = planner.prepare_eikonal_plan(ew.cpu().numpy(), costs)
        if dev.type == "cuda":
            faces = host_array(mesh, "faces")[rng.integers(0, mesh.num_faces, 8)]
            seed_v = torch.from_numpy(faces.astype(np.int64))
            seed_d = torch.from_numpy(rng.uniform(0.05, 0.4, faces.shape).astype(np.float32))
        before = dict(kernels.LAUNCHES)
        out[dev.type] = eg.eikonal_solve_padded(plan, seed_v, seed_d, atol=atol, rtol=rtol,
                                                orderings=4, graph_plan=planner._dij_plan)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert kernels.LAUNCHES["eik_pass"] > before["eik_pass"]
            assert kernels.LAUNCHES["banded_pass"] > before["banded_pass"]
    k, c = out["cuda"], out["cpu"]
    assert k.converged and c.converged
    dk, dc = k.d_pad.cpu()[..., :8], c.d_pad[..., :8]
    fin = torch.isfinite(dc)
    assert torch.equal(torch.isfinite(dk), fin)
    assert bool(((dk[fin] - dc[fin]).abs() <= 2 * (atol + rtol * dc[fin].abs())).all())


def _sharded_pair(cuda, backend, device):
    """The 64 x 64 terrain's plan solved on 2 row shards by 2 spawned ranks
    (tests/torch_parallel_ranks.py) and by the single-device solve, both
    with the pass kernel, at zero tolerance."""
    import torch_parallel_ranks as ranks
    from mesh_navigation_torch.parallel import build_sharded_banded_plan

    kernels.build_all()                    # the ranks bind the built libraries
    mesh, plan = _plan(64, 64, cuda)
    seeds = np.random.default_rng(7).integers(0, mesh.num_vertices, 12)
    single = bg.banded_solve_padded(plan, torch.from_numpy(seeds).to(cuda), atol=0.0, rtol=0.0)
    R, C, V = plan.n_rows, plan.n_cols, plan.num_vertices
    ref = single.d_pad[:R, :C, :12].reshape(-1, 12)[:V].cpu()
    d, rounds, conv, launches = ranks.run(
        "banded_solve", 2, {"splan": build_sharded_banded_plan(plan, 2), "seeds": seeds},
        backend=backend, device=device)
    assert single.converged and conv
    assert all(n >= 2 * rounds for n in launches)     # two kernel passes a round on each rank
    fin = torch.isfinite(ref)
    assert torch.equal(torch.isfinite(d), fin)
    torch.testing.assert_close(d[fin], ref[fin], rtol=1e-6, atol=1e-6)
    return d, ref


def test_sharded_banded_solve_two_gloo_ranks_on_one_card(cuda):
    """Two gloo ranks share cuda:0 (the exchange staged through pinned host
    buffers): the fields of the single-device kernel solve within 1e-6,
    reachability equal."""
    _sharded_pair(cuda, "gloo", "cuda:0")


def test_sharded_banded_solve_nccl_one_rank_a_card(cuda):
    """NCCL, one rank on each of two cards: the same fields as gloo's."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices for NCCL")
    d_nccl, ref = _sharded_pair(cuda, "nccl", None)
    d_gloo, _ = _sharded_pair(cuda, "gloo", "cuda:0")
    assert torch.equal(d_nccl, d_gloo)


# ---------------------------------------------------------------------------
# the solver's opt-in modes: bfloat16 fields, partial scan depth, the
# deferring and unskipped passes, the column passes of four_dir
# ---------------------------------------------------------------------------

# (nx, ny, B): one column a thread (16 columns), staged rows (40 and 1,024
# columns; 1,024 with eight-warp blocks), and eight columns a thread with
# rows from device memory (1,500)
MODE_SHAPES = [(20, 16, 16), (33, 40, 24), (12, 1024, 16), (8, 1500, 16)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("nx,ny,B", MODE_SHAPES)
def test_pass_modes_match_plain_bit_for_bit(cuda, nx, ny, B, dtype):
    """Every row and scan mode of the pass, kernel against plain bit for bit
    (fields, dirty tables, flags, rows walked): a forced and an unforced
    pass of the main mode; partial depth (2 and 5 steps, 3 on rows of 16
    columns) with the dirty
    table, forced, then dirty-driven; the deferring down pass, then the
    dirty-driven up pass it leaves rows to; the unskipped pass, with and
    without the warm cut. Each counted under its mode."""
    mesh, plan = _plan(nx, ny, cuda)
    seeds = torch.from_numpy(np.random.default_rng(ny).integers(0, mesh.num_vertices, B))
    prob = bg.prepare_padded(plan, seeds.to(cuda), dtype=dtype)
    Rp = prob.d0.shape[0]
    clean = lambda: torch.zeros((B // 8, Rp), dtype=torch.int32, device=cuda)   # noqa: E731
    d_k, d_p = prob.d0.clone(), prob.d0.clone()
    before = dict(kernels.LAUNCHES)
    _pass_pair(d_k, d_p, prob.down, prob, reverse=False, force=True)
    _pass_pair(d_k, d_p, prob.up, prob, reverse=True)
    for steps in (2, min(5, plan.n_scan - 1)):     # below full depth
        d_k, d_p = prob.d0.clone(), prob.d0.clone()
        dirty, _ = _pass_pair(d_k, d_p, prob.down, prob, reverse=False, force=True,
                              dirty=clean(), scan_steps=steps)
        _pass_pair(d_k, d_p, prob.up, prob, reverse=True, dirty=dirty, scan_steps=steps)
    d_k, d_p = prob.d0.clone(), prob.d0.clone()
    dirty, _ = _pass_pair(d_k, d_p, prob.down, prob, reverse=False, force=True, dirty=clean(),
                          defer=True)
    assert bool(dirty.any())
    _pass_pair(d_k, d_p, prob.up, prob, reverse=True, dirty=dirty)
    d_k, d_p = prob.d0.clone(), prob.d0.clone()
    _pass_pair(d_k, d_p, prob.down, prob, reverse=False, skip=False)
    Cp = prob.d0.shape[1]
    cut = (torch.zeros((Rp, Cp), device=cuda), torch.full((B,), 5.0, device=cuda),
           torch.stack([seeds % Rp, seeds % Cp]).to(cuda, torch.int32))
    _pass_pair(d_k, d_p, prob.up, prob, reverse=True, skip=False, cut=cut)
    n = 10
    assert kernels.LAUNCHES["banded_pass"] == before["banded_pass"] + n
    assert kernels.LAUNCHES["banded_pass_partial"] == before["banded_pass_partial"] + 4
    assert kernels.LAUNCHES["banded_pass_defer"] == before["banded_pass_defer"] + 1
    assert kernels.LAUNCHES["banded_pass_noskip"] == before["banded_pass_noskip"] + 2
    assert kernels.LAUNCHES["banded_pass_bf16"] == before["banded_pass_bf16"] + (
        n if dtype == torch.bfloat16 else 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("Cp", [32, 1024, 2048])
def test_extended_lane_pass_modes_match_plain_bit_for_bit(cuda, Cp, dtype):
    """The extended lanes with a bf16 field and with partial depth (three
    rows in shared memory: from device memory past the staged budget),
    forced then dirty-driven, the deferring down pass and the up pass after
    it, and unskipped: kernel against plain bit for bit."""
    Rp, Bp = 40, 16
    d, down, up, a_fwd, a_bwd, xdown, xup = _xl_problem(Rp, Cp, Bp, XLANES, cuda, seed=Cp + 1)
    prob = _XLProb(a_fwd, a_bwd)
    d = d.to(dtype)
    for steps in (0, 3):
        d_k, d_p = d.clone(), d.clone()
        dirty = torch.zeros((Bp // 8, Rp), dtype=torch.int32, device=cuda)
        dirty, _ = _pass_pair(d_k, d_p, down, prob, reverse=False, force=True, dirty=dirty,
                              xcross=xdown, xlanes=XLANES, scan_steps=steps)
        _pass_pair(d_k, d_p, up, prob, reverse=True, dirty=dirty, xcross=xup, xlanes=XLANES,
                   scan_steps=steps)
    d_k, d_p = d.clone(), d.clone()
    dirty = torch.zeros((Bp // 8, Rp), dtype=torch.int32, device=cuda)
    dirty, _ = _pass_pair(d_k, d_p, down, prob, reverse=False, force=True, dirty=dirty,
                          xcross=xdown, xlanes=XLANES, defer=True)
    _pass_pair(d_k, d_p, up, prob, reverse=True, dirty=dirty, xcross=xup, xlanes=XLANES)
    d_k, d_p = d.clone(), d.clone()
    _pass_pair(d_k, d_p, down, prob, reverse=False, xcross=xdown, xlanes=XLANES, skip=False)


def test_pass_wrapper_and_kernel_agree_on_the_partial_depth_column_limits(cuda):
    """Partial depth keeps a third row in shared memory: PASS_MAX_COLS_X2
    columns without a sel-2 lane, PASS_MAX_COLS_X3 with one, the kernel's
    own limits; wider rows raise, and so does a depth past the chain
    weights' levels."""
    assert kernels.query("banded_pass", "banded_pass_max_cols_x3")() == bg.PASS_MAX_COLS_X3
    assert kernels.query("banded_pass", "banded_pass_max_cols_x2")() == bg.PASS_MAX_COLS_X2
    for Cp, xlanes in ((bg.PASS_MAX_COLS_X2 + 256, ()), (bg.PASS_MAX_COLS_X3 + 256, ((2, 0),))):
        d = torch.full((2, Cp, 8), torch.inf, device=cuda)
        cross = torch.zeros((2, 3, Cp), device=cuda)
        a = torch.zeros((2, 3, Cp), device=cuda)
        x = torch.zeros((2, len(xlanes), Cp), device=cuda) if xlanes else None
        with pytest.raises(ValueError, match="at most"):
            bg.directional_pass(d, cross, a, a, reverse=False, atol=ATOL, rtol=RTOL,
                                scan_steps=2, xcross=x, xlanes=xlanes)
        bg.directional_pass(d, cross, a, a, reverse=False, atol=ATOL, rtol=RTOL, xcross=x,
                            xlanes=xlanes,       # full depth takes the row
                            xlist=bg.xlane_list_from_dense(x, xlanes) if xlanes else None)
    with pytest.raises(ValueError, match="levels"):
        bg.directional_pass(d, cross, a, a, reverse=False, atol=ATOL, rtol=RTOL, scan_steps=4)


@pytest.mark.parametrize("Rp,Cp,Bp", [(1, 37, 8), (45, 3000, 8), (70, 33, 128),
                                      (33, 300, 1024), (130, 70, 1024), (65, 17, 32)])
def test_bf16_class_pred_and_check_match_plain(cuda, Rp, Cp, Bp):
    """The class-pred kernel (int8 with and without the certificate, int32
    ids) and the check kernel on bf16 fields: tables identical, flags equal
    to the plain versions', and counted under class_pred_bf16 / check_bf16."""
    d, w8 = _random_field(Rp, Cp, Bp, cuda, seed=Rp + Cp + Bp)
    d = d.to(torch.bfloat16)
    R, C = max(Rp - 1, 1), max(Cp - 1, 1)
    before = dict(kernels.LAUNCHES)
    _pred_pair(d, w8, dict(R=R, C=C, V=R * C - (1 if R * C > 1 else 0), tol=1e-2))
    assert kernels.LAUNCHES["class_pred_bf16"] == before["class_pred_bf16"] + 4
    for atol, rtol in ((1e-3, 4e-3), (0.0, 0.0)):
        k = bool(bg.check(d, w8, atol=atol, rtol=rtol).item())
        assert k == bool(bg.check_plain(d, w8, atol=atol, rtol=rtol))
    assert kernels.LAUNCHES["check_bf16"] == before["check_bf16"] + 2


@pytest.mark.parametrize("tile,V,B,n_inner,offsets", [
    (256, 1000, 8, 1, (1, -1, 256, -256)),
    (256, 1500, 24, 2, (1, -1, 40, -40, 41, -41)),
    (1280, 5000, 128, 2, (1, -1, 1024, -1024, 1025, -1025)),
    (512, 3000, 5, 12, (1, -512)),
    (256, 700, 3, 3, (-256, 3, 200, -7)),
])
def test_bf16_fused_sweep_matches_plain(cuda, tile, V, B, n_inner, offsets):
    """The bf16 instantiation (lane groups of 16, 4 and 1 bf16 lanes; 2-byte
    copies at 5 and 3 lanes) against its plain version bit for bit, twice in
    a row between two buffers, counted under fused_sweep_bf16."""
    from mesh_navigation_torch.ops import sweep_gpu as sg

    d, planes = _sweep_inputs(tile, V, B, offsets, cuda, seed=V + B + 1)
    d, planes = d.bfloat16(), planes.bfloat16()
    before = kernels.LAUNCHES["fused_sweep_bf16"]
    got = sg.fused_sweep(d, planes, offsets, tile=tile, n_inner=n_inner)
    want = sg._fused_sweep_plain(d, planes, offsets, tile, n_inner)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    assert kernels.LAUNCHES["fused_sweep_bf16"] == before + 1
    again = sg.fused_sweep(got, planes, offsets, tile=tile, n_inner=n_inner,
                           out=torch.empty_like(d))
    assert torch.equal(again, sg._fused_sweep_plain(want, planes, offsets, tile, n_inner))
    with pytest.raises(ValueError, match="one type"):
        sg.fused_sweep(d, planes.float(), offsets, tile=tile)


def _solve_pair(plan, seeds, cuda, **kw):
    """The same banded solve on the card and on the CPU."""
    plan_cpu = dataclasses.replace(plan, **{f.name: getattr(plan, f.name).cpu()
                                            for f in dataclasses.fields(plan)
                                            if isinstance(getattr(plan, f.name), torch.Tensor)})
    return (bg.banded_solve_padded(plan, seeds.to(cuda), **kw),
            bg.banded_solve_padded(plan_cpu, seeds.cpu(), **kw))


@pytest.mark.parametrize("kw", [
    {"dtype": torch.bfloat16}, {"scan_steps": 3}, {"scan_dirs": "up"}, {"skip_rows": False},
    {"four_dir": True}, {"dtype": torch.bfloat16, "scan_steps": 4, "four_dir": True},
], ids=["bf16", "partial3", "defer", "noskip", "four_dir", "bf16_partial4_four_dir"])
def test_solve_modes_on_the_card_match_the_cpu(cuda, kw):
    """Whole solves in each mode on a 48 x 72 terrain: converged on both,
    of one storage type, the same finite support and the fields within
    twice the stopping tolerance (of the bf16 floors in bf16)."""
    _, plan = _plan(48, 72, cuda)
    seeds = torch.from_numpy(np.random.default_rng(9).integers(0, plan.num_vertices, 24))
    card, cpu = _solve_pair(plan, seeds, cuda, atol=ATOL, rtol=RTOL, **kw)
    assert card.converged and cpu.converged
    assert card.d_pad.dtype == cpu.d_pad.dtype
    bf16 = kw.get("dtype") == torch.bfloat16
    _within_twice(card.d_pad.cpu(), cpu.d_pad, *((bg.BF16_ATOL, bg.BF16_RTOL) if bf16
                                                 else (ATOL, RTOL)))


def _within_twice(k, c, atol, rtol):
    k, c = k.float(), c.float()
    fin = torch.isfinite(c)
    assert torch.equal(fin, torch.isfinite(k))
    assert bool(((k - c).abs()[fin] <= 2 * (atol + rtol * c.abs()[fin])).all())


def test_four_dir_irregular_solve_on_the_card_matches_the_cpu(cuda):
    """four_dir on a 40 x 40 band-reordered Delaunay terrain whose transposed
    plan leaves (+-3, 0) out: residual edges, extended lanes in both
    orientations; card and CPU converge within twice the stopping
    tolerance of each other."""
    from mesh_navigation_torch.mesh import reorder

    v, f = synthetic.irregular_terrain_mesh(40, 40, spacing=0.5, hills=1.0, seed=2)
    mesh = reorder.build_reordered_mesh(v, f, device=cuda)
    costs = np.random.default_rng(3).uniform(0.0, 0.6, mesh.num_vertices).astype(np.float32)
    W = sweeps.slot_weights_np(mesh, costs, cost_limit=2.0, edge_cost_factor=1.0)
    plan = bg.build_banded_kernel_plan(mesh, W)
    assert plan.n_residual and bg.transpose_banded_plan(plan).xlanes_dropped
    seeds = torch.tensor([5, 900, 1000, 17, 600, 3, 111, 233])
    card, cpu = _solve_pair(plan, seeds, cuda, atol=1e-3, rtol=2e-3, four_dir=True)
    assert card.converged and cpu.converged
    _within_twice(card.d_pad.cpu(), cpu.d_pad, 1e-3, 2e-3)


def test_new_pass_modes_hold_launch_after_launch(cuda):
    """The bf16 stage ring (a forced pass over 1,024-column rows, eight-warp
    blocks, rows staged by TMA in 16-byte box rows) and the partial-depth
    exchange (5 steps, dirty-driven), 100 launches each equal to the plain
    version, rows walked included."""
    _, plan = _plan(64, 1024, cuda)
    seeds = torch.from_numpy(np.random.default_rng(5).integers(0, plan.num_vertices, 64))
    for dtype, modes, dirty in ((torch.bfloat16, {}, False),
                                (torch.float32, {"scan_steps": 5}, True),
                                (torch.bfloat16, {"scan_steps": 5}, True)):
        prob = bg.prepare_padded(plan, seeds.to(cuda), dtype=dtype)
        table = (torch.zeros((8, prob.d0.shape[0]), dtype=torch.int32, device=cuda)
                 if dirty else None)
        kw = dict(reverse=False, atol=ATOL, rtol=RTOL, force=True, **modes)
        d_p = prob.d0.clone()
        dirty_p = None if table is None else table.clone()
        wp = torch.zeros(1, dtype=torch.int64, device=cuda)
        chg_p = bg.directional_pass_plain(d_p, prob.down, prob.a_fwd, prob.a_bwd, bb=8,
                                          dirty=dirty_p, rows_walked=wp, **kw)
        for _ in range(100):
            d_k = prob.d0.clone()
            dirty_k = None if table is None else table.clone()
            wk = torch.zeros(1, dtype=torch.int32, device=cuda)
            chg_k = bg.directional_pass(d_k, prob.down, prob.a_fwd, prob.a_bwd, dirty=dirty_k,
                                        rows_walked=wk, **kw)
            assert torch.equal(d_k, d_p)
            assert dirty_k is None or torch.equal(dirty_k, dirty_p)
            assert bool(chg_k.item()) == bool(chg_p.item()) and int(wk.item()) == int(wp.item())


def _walk_case(kind, device, B=45):
    """A class table on the card for the walk kernel: a gridded plan or a
    band-reordered irregular plan (class 9 decoded through its residual
    tables), both with scattered walls, solved from B seeds; and B starts:
    lane 0 at its goal, lane 1 at a vertex whose class is 8 and that is not
    its goal (unreachable), the irregular plan's other lanes at a class-9
    vertex of their own column where there is one, the rest random.
    Returns (cls [V, Bp] int8, decode, starts, seeds, C)."""
    from mesh_navigation_torch.mesh import reorder

    if kind == "grid":
        v, f = synthetic.terrain_mesh(48, 40, spacing=0.5, hills=2.0, roughness=0.01, seed=0)
        mesh = build_mesh(v, f, device=device)
    else:
        v, f = synthetic.irregular_terrain_mesh(32, 32, spacing=0.5, hills=1.0, seed=4)
        mesh = reorder.build_reordered_mesh(v, f, device=device)
    V = mesh.num_vertices
    nz = np.clip(host_array(mesh, "vertex_normals")[:, 2], -1.0, 1.0)
    costs = np.arccos(nz).astype(np.float32)
    wall = (np.arange(V) % 97) == 5
    costs[wall] = np.inf
    W = sweeps.slot_weights_np(mesh, costs, cost_limit=2.0, edge_cost_factor=1.0)
    plan = bg.build_banded_kernel_plan(mesh, W)
    assert bool(plan.n_residual) == (kind == "irregular")
    rng = np.random.default_rng(3)
    seeds = rng.choice(np.flatnonzero(~wall), B)
    seeds_d = torch.from_numpy(seeds).to(device)
    if kind == "grid":
        res = bg.banded_solve_padded(plan, seeds_d, atol=ATOL, rtol=RTOL, converge="pred")
        cls, decode = res.cls, {}
    else:
        res = bg.banded_solve_padded(plan, seeds_d, atol=ATOL, rtol=RTOL, converge="round")
        cls, choice = bg.predecessors_banded_classes_residual(plan, res.d_pad, tol=3 * RTOL)
        decode = dict(res_row_map=plan.res_row_map, res_jump=plan.res_jump, res_choice=choice)
    assert res.converged and cls.shape[1] > B
    cls_h = cls.cpu()
    starts = rng.integers(0, V, B)
    starts[0] = seeds[0]
    stuck = torch.nonzero((cls_h[:, 1] == 8) & (torch.arange(V) != int(seeds[1]))).flatten()
    starts[1] = int(stuck[0])
    if kind == "irregular":
        nines = 0
        for b in range(2, B):
            at = torch.nonzero(cls_h[:, b] == 9).flatten()
            if len(at):
                starts[b], nines = int(at[0]), nines + 1
        assert nines >= B // 4
    return cls, decode, torch.from_numpy(starts).to(device), seeds_d, plan.n_cols


@pytest.mark.parametrize("B", [45, 33])
@pytest.mark.parametrize("kind", ["grid", "irregular"])
def test_walk_kernel_matches_the_plain_loop_bit_for_bit(cuda, kind, B):
    """The walk kernel against its plain loop on the card, path for path
    and bit for bit (path and valid), on a gridded plan and on an irregular
    plan whose walks decode class 9, at lane counts that are not a multiple
    of 32 and below the table's padded lanes: once with room for every
    path (600 steps) and once with a max_len that cuts the longest lanes
    off and that others end before. Lane 0 starts at its goal and lane 1
    cannot reach its own: each walks one step. Each walk is one launch."""
    cls, decode, starts, seeds, C = _walk_case(kind, cuda)
    starts, seeds = starts[:B], seeds[:B]
    steps = None
    for max_len in (600, None):
        if max_len is None:
            max_len = int(steps.max()) - 4
            assert bool((steps > max_len).any()) and bool((steps < max_len).any())
        assert max_len % 256
        before = kernels.LAUNCHES["walk"]
        pk, vk = bg.extract_paths_cls(cls, starts, seeds, max_len, C, **decode)
        assert kernels.LAUNCHES["walk"] == before + 1
        pp, vp = bg.extract_paths_cls_plain(cls, starts, seeds, max_len, C, **decode)
        assert pk.shape == (B, max_len) and pk.dtype == torch.int64 and vk.dtype == torch.bool
        assert torch.equal(vk, vp), int((vk != vp).sum())
        assert torch.equal(pk, pp), int((pk != pp).sum())
        if steps is None:
            steps = vk.sum(dim=1)
            assert int(steps[0]) == 1 and int(steps[1]) == 1
            assert bool((steps < max_len).all())


def test_walk_kernel_reads_back_only_with_a_timer(cuda):
    """Two launches back to back give the same paths and make no host read
    (synchronising calls raise); each adds one to LAUNCHES["walk"] and
    neither counts steps. Given a timer, the walk makes exactly one host
    read and counts the longest lane's walked steps under "walk_steps" and
    all lanes' under "walk_lane_steps"."""
    import warnings

    from mesh_navigation_torch.utils.timing import StageTimer

    cls, decode, starts, seeds, C = _walk_case("irregular", cuda)
    bg.extract_paths_cls(cls, starts, seeds, 300, C, **decode)      # built and bound
    torch.cuda.synchronize()
    before = dict(kernels.LAUNCHES)
    torch.cuda.set_sync_debug_mode("error")
    try:
        first = bg.extract_paths_cls(cls, starts, seeds, 300, C, **decode)
        second = bg.extract_paths_cls(cls, starts, seeds, 300, C, **decode)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert kernels.LAUNCHES["walk"] == before["walk"] + 2
    for key in ("walk_steps", "walk_lane_steps"):
        assert kernels.LAUNCHES[key] == before[key], key
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            path, valid = bg.extract_paths_cls(cls, starts, seeds, 300, C,
                                               timer=StageTimer(cuda), **decode)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    reads = [w for w in caught if "synchroniz" in str(w.message)]
    assert len(reads) == 1, [str(w.message) for w in reads]
    assert torch.equal(path, first[0]) and torch.equal(valid, first[1])
    assert kernels.LAUNCHES["walk"] == before["walk"] + 3
    assert kernels.LAUNCHES["walk_steps"] - before["walk_steps"] == int(valid.sum(1).max())
    assert kernels.LAUNCHES["walk_lane_steps"] - before["walk_lane_steps"] == int(valid.sum())


def test_walk_kernel_refuses_tables_it_does_not_take(cuda):
    """The walk's wrapper raises on a table the kernel does not take: a
    class table of another type or with lanes not contiguous, a residual
    decode with a table missing or of another type or device, float
    starts."""
    cls, decode, starts, seeds, C = _walk_case("irregular", cuda)
    bad = [
        dict(cls_vb=cls.to(torch.int32)),
        dict(cls_vb=cls.t().contiguous().t()),
        dict(res_jump=None),
        dict(res_choice=decode["res_choice"].to(torch.int32)),
        dict(res_row_map=decode["res_row_map"].long()),
        dict(res_jump=decode["res_jump"].cpu()),
        dict(start_v=starts.float()),
    ]
    for change in bad:
        kw = dict(cls_vb=cls, start_v=starts, goal_v=seeds, **decode)
        kw.update(change)
        with pytest.raises(ValueError):
            bg.extract_paths_cls(max_len=64, C=C, **kw)
