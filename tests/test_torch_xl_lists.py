"""The extended lanes' per-row lists (ops/banded_gpu.XLaneList), which the
pass kernel reads in place of the dense [R, L, Cp] lane planes, and the
port of refresh_banded_planes (pallas_banded.py:512-577).

The lists are built on a band-reordered 32 x 32 Delaunay terrain's plan
(lanes of all three source rows on one side or the other), on its
transpose, on its row shards, and after each refresh: expanded back they
give the dense planes bit for bit, and their layout is what the kernel
reads (entries sorted by column within a row, each row's first entry at a
multiple of 4, row headers with the spans of the rows beside each row and
the offsets of each 4-column group). A
refreshed list equals a fresh build's. refresh_banded_planes is held
against the reference's bit for bit on the gathered planes (a gather
computes nothing) and within one ulp on the chain weights (sums of the
same planes, which XLA may fuse into another order), as the port's plan
tests hold build_banded_kernel_plan.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mesh_navigation_tpu.mesh import synthetic
from mesh_navigation_tpu.ops import pallas_banded as jpb
from mesh_navigation_tpu.ops import sweeps as jsweeps

from mesh_navigation_torch.mesh import reorder as treorder
from mesh_navigation_torch.ops import banded_gpu as tbg
from mesh_navigation_torch.parallel import build_sharded_banded_plan

from test_torch_reference import reference_build_mesh

torch.set_num_threads(2)

COST_LIMIT = 2.0


@functools.lru_cache(maxsize=None)
def _case():
    """(jm, tm, costs, W, jplan, tplan) of the 32 x 32 irregular terrain
    (the lanes (2, 0), (0, -2), (0, 2) and their mirrors)."""
    v, f = synthetic.irregular_terrain_mesh(32, 32, spacing=0.5, hills=1.0, seed=4)
    jm = reference_build_mesh(v, f, reorder=True)
    tm = treorder.build_reordered_mesh(v, f, device="cpu")
    costs = np.random.default_rng(3).uniform(0.0, 0.6, tm.num_vertices).astype(np.float32)
    W = jsweeps.slot_weights_np(jm, costs, cost_limit=COST_LIMIT, edge_cost_factor=1.0)
    jplan, tplan = jpb.build_banded_kernel_plan(jm, W), tbg.build_banded_kernel_plan(tm, W)
    return jm, tm, costs, W, jplan, tplan


def _new_costs(costs):
    new = costs.copy()
    new[::13] = np.inf          # lethal: edges whose weight turns +inf stay listed
    new[5::17] = 2.5            # past the cost limit as a source
    new[7::11] = 0.05
    return new


def _check_layout(xl: tbg.XLaneList, R: int, Cp: int, lanes) -> None:
    """What the kernel reads: each row's header (its first entry, at a
    multiple of 4; the first entry and count of the rows beside it; the
    offsets of its XLIST_GROUP-column groups, in order), entries sorted by
    column, each in its group, of a listed lane with its (sel, dc), its
    source column on the row."""
    G = -(-Cp // tbg.XLIST_GROUP)
    goff = xl.goff.numpy()
    assert goff.shape == (R, tbg.xlist_width(Cp)) and xl.goff.dtype == torch.int32
    start, off = (t.numpy() for t in xl.offsets())
    count = off[:, G]
    assert np.all(start % 4 == 0) and np.all(off[:, 0] == 0)
    assert np.all(np.diff(off[:, :G + 1], axis=1) >= 0)
    assert np.all(start[1:] >= start[:-1] + count[:-1])
    assert np.array_equal(goff[:-1, 1], start[1:]) and np.array_equal(goff[:-1, 2], count[1:])
    assert np.array_equal(goff[1:, 3], start[:-1]) and np.array_equal(goff[1:, 4], count[:-1])
    assert goff[-1, 2] == 0 and xl.max_row == int(count.max())
    assert torch.equal(xl.row_counts(Cp), torch.from_numpy(count))
    meta = xl.meta.numpy().astype(np.int64)
    for r in range(R):
        m = meta[start[r]:start[r] + count[r]]
        col, sel, dc, li = m & 0xfff, (m >> 12) & 3, ((m >> 14) & 15) - 4, m >> 18
        assert np.array_equal(np.searchsorted(col, np.arange(G + 1) * tbg.XLIST_GROUP),
                              off[r, :G + 1])
        assert np.all(np.diff(col) >= 0)
        assert all(lanes[i] == (s, c) for i, s, c in zip(li, sel, dc))
        assert np.all((col + dc >= 0) & (col + dc < Cp))
    src = xl.src.numpy()
    listed = np.zeros(len(src), bool)
    for r in range(R):
        listed[start[r]:start[r] + count[r]] = True
    assert np.all(src[listed] >= 0) and np.all(src[~listed] == -1)
    assert torch.all(torch.isinf(xl.w[torch.from_numpy(~listed)]))


def _check_lists(plan) -> None:
    """Both directions' lists: their layout, and expanded back the plan's
    dense planes bit for bit."""
    for name in ("down", "up"):
        lanes, xl = getattr(plan, f"xlanes_{name}"), getattr(plan, f"xlist_{name}")
        assert lanes and xl is not None
        planes = getattr(plan, f"x{name}")
        _check_layout(xl, plan.n_rows, plan.n_cols_pad, lanes)
        assert torch.equal(xl.dense(len(lanes), plan.n_cols_pad), planes)


def test_plan_lists_expand_to_the_dense_planes():
    """The plan's lists hold its lanes' edges (its slot maps), a small
    share of its lane slots, and expand back to xdown / xup bit for bit;
    the padded problem's lists too, their rows past the plan's empty."""
    *_, tplan = _case()
    assert {sel for sel, _ in tplan.xlanes_down + tplan.xlanes_up} == {0, 2}
    _check_lists(tplan)
    listed = int((tplan.xlist_down.src >= 0).sum())
    slots = len(tplan.xlanes_down) * tplan.n_rows * tplan.n_cols_pad
    assert 0 < listed < slots // 4
    prob = tbg.prepare_padded(tplan, torch.tensor([3, 500]), rb=5)
    Rp = prob.d0.shape[0]
    assert Rp > tplan.n_rows
    assert torch.equal(prob.xlist_down.dense(len(tplan.xlanes_down), tplan.n_cols_pad),
                       prob.xdown)
    assert torch.equal(prob.xlist_up.rows(3, Rp).goff, prob.xlist_up.goff[3:])
    _check_layout(prob.xlist_up, Rp, tplan.n_cols_pad, tplan.xlanes_up)


def test_transposed_plan_lists_expand_to_its_dense_planes():
    """transpose_banded_plan's lists: the original's edges transposed by
    the same rule as the planes (lanes |dr_t| > 2 left out)."""
    *_, tplan = _case()
    pt = tbg.transpose_banded_plan(tplan)
    _check_lists(pt)
    n_t = sum(int((getattr(pt, f"xlist_{n}").src >= 0).sum()) for n in ("down", "up"))
    n_o = sum(int((getattr(tplan, f"xlist_{n}").src >= 0).sum()) for n in ("down", "up"))
    assert 0 < n_t <= n_o


def test_shard_lists_expand_to_the_shard_planes():
    """Each row shard's lists (ghost rows included) expand to its planes."""
    *_, tplan = _case()
    splan = build_sharded_banded_plan(tplan, 3)
    for name in ("down", "up"):
        lanes = getattr(splan, f"xlanes_{name}")
        lists = getattr(splan, f"xlist_{name}")
        assert len(lists) == 3
        for k, xl in enumerate(lists):
            _check_layout(xl, splan.rp_local, splan.n_cols_pad, lanes)
            assert torch.equal(xl.dense(len(lanes), splan.n_cols_pad),
                               getattr(splan, f"x{name}")[k])


@pytest.mark.parametrize("how", ["from_costs", "rows", "weights"])
def test_refreshed_lists_equal_a_fresh_build(how):
    """After each refresh the lists keep their edges (lethal ones at +inf)
    and take the new weights: equal to lists built afresh from the
    refreshed plan's static tables and planes, and expanded back its
    planes bit for bit; from a slot-weight table, equal to a fresh plan's.
    The row-windowed refresh changes five rows' costs (its slab branch)."""
    jm, tm, costs, W, _, tplan = _case()
    new = _new_costs(costs)
    kw = dict(edge_cost_factor=1.0, cost_limit=COST_LIMIT)
    if how == "from_costs":
        ref = tbg.refresh_banded_planes_from_costs(tplan, torch.from_numpy(new), **kw)
    elif how == "rows":
        band = costs.copy()
        band[256:416] = new[256:416]
        ref = tbg.refresh_banded_planes_rows(tplan, torch.from_numpy(costs),
                                             torch.from_numpy(band), row_window=16, **kw)
    else:
        W2 = jsweeps.slot_weights_np(jm, new, cost_limit=COST_LIMIT, edge_cost_factor=1.0)
        ref = tbg.refresh_banded_planes(tplan, W2)
        fresh_plan = tbg.build_banded_kernel_plan(tm, W2)
        for name in ("down", "up"):
            a, b = getattr(ref, f"xlist_{name}"), getattr(fresh_plan, f"xlist_{name}")
            assert torch.equal(a.goff, b.goff) and torch.equal(a.meta, b.meta)
            assert torch.equal(a.w, b.w)
    fresh = tbg.with_xlane_lists(ref)
    for name in ("down", "up"):
        got, want = getattr(ref, f"xlist_{name}"), getattr(fresh, f"xlist_{name}")
        old = getattr(tplan, f"xlist_{name}")
        assert torch.equal(got.goff, old.goff) and torch.equal(got.meta, old.meta)
        assert torch.equal(got.goff, want.goff) and torch.equal(got.meta, want.meta)
        assert torch.equal(got.w, want.w)
        assert not torch.equal(got.w, old.w)
        assert bool(torch.isinf(got.w[got.src >= 0]).any())     # a lethal edge, still listed
    _check_lists(ref)


def test_refresh_banded_planes_matches_reference():
    """refresh_banded_planes from a new [V, D] slot-weight table against the
    reference's: the gathered planes (down, up, the laterals, xdown, xup,
    res_w) bit for bit, the chain weights within one ulp; and every plane
    equal to a fresh port build from the same table."""
    jm, tm, costs, W, jplan, tplan = _case()
    W2 = jsweeps.slot_weights_np(jm, _new_costs(costs), cost_limit=COST_LIMIT,
                                 edge_cost_factor=1.0)
    jp = jpb.refresh_banded_planes(jplan, jnp.asarray(W2))
    tp = tbg.refresh_banded_planes(tplan, torch.from_numpy(W2))
    for k in ("down", "up", "lat_fwd", "lat_bwd", "xdown", "xup", "res_w"):
        np.testing.assert_array_equal(getattr(tp, k).numpy(), np.asarray(getattr(jp, k)), k)
    for k in ("a_fwd", "a_bwd"):
        want, got = np.asarray(getattr(jp, k)), getattr(tp, k).numpy()
        assert np.array_equal(np.isfinite(got), np.isfinite(want)), k
        fin = np.isfinite(want)
        assert np.all(np.abs(got[fin] - want[fin]) <= np.spacing(np.abs(want[fin]))), k
    fresh = tbg.build_banded_kernel_plan(tm, W2)
    for k in ("down", "up", "lat_fwd", "lat_bwd", "a_fwd", "a_bwd", "xdown", "xup", "res_w"):
        assert torch.equal(getattr(tp, k), getattr(fresh, k)), k
    assert not torch.equal(tp.down, tplan.down)
