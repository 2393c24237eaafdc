"""The frozen byte and operation counts equal chip_smoke.py's at the main
path's and the irregular path's shapes."""

import pytest

import chip_smoke as cs
from conftest import ROOT  # noqa: F401
from navbench import counts

MAIN = (1024, 1024, 1024)       # chip_smoke's main path field [Rp, Cp, Bp]
IRREGULAR = (1024, 1024, 512)   # its irregular path's


def test_peaks_and_operation_counts_are_chip_smokes():
    assert counts.HBM_BYTES_PER_S == cs.HBM_BYTES_PER_S
    assert counts.F32_OPS_PER_S == cs.F32_OPS_PER_S
    assert (counts.PASS_OPS, counts.PRED_OPS, counts.XLANE_OPS) == \
        (cs.PASS_OPS, cs.PRED_OPS, cs.XLANE_OPS)


@pytest.mark.parametrize("shape", [MAIN, IRREGULAR])
@pytest.mark.parametrize("written", [0, 12345])
def test_main_pass_bytes(shape, written):
    Rp, Cp, Bp = shape
    N = Rp * Cp * Bp
    # kernels_at_main_shapes
    assert counts.pass_bytes(Rp, Cp, Bp, written=written) == (N + 5 * Rp * Cp + written) * 4
    assert counts.pass_ops(Rp, Cp, Bp) == cs.PASS_OPS * N


@pytest.mark.parametrize("shape", [MAIN, IRREGULAR])
def test_extended_lane_pass_counts(shape):
    Rp, Cp, Bp = shape
    N, nb = Rp * Cp * Bp, Bp // 8
    xbytes, xedges, written = 4 * 1024 * 40 + 8 * 161128, 161128, 777
    # kernels_at_irregular_shapes: ((Rp Cp Bp + 2 nb Rp + n_written) * 4 + planes)
    want = (N + 2 * nb * Rp + written) * 4 + 5 * Rp * Cp * 4 + xbytes
    assert counts.pass_bytes(Rp, Cp, Bp, written=written, dirty=True, xlist_bytes=xbytes) == want
    assert counts.pass_ops(Rp, Cp, Bp, xlist_edges=xedges) == \
        cs.PASS_OPS * N + cs.XLANE_OPS * xedges * Bp


@pytest.mark.parametrize("shape", [MAIN, IRREGULAR])
def test_class_pred_counts(shape):
    Rp, Cp, Bp = shape
    N, V = Rp * Cp * Bp, 1024 * 1024
    assert counts.pred_bytes(Rp, Cp, Bp, V) == N * 4 + V * Bp + 8 * Rp * Cp * 4
    assert counts.pred_ops(Rp, Cp, Bp) == cs.PRED_OPS * N
    bound = max((N * 4 + V * Bp + 8 * Rp * Cp * 4) / cs.HBM_BYTES_PER_S,
                cs.PRED_OPS * N / cs.F32_OPS_PER_S)
    assert counts.pred_bound_s(Rp=Rp, Cp=Cp, Bp=Bp, V=V, launches=3) == pytest.approx(3 * bound)


def test_solve_bound_counts_main_launches_and_a_write_of_every_label():
    Rp, Cp, Bp = MAIN
    V, B = 1024 * 1024, 1024
    full = max((Rp * Cp * Bp + 5 * Rp * Cp) * 4 / cs.HBM_BYTES_PER_S,
               cs.PASS_OPS * Rp * Cp * Bp / cs.F32_OPS_PER_S)
    writes = V * B * 4 / cs.HBM_BYTES_PER_S
    got = counts.solve_pass_bound_s(Rp=Rp, Cp=Cp, Bp=Bp, V=V, B=B, steps=2, launches=8)
    assert got == pytest.approx(8 * full + 2 * writes)
