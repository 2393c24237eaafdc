"""The readers of the program's own counts and span (navbench/counters.py)
on hand-made traced records: their values, and None where the window has
nothing to read (counters at zero, passes not all dirty-driven, or a
program without the counters and span, whose record leaves them out)."""

import pytest

from conftest import ROOT
from navbench import spec

METRICS = ("walk_steps.grid", "walk_lane_use.grid", "walk_step_us.grid",
           "dirty_rows_share.scanned", "dirty_row_ns.scanned", "residual_ms.scanned")
WALKER = "void_banded_pass_kernel_float__true__4__t"
PRESCAN = "void_banded_prescan_kernel_float__false__"


def record(**launches) -> dict:
    """A traced window of 4 steps on a [1024, 1024, 4096] field with 4,096
    lanes: 2 ms of walker and 1 ms of prescan kernel time, an extract
    stage of 400 ms and a residual span of 60 ms."""
    return {"kind": "fleet", "steps": 4, "rounds": [70] * 4,
            "stages_ms": {"extract": 400.0, "solve": 900.0, "solve/residual": 60.0},
            "kernels": [(0, 2_000_000, WALKER), (2_000_000, 3_000_000, PRESCAN)],
            "window_s": 1.0, "busy_s": 0.5, "launches": dict(launches),
            "shape": {"Rp": 1024, "Cp": 1024, "Bp": 4096, "V": 1 << 20, "B": 4096}}


def read(name: str, trace: dict):
    return spec.reader(name, ROOT)(trace)


def test_the_readers_values():
    tr = record(walk_steps=4 * 1024, walk_lane_steps=2 * 1024 * 4096, banded_pass=10,
                banded_pass_dirty=10, banded_pass_rows=512 * 1024 * 5)
    assert read("walk_steps.grid", tr) == 1024
    assert read("walk_lane_use.grid", tr) == 0.5
    assert read("walk_step_us.grid", tr) == pytest.approx(400e3 / 4096)
    assert read("dirty_rows_share.scanned", tr) == 0.5
    assert read("dirty_row_ns.scanned", tr) == pytest.approx(2e6 / (512 * 1024 * 5))
    assert read("residual_ms.scanned", tr) == 15.0


@pytest.mark.parametrize("launches", [
    {},                                                      # a program without them
    dict(walk_steps=0, walk_lane_steps=0, banded_pass=10, banded_pass_dirty=10,
         banded_pass_rows=0),                                # counted nothing
])
def test_nothing_to_read_gives_none(launches):
    tr = record(**launches)
    del tr["stages_ms"]["solve/residual"]
    for name in METRICS:
        assert read(name, tr) is None, name


def test_mixed_launches_give_no_dirty_row_metrics():
    """Main-mode launches beside the dirty ones walk rows no dirty table
    chose: neither dirty-row metric reads the window."""
    tr = record(banded_pass=12, banded_pass_dirty=10, banded_pass_rows=1000)
    assert read("dirty_rows_share.scanned", tr) is None
    assert read("dirty_row_ns.scanned", tr) is None


def test_lane_use_needs_the_live_lane_count():
    """Without a timer the walk counts its steps and not the live lanes."""
    tr = record(walk_steps=4096)
    assert read("walk_steps.grid", tr) == 1024 and read("walk_step_us.grid", tr) is not None
    assert read("walk_lane_use.grid", tr) is None


def test_each_new_metric_reads_in_its_one_cell():
    bench = spec.benchmark(ROOT)
    for name in METRICS:
        m = next(m for m in bench["per_layer"] if m["name"] == name)
        cell = "grid1m.fleet4096" if name.endswith(".grid") else "irregular1m.fleet4096"
        assert m["workloads"] == [cell] and m["source"] in ("program_counter", "program_span")
