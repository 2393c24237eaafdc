"""What the readers of the program's own counts and spans share: the
walk's and the solve's counters in ops/kernels.LAUNCHES ("walk_steps",
"walk_lane_steps", "banded_pass_rows", in the traced record's `launches`)
and the residual scatter-min's span "solve/residual" (in `stages_ms`).
Each reader takes the traced run's record (harness.Setup.trace) and returns
a number, or None where the window has nothing to read: a program without
these counters and span leaves them out of the record."""

from __future__ import annotations

from . import readings

PASS_BLOCK_LANES = 8      # the lanes of one block of csrc/banded_pass.cu
WALKER = ("banded_pass_kernel",)   # the pass's walker, not its prescan


def walk_steps(trace: dict) -> float | None:
    """The steps the path walk ran, a step of the window."""
    n = trace["launches"].get("walk_steps", 0)
    return n / trace["steps"] if n and trace["steps"] else None


def walk_lane_use(trace: dict) -> float | None:
    """The share of the walk's lane-steps in which the lane still walked."""
    n = trace["launches"].get("walk_steps", 0)
    live = trace["launches"].get("walk_lane_steps", 0)
    return live / (n * trace["shape"]["B"]) if n and live else None


def walk_step_us(trace: dict) -> float | None:
    """The extract stage's microseconds over the steps the walk ran."""
    n = trace["launches"].get("walk_steps", 0)
    ms = trace["stages_ms"].get("extract")
    return 1e3 * ms / n if n and ms is not None else None


def _dirty_rows(trace: dict) -> tuple[int, int] | None:
    """(rows the pass's blocks walked, launches), where every launch of the
    pass in the window was dirty-driven and the rows were counted."""
    la = trace["launches"]
    rows, n = la.get("banded_pass_rows", 0), la.get("banded_pass_dirty", 0)
    if not rows or not n or n != la.get("banded_pass", 0):
        return None
    return rows, n


def dirty_rows_share(trace: dict) -> float | None:
    """The rows a dirty launch walked over the rows it could walk: every
    (8-lane block, row) pair of the field, each launch."""
    got = _dirty_rows(trace)
    if got is None:
        return None
    rows, n = got
    sh = trace["shape"]
    return rows / (n * (sh["Bp"] // PASS_BLOCK_LANES) * sh["Rp"])


def dirty_row_ns(trace: dict) -> float | None:
    """The walker kernel's ns a walked (block, row) pair, where every launch
    was dirty-driven."""
    got, s = _dirty_rows(trace), readings.kernel_s(trace, WALKER)
    return 1e9 * s / got[0] if got is not None and s else None


def residual_ms(trace: dict) -> float | None:
    """The residual scatter-min's ms a step (a part of the solve stage)."""
    return readings.stage_ms(trace, ("solve/residual",))
