"""What the per-layer metrics' readers (metrics/<metric>.py) share: each
takes the traced run's record (harness.Setup.trace) and returns a number,
or None where the window has nothing to read."""

from __future__ import annotations

from . import counts

PASS_KERNELS = ("banded_pass_kernel", "banded_prescan_kernel")   # walker and prescan


def stage_ms(trace: dict, stages: tuple[str, ...]) -> float | None:
    """The program's StageTimer ms a step over the named stages."""
    if not trace["steps"] or not any(s in trace["stages_ms"] for s in stages):
        return None
    return sum(trace["stages_ms"].get(s, 0.0) for s in stages) / trace["steps"]


def mean_rounds(trace: dict) -> float | None:
    """The solve loop's rounds a step (the plan results' `rounds`)."""
    return sum(trace["rounds"]) / len(trace["rounds"]) if trace["rounds"] else None


def idle_share(trace: dict) -> float | None:
    """1 - the union of the card's kernel and memory-operation intervals
    over the traced window's wall time."""
    if not trace["kernels"] or trace["window_s"] <= 0:
        return None
    return 1.0 - trace["busy_s"] / trace["window_s"]


def kernel_s(trace: dict, names: tuple[str, ...]) -> float:
    """Seconds of the traced kernels whose names hold one of `names`."""
    return sum(b - a for a, b, name in trace["kernels"] if any(n in name for n in names)) / 1e9


def pass_roofline(trace: dict) -> float | None:
    """banded_pass's share of its roofline in %, where every launch is a
    main-mode launch (a dirty-driven launch's rows depend on data the
    program does not expose: None)."""
    s, n = kernel_s(trace, PASS_KERNELS), trace["launches"].get("banded_pass", 0)
    if not s or not n or trace["launches"].get("banded_pass_dirty", 0):
        return None
    sh = trace["shape"]
    bound = counts.solve_pass_bound_s(Rp=sh["Rp"], Cp=sh["Cp"], Bp=sh["Bp"], V=sh["V"],
                                      B=sh["B"], steps=trace["steps"], launches=n)
    return 100.0 * bound / s


def dirty_pass_ms(trace: dict) -> float | None:
    """banded_pass's ms a launch, where every launch is dirty-driven."""
    s = kernel_s(trace, PASS_KERNELS)
    n = trace["launches"].get("banded_pass_dirty", 0)
    if not s or not n or n != trace["launches"].get("banded_pass", 0):
        return None
    return 1e3 * s / n


def pred_roofline(trace: dict) -> float | None:
    """class_pred's share of its roofline in %: the frozen bound of its
    int8 launches on the field's own shape over their measured time."""
    s, n = kernel_s(trace, ("class_pred_kernel",)), trace["launches"].get("class_pred", 0)
    if not s or not n:
        return None
    sh = trace["shape"]
    return 100.0 * counts.pred_bound_s(Rp=sh["Rp"], Cp=sh["Cp"], Bp=sh["Bp"], V=sh["V"],
                                       launches=n) / s
