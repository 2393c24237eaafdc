"""The traced run's readings: stage spans, the card's kernel intervals and
the idle gaps between them.

`Spans` is the port's `utils.timing.StageTimer` (CUDA events around each
stage the program marks) that also keeps each stage's host interval, so an
idle gap of the card can be put down to what the host was doing then.
`KernelTrace` runs torch.profiler over the window and reads the kernels'
intervals from the raw trace events; `busy_ns` is a frozen copy of
`chip_smoke.device_busy`'s union of those intervals.
"""

from __future__ import annotations

import bisect
import contextlib
import time

HARNESS = "harness"   # host time outside every stage the program marks


def busy_ns(intervals) -> int:
    """Length of the union of (start_ns, end_ns) intervals."""
    busy, end = 0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return int(busy)


def idle_gaps(intervals, t0_ns: int, t1_ns: int) -> list[tuple[int, int]]:
    """The stretches of [t0_ns, t1_ns] that no interval covers."""
    gaps, end = [], t0_ns
    for a, b in sorted(intervals):
        if a > end:
            gaps.append((end, min(a, t1_ns)))
        end = max(end, b)
        if end >= t1_ns:
            break
    if end < t1_ns:
        gaps.append((end, t1_ns))
    return [(a, b) for a, b in gaps if b > a]


def span_at(starts, spans, t_ns: int) -> str:
    """The name of the latest-starting host span (start_ns, end_ns, name)
    that holds t_ns, of spans sorted by start with `starts` their starts;
    HARNESS where none does. The program's stages do not overlap."""
    i = bisect.bisect_right(starts, t_ns) - 1
    return spans[i][2] if i >= 0 and spans[i][1] > t_ns else HARNESS


def top(pairs, n: int = 10) -> list[list]:
    """[[name, seconds], ...]: the n largest of summed (name, seconds)."""
    acc: dict[str, float] = {}
    for name, s in pairs:
        acc[name] = acc.get(name, 0.0) + s
    return [[k, v] for k, v in sorted(acc.items(), key=lambda kv: -kv[1])[:n]]


def make_spans(device):
    """A StageTimer of the port that also records the host interval of each
    stage, on the host's monotonic clock, in `host`."""
    from mesh_navigation_torch.utils.timing import StageTimer

    class Spans(StageTimer):
        def __init__(self, dev):
            super().__init__(dev)
            self.host: list[tuple[int, int, str]] = []

        @contextlib.contextmanager
        def stage(self, name: str):
            t0 = time.perf_counter_ns()
            try:
                with super().stage(name):
                    yield
            finally:
                self.host.append((t0, time.perf_counter_ns(), name))

    return Spans(device)


class KernelTrace:
    """torch.profiler over a block, tracing the card's activity. After the
    block, `kernels` holds (start_ns, end_ns, name) of every kernel and
    memory operation, shifted onto the host's perf_counter_ns clock (the
    offset is taken from a marker kernel launched just after a synchronise),
    and `window` the block's (start_ns, end_ns) on the same clock."""

    def __init__(self, device):
        self.device = device
        self.kernels: list[tuple[int, int, str]] = []
        self.window = (0, 0)

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.marker = torch.zeros(1, device=self.device)
        torch.cuda.synchronize(self.device)
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.synchronize(self.device)
        self.t_mark = time.perf_counter_ns()
        self.marker.add_(1.0)                # the clock marker
        torch.cuda.synchronize(self.device)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        import torch
        from torch.autograd import DeviceType

        torch.cuda.synchronize(self.device)
        t1 = time.perf_counter_ns()
        self.prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        raw = sorted((e.start_ns(), e.end_ns(), e.name())
                     for e in self.prof.profiler.kineto_results.events()
                     if e.device_type() == DeviceType.CUDA)
        self.prof = None
        # the marker is the first device activity after t_mark; it started
        # some microseconds after the launch, which the offset absorbs
        offset = raw[0][0] - self.t_mark if raw else 0
        shifted = [(a - offset, b - offset, name) for a, b, name in raw[1:]]
        self.window = (self.t0, t1)
        self.kernels = [k for k in shifted if k[1] > self.t0]
        return False

    def busy_s(self) -> float:
        t0, t1 = self.window
        return busy_ns([(max(a, t0), min(b, t1)) for a, b, _ in self.kernels
                        if min(b, t1) > max(a, t0)]) / 1e9

    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def breakdown(self, host_spans) -> dict:
        """The device operations that took most time, and the idle time of
        the card summed by the host span it fell in, each at most 10."""
        ops = top(((name[:80], (b - a) / 1e9) for a, b, name in self.kernels))
        t0, t1 = self.window
        gaps = idle_gaps([(a, b) for a, b, _ in self.kernels], t0, t1)
        spans = sorted(host_spans)
        starts = [a for a, _, _ in spans]
        idle = top(((span_at(starts, spans, a), (b - a) / 1e9) for a, b in gaps))
        return {"device_ops": ops, "idle_gaps": idle}
