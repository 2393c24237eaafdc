"""Timing: the planning path's stages and the spans inside them.

StageTimer: on a CUDA device a stage is timed with a pair of CUDA events
recorded on the current stream, so timing adds no host synchronisation; the
elapsed times are read once, in `totals()`, after a synchronise. On the CPU
the host clock is used. A stage entered several times accumulates.

Stages do not overlap one another. A span is a part of a stage, named
`<stage>/<part>` (the residual scatter-min of the solve is
"solve/residual"): it is timed the same way and shows in `totals()` under
its own name, and the enclosing stage's total still holds its time. A
subclass that follows `stage()` (a tracer that keeps each stage's host
interval) sees stages only: `span()` does not go through it.
`stage(timer, name)` and `span(timer, name)` are no-op contexts when there
is no timer.
"""

from __future__ import annotations

import contextlib
import time

import torch


def stage(timer: "StageTimer | None", name: str):
    """`timer.stage(name)`, or a no-op context when there is no timer."""
    return timer.stage(name) if timer is not None else contextlib.nullcontext()


def span(timer: "StageTimer | None", name: str):
    """`timer.span(name)`, or a no-op context when there is no timer."""
    return timer.span(name) if timer is not None else contextlib.nullcontext()


class StageTimer:
    def __init__(self, device: torch.device | str):
        self.device = torch.device(device)
        self._events: dict[str, list] = {}
        self._host: dict[str, float] = {}

    def stage(self, name: str):
        """Time a stage of the planning path; stages do not overlap."""
        return self._timed(name)

    def span(self, name: str):
        """Time a part `<stage>/<part>` of the stage it runs inside."""
        return self._timed(name)

    @contextlib.contextmanager
    def _timed(self, name: str):
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            try:
                yield
            finally:
                end.record()
                self._events.setdefault(name, []).append((start, end))
        else:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self._host[name] = self._host.get(name, 0.0) + (
                    time.perf_counter() - t0
                ) * 1e3

    def totals(self) -> dict[str, float]:
        """Milliseconds per stage and span (device time on CUDA)."""
        out = dict(self._host)
        if self._events:
            torch.cuda.synchronize(self.device)
            for name, pairs in self._events.items():
                out[name] = out.get(name, 0.0) + sum(
                    s.elapsed_time(e) for s, e in pairs
                )
        return out
