"""Per-stage timing of the planning path.

On a CUDA device a stage is timed with a pair of CUDA events recorded on the
current stream, so timing adds no host synchronisation; the elapsed times
are read once, in `totals()`, after a synchronise. On the CPU the host clock
is used. A stage entered several times accumulates.
"""

from __future__ import annotations

import contextlib
import time

import torch


def stage(timer: "StageTimer | None", name: str):
    """`timer.stage(name)`, or a no-op context when there is no timer."""
    return timer.stage(name) if timer is not None else contextlib.nullcontext()


class StageTimer:
    def __init__(self, device: torch.device | str):
        self.device = torch.device(device)
        self._events: dict[str, list] = {}
        self._host: dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
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
        """Milliseconds per stage (device time on CUDA)."""
        out = dict(self._host)
        if self._events:
            torch.cuda.synchronize(self.device)
            for name, pairs in self._events.items():
                out[name] = out.get(name, 0.0) + sum(
                    s.elapsed_time(e) for s, e in pairs
                )
        return out
