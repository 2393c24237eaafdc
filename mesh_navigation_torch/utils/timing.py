"""Timing: the planning path's stages and the LayerTimer CSV contract
(port of mesh_navigation_tpu/utils/timing.py).

StageTimer: on a CUDA device a stage is timed with a pair of CUDA events
recorded on the current stream, so timing adds no host synchronisation; the
elapsed times are read once, in `totals()`, after a synchronise. On the CPU
the host clock is used. A stage entered several times accumulates.

The LayerTimer contract (timer.h:54-107, timer.cpp:22-49): an explicitly
enabled process-wide switch that appends
`timestamp;name;lock_ns;update_ns;notify_ns` rows to a CSV file (default
`layer_timings.csv`); the three durations are host preparation, device
compute and post-processing. `timed_update` synchronises the card before it
reads the clock. `torch_profile` (in place of the reference's jax_profile)
captures a torch.profiler trace of a region; PhaseTimer collects the
planners' phase breakdown.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import torch

_enabled = False
_path = "layer_timings.csv"


def enable(path: str = "layer_timings.csv") -> None:
    """LayerTimer::enable (timer.cpp:22-30): the opt-in switch
    (`mesh_map.enable_layer_timer`, mesh_map.cpp:125-129)."""
    global _enabled, _path
    _enabled = True
    _path = path


def disable() -> None:
    global _enabled
    _enabled = False


def enabled() -> bool:
    return _enabled


def record_update_duration(name: str, prep_ns: int, update_ns: int, post_ns: int) -> None:
    """Append one row (timer.cpp:40-48 format) when the timer is enabled."""
    if not _enabled:
        return
    with open(_path, "a") as fh:
        fh.write(f"{time.time_ns()};{name};{prep_ns};{update_ns};{post_ns}\n")


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def timed_update(name: str) -> Iterator[None]:
    """Time the wrapped region, the card's work included, and append a row
    when the timer is enabled."""
    if not _enabled:
        yield
        return
    _sync()
    t0 = time.perf_counter_ns()
    yield
    _sync()
    t1 = time.perf_counter_ns()
    record_update_duration(name, 0, t1 - t0, 0)


@contextlib.contextmanager
def torch_profile(logdir: str) -> Iterator[str]:
    """Capture a torch.profiler trace (host and, with a card, CUDA activity)
    of the wrapped region into `logdir` as a Chrome trace file."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield logdir
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class PhaseTimer:
    """Per-plan phase breakdown (init / propagation / vector field /
    backtracking) -- the steady_clock instrumentation of both planners
    (dijkstra_mesh_planner.cpp:377-394, cvp_mesh_planner.cpp:953-960),
    collected as a dict. `mark(name, sync=x)` with any x (the reference
    passes the array it waits for) waits for the card first."""

    def __init__(self):
        self.phases: dict[str, float] = {}
        self._t = time.perf_counter()

    def mark(self, name: str, sync=None) -> None:
        if sync is not None:
            _sync()
        now = time.perf_counter()
        self.phases[name] = self.phases.get(name, 0.0) + (now - self._t)
        self._t = now

    def summary(self) -> str:
        return ", ".join(f"{k}: {v*1e3:.1f}ms" for k, v in self.phases.items())


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
