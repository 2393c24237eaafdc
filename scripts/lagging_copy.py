"""Lagging copies of the port's CUDA kernels, for the stress scripts
(scripts/*_stress.py).

A copy is the kernel's source with `__nanosleep` calls put in as text just
before its handoffs (a wait on a barrier, a ring slot's refill, a progress
word), so that some warps or blocks reach each handoff ~80 us after the
others, and with its wait assertions cut to ~2 s of the SM's cycles. It is
built by nvcc with the kernel's own flags into
mesh_navigation_torch/build/stress/, outside the package's sources, and
launched through the kernel's own wrapper by swapping the loaded library
for the copy's. The shipped sources hold no sleep.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import os
import subprocess
import sys
import time
import traceback

sys.path.insert(0, os.getcwd())
from mesh_navigation_torch import buildutil  # noqa: E402
from mesh_navigation_torch.device import nvcc_path  # noqa: E402
from mesh_navigation_torch.ops import kernels  # noqa: E402

LAG_NS = 80_000


def lag(cond: str) -> str:
    """A line of CUDA that sleeps ~80 us where `cond` holds."""
    return f"if ({cond}) __nanosleep({LAG_NS});\n"


def patched_source(name: str, patches: list[tuple[str, str]], replace: tuple = ()) -> str:
    """Kernel `name`'s source with each (anchor, text) of `patches` put in
    before every occurrence of its anchor and each (old, new) of `replace`
    replaced; raises if an anchor is missing."""
    src = os.path.join(buildutil.CSRC_DIR, kernels.SOURCES[name])
    with open(src) as fh:
        text = fh.read()
    for anchor, new in [*((a, x + a) for a, x in patches), *replace]:
        if anchor not in text:
            raise RuntimeError(f"{name}: no {anchor!r} in {src}")
        text = text.replace(anchor, new)
    return text


def build(name: str, patches: list[tuple[str, str]], replace: tuple = (),
          tag: str = "lag") -> ctypes.CDLL:
    """Compile patched_source(name, patches, replace) and bind it. Raises
    if an anchor is missing or the build fails."""
    text = patched_source(name, patches, replace)
    out_dir = os.path.join(buildutil.BUILD_DIR, "stress")
    os.makedirs(out_dir, exist_ok=True)
    cu = os.path.join(out_dir, f"{name}_{tag}.cu")
    lib = os.path.join(out_dir, f"lib{name}_{tag}.so")
    with open(cu, "w") as fh:
        fh.write(text)
    nvcc = nvcc_path()
    if nvcc is None:
        raise RuntimeError("nvcc not found: cannot build the lagging copy")
    cmd = [nvcc, *kernels.NVCC_FLAGS, *kernels.EXTRA_FLAGS.get(name, []), "-o", lib, cu]
    done = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if done.returncode != 0:
        raise RuntimeError(f"build of the lagging copy of {name} failed:\n{done.stdout}{done.stderr}")
    return kernels.bind(name, lib)


@contextlib.contextmanager
def swapped(name: str, lib: ctypes.CDLL):
    """Launch kernel `name` from `lib` inside the block."""
    kernels.build_all()
    shipped = kernels._libs[name]
    kernels._libs[name] = lib
    try:
        yield
    finally:
        kernels._libs[name] = shipped


def run_launches(launch, check, n: int, every: int) -> dict:
    """`launch()` n times; `check(result)` (True when equal to the plain
    version) on the first, the last and every `every`-th. Synchronises at
    the end; returns the launches, the results held, whether all were equal
    and ms a launch with the copies the caller makes."""
    import torch

    ok, held = True, 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        out = launch()
        if i == 0 or i == n - 1 or i % every == 0:
            ok &= bool(check(out))
            held += 1
    torch.cuda.synchronize()
    return {"launches": n, "held_against_plain": held, "equal_to_plain": ok,
            "ms_per_launch_with_copies": (time.perf_counter() - t0) * 1e3 / n}


def report(kernel: str, cases: dict, failed: str | None = None) -> int:
    """Print one JSON line; 0 when nothing failed and every run of every
    case held."""
    ok = failed is None and all(run["equal_to_plain"] for case in cases.values()
                                for run in case.values())
    print(json.dumps({"kernel": kernel, "lag_ns": LAG_NS, "cases": cases, "failed": failed,
                      "held": ok}), flush=True)
    return 0 if ok else 1


def main(kernel: str, run) -> int:
    """Run `run(cases)` (which fills `cases` as it goes) and report; a
    failed launch (a device assertion leaves the CUDA context unusable) is
    printed with its traceback, and the process leaves at once."""
    cases: dict = {}
    try:
        run(cases)
    except Exception:
        traceback.print_exc()
        report(kernel, cases, traceback.format_exc(limit=1))
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
    return report(kernel, cases)
