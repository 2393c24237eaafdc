"""The card's two clocks against the host's: what a device-side timeout may count.

A kernel's timeout can count %globaltimer (nanoseconds) or clock64 (the
SM's cycles). This script launches, `--launches` times, one thread that
spins for `--cycles` SM cycles reading both, and prints one JSON object:
- `globaltimer_minus_host_realtime_ns`: %globaltimer at a launch's first
  read less the host's time.time_ns() just before the launch (min, max).
  Near 0 means %globaltimer follows the host's wall clock, so a step of
  that clock moves it;
- `globaltimer_max_step_ns`: the largest step between two consecutive
  reads of %globaltimer inside a launch;
- `globaltimer_over_host_monotonic`: %globaltimer's elapsed time over all
  launches against the host's monotonic clock's;
- `sm_clock_ghz`: clock64 cycles over %globaltimer's nanoseconds;
- `host_realtime_minus_monotonic_change_ns`: how far the host's wall clock
  moved against its monotonic clock during the run.

Usage (a CUDA card and nvcc): python3 tests/device_clock_probe.py
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SOURCE = r"""
#include <cuda_runtime.h>
__global__ void probe(long long cycles, unsigned long long* out) {
  unsigned long long g0, g, prev, step = 0;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g0));
  const long long c0 = clock64();
  prev = g0;
  long long c = c0;
  while (c - c0 < cycles) {
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g));
    if (g - prev > step) step = g - prev;
    prev = g;
    c = clock64();
  }
  out[0] = g0; out[1] = prev; out[2] = step; out[3] = (unsigned long long)(c - c0);
}
extern "C" int probe_run(long long cycles, unsigned long long* host_out) {
  unsigned long long* d = nullptr;
  cudaError_t err = cudaMalloc(&d, 4 * sizeof(unsigned long long));
  if (err != cudaSuccess) return (int)err;
  probe<<<1, 1>>>(cycles, d);
  err = cudaMemcpy(host_out, d, 4 * sizeof(unsigned long long), cudaMemcpyDeviceToHost);
  cudaFree(d);
  return (int)err;
}
"""


def build():
    from mesh_navigation_torch import buildutil
    from mesh_navigation_torch.device import nvcc_path

    nvcc = nvcc_path()
    if nvcc is None:
        raise SystemExit("device_clock_probe: nvcc not found")
    out_dir = os.path.join(buildutil.BUILD_DIR, "probe")
    os.makedirs(out_dir, exist_ok=True)
    src, lib = os.path.join(out_dir, "clock_probe.cu"), os.path.join(out_dir, "libclock_probe.so")
    with open(src, "w") as fh:
        fh.write(SOURCE)
    proc, tmp = buildutil.start_build(
        lambda o: [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-shared",
                   "-Xcompiler", "-fPIC", "-o", o, src], lib)
    buildutil.finish_build(proc, tmp, lib, timeout=300.0)
    so = ctypes.CDLL(lib)
    so.probe_run.argtypes = [ctypes.c_longlong, ctypes.c_void_p]
    so.probe_run.restype = ctypes.c_int
    return so


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--launches", type=int, default=40)
    ap.add_argument("--cycles", type=int, default=1_000_000_000)
    args = ap.parse_args()
    so = build()
    buf = (ctypes.c_ulonglong * 4)()
    offsets, steps, ratios = [], [], []
    drift0 = time.time_ns() - time.monotonic_ns()
    m0, g_first, g_last = time.monotonic_ns(), None, None
    for _ in range(args.launches):
        rt = time.time_ns()
        err = so.probe_run(args.cycles, ctypes.addressof(buf))
        if err:
            raise SystemExit(f"device_clock_probe: CUDA error {err}")
        g0, g1, step, cyc = (int(x) for x in buf)
        g_first = g0 if g_first is None else g_first
        g_last = g1
        offsets.append(g0 - rt)
        steps.append(step)
        ratios.append(cyc / max(1, g1 - g0))
    m1 = time.monotonic_ns()
    drift1 = time.time_ns() - time.monotonic_ns()
    print(json.dumps({
        "launches": args.launches, "cycles_per_launch": args.cycles,
        "globaltimer_minus_host_realtime_ns": [min(offsets), max(offsets)],
        "globaltimer_max_step_ns": max(steps),
        "globaltimer_over_host_monotonic": (g_last - g_first) / (m1 - m0),
        "sm_clock_ghz": [min(ratios), max(ratios)],
        "host_realtime_minus_monotonic_change_ns": drift1 - drift0,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
