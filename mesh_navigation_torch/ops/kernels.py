"""Build and bind the hand-written Hopper kernels in mesh_navigation_torch/csrc.

Each `.cu` file is compiled by `nvcc` for sm_90a into its own shared library
with a plain C interface (build/kernels/lib<name>.so) and bound with ctypes.
All sources are compiled in parallel, one `nvcc` per source, on first use.
Nothing is built while a module is imported.

`LAUNCHES` counts the launches of each kernel; the wrappers in
ops/banded_gpu.py, ops/eikonal_gpu.py and ops/sweep_gpu.py add one where
they launch and nowhere else. The pass
kernel's launches in its dirty-table mode (the warm resolve) are also
counted apart, under "banded_pass_dirty"; the class-pred kernel's launches
in its int32-id mode are counted under "class_pred_ids", not "class_pred".
The instantiations and modes of the solver's opt-in options are counted
apart too, beside the kernel's own count: a bfloat16 field under
"<kernel>_bf16" (banded_pass, class_pred and class_pred_ids alike under
"class_pred_bf16", check, fused_sweep), and the pass's partial scan depth,
deferring and unskipped modes under "banded_pass_partial",
"banded_pass_defer" and "banded_pass_noskip".

`LAUNCHES` also counts three events of the solve and the walk
(EVENT_COUNTS), each declared here, so a caller that takes the difference
of two copies finds every key in both:
- "walk_steps": the steps banded_gpu.extract_paths_cls ran. On the CPU, the
  plain loop's chunks run times the chunk, always; on the card, the
  longest lane's walked steps (its valid steps, exact), only when the walk
  is given a timer (the one launch of csrc/walk.cu counts each lane's
  steps, and one reduction and one host read give this count and the
  next; without a timer the card's walk reads nothing back);
- "walk_lane_steps": the steps in which a lane was still walking (valid's
  sum), summed over its lanes, only when the walk is given a timer;
- "banded_pass_rows": the (8-lane block, row) pairs that the pass's blocks
  walked, from the kernel's own count (the plain pass's on the CPU), only
  when banded_gpu.banded_solve_padded is given a timer.
"""

from __future__ import annotations

import ctypes
import os
import threading
import time

from mesh_navigation_torch import buildutil
from mesh_navigation_torch.device import nvcc_path

SOURCES = {
    "banded_pass": "banded_pass.cu",
    "class_pred": "class_pred.cu",
    "check": "check.cu",
    "eik_pass": "eik_pass.cu",
    "fused_sweep": "fused_sweep.cu",
    "walk": "walk.cu",
}
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
# per-source additions: the eikonal pass rounds as its plain PyTorch version
# does only without multiply-add contraction
EXTRA_FLAGS = {"eik_pass": ["--fmad=false"]}
MODE_COUNTS = (
    "banded_pass_dirty", "class_pred_ids", "banded_pass_bf16", "banded_pass_partial",
    "banded_pass_defer", "banded_pass_noskip", "class_pred_bf16", "check_bf16",
    "fused_sweep_bf16",
)
EVENT_COUNTS = ("walk_steps", "walk_lane_steps", "banded_pass_rows")
LAUNCHES: dict[str, int] = {name: 0 for name in (*SOURCES, *MODE_COUNTS, *EVENT_COUNTS)}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_SIGNATURES = {
    "banded_pass": ("banded_pass_launch",
                    [_P, _I, _P, _P, _L, _P, _L, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                     _I, _I, _P, _I, _I, _I, _I, _I, _I, _I, _F, _F, _P]),
    "class_pred": ("class_pred_launch",
                   [_P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _F, _F, _F, _P]),
    "check": ("check_launch", [_P, _I, _P, _P, _I, _I, _I, _F, _F, _P]),
    "eik_pass": ("eik_pass_launch",
                 [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                  _F, _F, _P]),
    "fused_sweep": ("fused_sweep_launch", [_P, _I, _P, _P, _P, _I, _L, _I, _I, _I, _P]),
    "walk": ("walk_launch", [_P, _L, _L, _P, _P, _P, _P, _P, _L, _I, _P, _P, _P, _I, _I, _L, _P]),
}
# launch-shape queries a kernel's library also exports (the first is the
# kernel's default query)
_QUERIES = {"eik_pass": (("eik_pass_grid", [_I, _I, _I, _I, _P]),),
            "banded_pass": (("banded_pass_max_cols", []), ("banded_pass_max_cols_x2", []),
                            ("banded_pass_max_cols_x3", []))}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _lib_path(name: str) -> str:
    return os.path.join(buildutil.BUILD_DIR, "kernels", f"lib{name}.so")


def build_all(timeout: float = 900.0) -> dict[str, str]:
    """Compile every stale kernel source (all at once) and bind the libraries.
    Returns the compiler output of each source built in this call (the
    `-Xptxas -v` register and shared-memory report). Raises on any failure."""
    with _lock:
        if len(_libs) == len(SOURCES):
            return {}
        nvcc = nvcc_path()
        if nvcc is None:
            raise RuntimeError("nvcc not found: cannot build the CUDA kernels")
        started = {}
        for name, src in SOURCES.items():
            src_path = os.path.join(buildutil.CSRC_DIR, src)
            lib = _lib_path(name)
            if buildutil.is_stale(src_path, lib):
                started[name] = buildutil.start_build(
                    lambda out, s=src_path, n=name: [
                        nvcc, *NVCC_FLAGS, *EXTRA_FLAGS.get(n, []), "-o", out, s],
                    lib
                )
        logs = {}
        deadline = time.monotonic() + timeout
        for name, (proc, tmp) in started.items():
            logs[name] = buildutil.finish_build(
                proc, tmp, _lib_path(name),
                timeout=max(1.0, deadline - time.monotonic()),
            )
        for name in SOURCES:
            _libs[name] = bind(name, _lib_path(name))
        return logs


def bind(name: str, path: str) -> ctypes.CDLL:
    """Load a library built from kernel `name`'s source (or a copy of it)
    and declare its launch function and queries."""
    lib = ctypes.CDLL(path)
    for fn_name, argtypes in [_SIGNATURES[name], *_QUERIES.get(name, ())]:
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def launcher(name: str):
    """The C launch function of kernel `name`, building on first use."""
    if name not in _libs:
        build_all()
    return getattr(_libs[name], _SIGNATURES[name][0])


def query(name: str, fn_name: str | None = None):
    """A C launch-shape query of kernel `name` (`fn_name`, default its
    first), building on first use."""
    if name not in _libs:
        build_all()
    return getattr(_libs[name], fn_name or _QUERIES[name][0][0])


def check(name: str, err: int) -> None:
    """Raise if a launch returned a CUDA error (cudaGetLastError)."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
