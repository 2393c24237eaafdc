"""Build and bind the hand-written Hopper kernels in mesh_navigation_torch/csrc.

Each `.cu` file is compiled by `nvcc` for sm_90a into its own shared library
with a plain C interface (build/kernels/lib<name>.so) and bound with ctypes.
All sources are compiled in parallel, one `nvcc` per source, on first use.
Nothing is built while a module is imported.

`LAUNCHES` counts the launches of each kernel; the wrappers in
ops/banded_gpu.py add one where they launch and nowhere else.
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
}
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
LAUNCHES: dict[str, int] = {name: 0 for name in SOURCES}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_SIGNATURES = {
    "banded_pass": ("banded_pass_launch",
                    [_P, _P, _P, _L, _P, _L, _P, _I, _I, _I, _I, _I, _F, _F, _P]),
    "class_pred": ("class_pred_launch",
                   [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _F, _F, _P]),
}


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
                    lambda out, s=src_path: [nvcc, *NVCC_FLAGS, "-o", out, s], lib
                )
        logs = {}
        deadline = time.monotonic() + timeout
        for name, (proc, tmp) in started.items():
            logs[name] = buildutil.finish_build(
                proc, tmp, _lib_path(name),
                timeout=max(1.0, deadline - time.monotonic()),
            )
        for name in SOURCES:
            lib = ctypes.CDLL(_lib_path(name))
            fn_name, argtypes = _SIGNATURES[name]
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _libs[name] = lib
        return logs


def launcher(name: str):
    """The C launch function of kernel `name`, building on first use."""
    if name not in _libs:
        build_all()
    return getattr(_libs[name], _SIGNATURES[name][0])


def check(name: str, err: int) -> None:
    """Raise if a launch returned a CUDA error (cudaGetLastError)."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
