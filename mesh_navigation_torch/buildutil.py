"""Shared-library builds for the port's native code.

Libraries go to `mesh_navigation_torch/build/` (listed in .gitignore), never
next to their sources. Each build writes a process-unique temporary file and
renames it into place, so parallel test workers that build at once never load
a half-written library.
"""

from __future__ import annotations

import os
import subprocess

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_PKG_DIR, "build")
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")


def is_stale(src: str, lib: str) -> bool:
    return not os.path.exists(lib) or os.path.getmtime(lib) < os.path.getmtime(src)


def start_build(cmd_for_output, lib: str) -> tuple[subprocess.Popen, str]:
    """Start a compiler process writing to a temporary name beside `lib`.
    `cmd_for_output(path)` returns the argv that writes the library to path."""
    os.makedirs(os.path.dirname(lib), exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    proc = subprocess.Popen(
        cmd_for_output(tmp), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True,
    )
    return proc, tmp


def finish_build(proc: subprocess.Popen, tmp: str, lib: str, timeout: float) -> str:
    """Wait for a build started by start_build; raise with the compiler's
    output if it failed. Returns the compiler's output."""
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise RuntimeError(f"build of {lib} timed out after {timeout} s")
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"build of {lib} failed:\n{out}")
    os.replace(tmp, lib)
    return out
