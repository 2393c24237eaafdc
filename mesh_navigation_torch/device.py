"""Device resolution and the GPU kernel probe.

Replaces `pallas_available()` (mesh_navigation_tpu/ops/pallas_sweep.py:31-37).
Entry points run on the card unless the caller asks for the CPU: a missing
CUDA device is an error, never a silent fall back to the CPU. Which code a
kernel wrapper runs is decided by the device of the tensor it is given alone
(ops/banded_gpu.py): a CPU tensor takes the plain PyTorch version, a CUDA
tensor launches the hand-written kernel or raises.
"""

from __future__ import annotations

import dataclasses
import os
import shutil

import torch

_CUDA_HOME_NVCC = "/usr/local/cuda/bin/nvcc"


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """`None` means the card. Raise when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "mesh_navigation_torch: no CUDA device is available; pass "
            "device='cpu' to run the plain PyTorch versions on the CPU"
        )
    return dev


def nvcc_path() -> str | None:
    found = shutil.which("nvcc")
    if found:
        return found
    return _CUDA_HOME_NVCC if os.path.exists(_CUDA_HOME_NVCC) else None


@dataclasses.dataclass(frozen=True)
class KernelProbe:
    cuda_device: bool
    device_name: str | None
    capability: tuple[int, int] | None
    nvcc: str | None

    @property
    def sm90(self) -> bool:
        return self.capability == (9, 0)

    @property
    def ready(self) -> bool:
        """True when the hand-written Hopper kernels can be built and run."""
        return self.cuda_device and self.sm90 and self.nvcc is not None


def probe() -> KernelProbe:
    """Report the card, its compute capability and `nvcc` on the path."""
    if not torch.cuda.is_available():
        return KernelProbe(False, None, None, nvcc_path())
    return KernelProbe(
        True,
        torch.cuda.get_device_name(0),
        tuple(torch.cuda.get_device_capability(0)),
        nvcc_path(),
    )
