"""Edge weights, the banded plan and the GPU kernels."""
