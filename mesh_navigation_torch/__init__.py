"""mesh_navigation_torch — the PyTorch/CUDA port of mesh_navigation_tpu.

A second package beside the JAX reference, mirroring its sub-layout (mesh/,
ops/, planners/, control/, api/, native/), so each module's reference sits at
the same relative path. Plain code is PyTorch and numpy; the solver's two
kernels are hand-written CUDA for Hopper (csrc/). Entry points run on the
card unless the caller passes device="cpu".
"""

__version__ = "0.1.0"
