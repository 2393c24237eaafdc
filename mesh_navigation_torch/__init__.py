"""mesh_navigation_torch — the PyTorch/CUDA port of mesh_navigation_tpu.

A second package beside the JAX reference, mirroring its sub-layout (mesh/,
ops/, layers/, planners/, control/, api/, utils/, native/ and the CLI,
`python -m mesh_navigation_torch`), so each module's reference sits at the
same relative path. Plain code is PyTorch and numpy; the solvers' five
kernels, one for each Pallas kernel of the reference, are hand-written CUDA
for Hopper (csrc/). Entry points run on the card unless the caller passes
device="cpu" (the CLI: --device cpu).
"""

__version__ = "0.1.0"
