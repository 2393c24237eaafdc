"""The benchmark of the PyTorch and CUDA port (mesh_navigation_torch):
`python3 navbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>`."""
