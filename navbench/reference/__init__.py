"""The plain reference of the layers the benchmark's cells drive.

NumPy and SciPy only: it imports nothing of the program (the PyTorch
package), nor JAX, nor the JAX package (`imports.py` lists what it imports
and fails otherwise). It reads the map file and the traffic the benchmark
hands to both sides, and works out the costs, the edge weights, the fields,
the walks' costs and the controller's commands again.
"""
