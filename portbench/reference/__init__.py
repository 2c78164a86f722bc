"""Plain PyTorch / NumPy reference of the benchmark: the inputs, the
yardstick and the output check's comparison. Imports nothing of the port
and no JAX."""
