"""Benchmark of the PyTorch + CUDA port (see `portbench/run.py`)."""
