"""Benchmark of the PyTorch and CUDA port on NVIDIA H100: ``python3 cudabench/run.py``."""
