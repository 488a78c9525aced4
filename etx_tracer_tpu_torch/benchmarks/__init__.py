"""Benchmarks of the port, run on the CUDA card (`micro`: the trace kernels)."""
