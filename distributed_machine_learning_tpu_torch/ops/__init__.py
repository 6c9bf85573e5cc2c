"""Numeric ops of the port: attention primitives and the CUDA kernels."""
