"""Histogram ops and their hand-written CUDA kernels."""
