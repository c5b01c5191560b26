"""Packed mu solver and its hand-written CUDA kernels."""
