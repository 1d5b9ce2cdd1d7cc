"""Hopper kernel tier: hand-written CUDA kernels, built at first use."""
