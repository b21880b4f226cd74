"""Kernels of the PyTorch port: hand-written CUDA for Hopper beside their
plain PyTorch versions (counterpart of ``repro.kernels``)."""
