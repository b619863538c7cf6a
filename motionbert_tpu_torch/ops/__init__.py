"""Pair kernels (CUDA) and their plain PyTorch versions."""
