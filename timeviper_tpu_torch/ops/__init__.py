"""Ops of the port: plain PyTorch versions and the CUDA kernel wrappers."""
