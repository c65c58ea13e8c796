"""TimeViper on PyTorch and CUDA: the port of the JAX package `timeviper_tpu`
to one NVIDIA H100, with hand-written Hopper kernels for the TPU kernels on
its path (csrc/). It imports `torch`, never `jax`; of the JAX package it uses
only the JAX-free `timeviper_tpu.config` and `timeviper_tpu.data.fusion`."""
