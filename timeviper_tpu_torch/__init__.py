"""TimeViper on PyTorch and CUDA: the port of the JAX package `timeviper_tpu`
to one NVIDIA H100, with hand-written Hopper kernels for the TPU kernels on
its paths (csrc/). It imports `torch`, never `jax`, and nothing of the JAX
package, not even its JAX-free modules: what it needs of them it keeps in
its own copies (config.py, data/fusion.py)."""
