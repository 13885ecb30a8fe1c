"""PyTorch/CUDA port of featurematching_tpu for NVIDIA Hopper GPUs.

The JAX package `featurematching_tpu` is the reference this package is held
against; this package imports nothing of it and no JAX. Every TPU kernel on
a ported path is a hand-written CUDA kernel under `csrc/`, built on first use
(`ops/_build.py`), with a plain PyTorch version beside it that CPU tensors
take.
"""
