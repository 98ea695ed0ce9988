"""PyTorch/CUDA port of tomatis_tpu: the standard Tomatis processor on an
NVIDIA H100 (sm_90a), held against the JAX package as its reference.

Imports torch, numpy and the standard library only; never jax and nothing
of tomatis_tpu.
"""
