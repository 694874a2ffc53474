"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu.

The JAX package `paddle_tpu` stays the reference; this package mirrors
its module paths and names. It imports torch and numpy, never jax and
never paddle_tpu. Entry points run on the CUDA card unless the caller
passes `device="cpu"`. Every TPU (Pallas) kernel on a ported path is a
hand-written Hopper kernel here (`ops/csrc/`), built from the sources
at first use (`ops/_build.py`).
"""
from . import nn, quantization, regularizer, vision
from .device import cuda_available, get_device

__all__ = ["cuda_available", "get_device", "nn", "quantization",
           "regularizer", "vision"]
