"""Layers, functionals, initializers and gradient clipping of the GPT
training path (counterpart of `paddle_tpu/nn`)."""
from . import functional, initializer
from .clip import ClipGradByGlobalNorm
from .initializer import Constant, Normal
from .layer import Dropout, Embedding, LayerList, LayerNorm, Linear

__all__ = ["functional", "initializer", "ClipGradByGlobalNorm", "Constant",
           "Normal", "Dropout", "Embedding", "LayerList", "LayerNorm",
           "Linear"]
