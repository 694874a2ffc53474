"""Layers, functionals, initializers and gradient clipping of the GPT
and BERT training paths (counterpart of `paddle_tpu/nn`)."""
from . import functional, initializer
from .clip import ClipGradByGlobalNorm
from .initializer import Constant, Normal, XavierUniform
from .layer import Dropout, Embedding, LayerList, LayerNorm, Linear, RMSNorm
from .transformer import (MultiHeadAttention, TransformerEncoder,
                          TransformerEncoderLayer)

__all__ = ["functional", "initializer", "ClipGradByGlobalNorm", "Constant",
           "Normal", "XavierUniform", "Dropout", "Embedding", "LayerList",
           "LayerNorm", "Linear", "MultiHeadAttention", "RMSNorm",
           "TransformerEncoder", "TransformerEncoderLayer"]
