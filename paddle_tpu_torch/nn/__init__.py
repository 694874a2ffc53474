"""Layers, functionals, initializers, layouts and gradient clipping of
the GPT, BERT and ResNet training paths, and the fake-quant layers of
quantization-aware training (`nn.quant`) (counterpart of
`paddle_tpu/nn`)."""
from . import functional, initializer, layout, quant
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                   ClipGradForMOEByGlobalNorm)
from .initializer import (Constant, KaimingUniform, Normal, Uniform,
                          XavierUniform)
from .layer import (AdaptiveAvgPool2D, BatchNorm2D, Conv2D, Dropout,
                    Embedding, LayerList, LayerNorm, Linear, MaxPool2D,
                    ReLU, RMSNorm, Sequential)
from .layout import set_channels_last
from .transformer import (MultiHeadAttention, TransformerEncoder,
                          TransformerEncoderLayer)

__all__ = ["functional", "initializer", "layout", "quant", "ClipGradByGlobalNorm",
           "ClipGradByNorm", "ClipGradByValue", "ClipGradForMOEByGlobalNorm",
           "Constant", "KaimingUniform", "Normal", "Uniform",
           "XavierUniform", "AdaptiveAvgPool2D", "BatchNorm2D", "Conv2D",
           "Dropout", "Embedding", "LayerList", "LayerNorm", "Linear",
           "MaxPool2D", "MultiHeadAttention", "ReLU", "RMSNorm",
           "Sequential", "TransformerEncoder", "TransformerEncoderLayer",
           "set_channels_last"]
