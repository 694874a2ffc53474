"""Layers of the GPT training path (counterparts of `paddle_tpu/nn/layer`)
as `torch.nn.Module`s. Parameters keep Paddle's names and layouts
(`Linear.weight` is [in, out]), so a JAX model's state dict loads by
name. Each layer draws its initial values at construction, in
construction order, from the `generator` it is given."""
import torch
from torch import nn

from ..device import get_device
from . import functional as F
from .initializer import Constant, Normal

__all__ = ["Linear", "Embedding", "LayerNorm", "Dropout", "LayerList"]


def _param(shape, init, device, generator):
    t = torch.empty(shape, dtype=torch.float32, device=device)
    init(t, generator)
    return nn.Parameter(t)


class Linear(nn.Module):
    """y = x @ weight + bias; weight [in, out], drawn by `weight_init`
    (default N(0, 0.02), the GPT recipe's); bias 0."""

    def __init__(self, in_features, out_features, weight_init=None,
                 bias=True, device=None, generator=None):
        super().__init__()
        dev = get_device(device)
        self.weight = _param((in_features, out_features),
                             weight_init or Normal(0.0, 0.02), dev, generator)
        self.bias = (_param((out_features,), Constant(0.0), dev, generator)
                     if bias else None)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class Embedding(nn.Module):
    def __init__(self, num_embeddings, embedding_dim, weight_init=None,
                 device=None, generator=None):
        super().__init__()
        self.weight = _param((num_embeddings, embedding_dim),
                             weight_init or Normal(0.0, 0.02),
                             get_device(device), generator)

    def forward(self, x):
        return F.embedding(x, self.weight)


class LayerNorm(nn.Module):
    def __init__(self, normalized_shape, epsilon=1e-5, device=None):
        super().__init__()
        dev = get_device(device)
        shape = ((normalized_shape,) if isinstance(normalized_shape, int)
                 else tuple(normalized_shape))
        self._shape = list(shape)
        self._epsilon = epsilon
        self.weight = _param(shape, Constant(1.0), dev, None)
        self.bias = _param(shape, Constant(0.0), dev, None)

    def forward(self, x):
        return F.layer_norm(x, self._shape, self.weight, self.bias,
                            self._epsilon)


class Dropout(nn.Module):
    """Upscale-in-train dropout whose masks come from `generator`."""

    def __init__(self, p=0.5, generator=None):
        super().__init__()
        self.p = float(p)
        self.generator = generator

    def forward(self, x):
        return F.dropout(x, self.p, self.training, self.generator)


class LayerList(nn.ModuleList):
    """Paddle's name for an `nn.ModuleList`."""
