"""Layers of the GPT and BERT training paths (counterparts of
`paddle_tpu/nn/layer/common.py` and `norm.py`) as `torch.nn.Module`s.
Parameters keep Paddle's names and layouts (`Linear.weight` is
[in, out]), so a JAX model's state dict loads by name. Each layer draws
its initial values at construction, in construction order, from the
`generator` it is given (a generator on the parameters' device), and
draws them again from another generator with `reset_parameters`.
`Dropout` draws its per-call salt from a CPU generator (no host sync)."""
import torch
from torch import nn

from ..device import get_device
from . import functional as F
from .initializer import Constant, Normal, XavierUniform

__all__ = ["Linear", "Embedding", "LayerNorm", "RMSNorm", "Dropout",
           "LayerList"]


def _param(shape, init, device, generator):
    t = torch.empty(shape, dtype=torch.float32, device=device)
    init(t, generator)
    return nn.Parameter(t)


class Linear(nn.Module):
    """y = x @ weight + bias; weight [in, out], drawn by `weight_init`
    (default XavierUniform, Paddle's); bias 0."""

    def __init__(self, in_features, out_features, weight_init=None,
                 bias=True, device=None, generator=None):
        super().__init__()
        dev = get_device(device)
        self._weight_init = weight_init or XavierUniform()
        self.weight = _param((in_features, out_features), self._weight_init,
                             dev, generator)
        self.bias = (_param((out_features,), Constant(0.0), dev, generator)
                     if bias else None)

    def reset_parameters(self, generator=None):
        """Draw the weight again (the bias stays 0)."""
        self._weight_init(self.weight, generator)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class Embedding(nn.Module):
    """Rows of `weight` [num, dim], drawn by `weight_init` (default
    N(0, 1), Paddle's). With `padding_idx` (negative counts from the
    end), that row starts at 0 and its output (so its gradient) is 0."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, *, weight_init=None, device=None,
                 generator=None):
        super().__init__()
        if sparse:
            raise NotImplementedError("Embedding(sparse=True) (sparse "
                                      "gradients) is not ported")
        self._padding_idx = None if padding_idx is None else (
            padding_idx if padding_idx >= 0 else num_embeddings + padding_idx)
        self._weight_init = weight_init or Normal(0.0, 1.0)
        self.weight = _param((num_embeddings, embedding_dim),
                             self._weight_init, get_device(device), generator)
        self._zero_padding_row()

    def _zero_padding_row(self):
        if self._padding_idx is not None:
            with torch.no_grad():
                self.weight[self._padding_idx] = 0.0

    def reset_parameters(self, generator=None):
        self._weight_init(self.weight, generator)
        self._zero_padding_row()

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self._padding_idx)


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


class RMSNorm(nn.Module):
    """RMSNorm over the last axis (`F.rms_norm`) with a weight [hidden]
    that starts at 1."""

    def __init__(self, hidden_size, epsilon=1e-6, device=None):
        super().__init__()
        self._epsilon = epsilon
        self.weight = _param((hidden_size,), Constant(1.0),
                             get_device(device), None)

    def forward(self, x):
        return F.rms_norm(x, self.weight, self._epsilon)


class Dropout(nn.Module):
    """Hash dropout (`F.dropout`, with its `axis` and `mode`) whose
    per-call salts come from the CPU `generator` (None: torch's default
    CPU generator)."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train",
                 name=None, *, generator=None):
        super().__init__()
        self.p = float(p)
        self.axis = axis
        self.mode = mode
        self.generator = generator

    def forward(self, x):
        return F.dropout(x, self.p, axis=self.axis, training=self.training,
                         mode=self.mode, generator=self.generator)


class LayerList(nn.ModuleList):
    """Paddle's name for an `nn.ModuleList`."""
