"""Layers of the GPT, BERT and ResNet training paths (counterparts of
`paddle_tpu/nn/layer/common.py`, `norm.py`, `conv.py`, `pooling.py`,
`activation.py` and `container.py`) as `torch.nn.Module`s.
Parameters keep Paddle's names and layouts (`Linear.weight` is
[in, out]), so a JAX model's state dict loads by name. Each layer draws
its initial values at construction, in construction order, from the
`generator` it is given (a generator on the parameters' device), and
draws them again from another generator with `reset_parameters`.
`Dropout` draws its per-call salt from a CPU generator (no host sync)."""
import collections
import math

import torch
from torch import nn

from ..device import get_device
from . import functional as F
from .initializer import (Constant, KaimingUniform, Normal, Uniform,
                          XavierUniform)
from .layout import resolve_data_format

__all__ = ["Linear", "Embedding", "LayerNorm", "RMSNorm", "Dropout",
           "LayerList", "Conv2D", "BatchNorm2D", "MaxPool2D",
           "AdaptiveAvgPool2D", "ReLU", "Sequential"]


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
    """LayerNorm over the trailing `normalized_shape` axes with a weight
    that starts at 1 and a bias at 0; `weight_attr=False` / `bias_attr=
    False` leave it out (None), as the JAX layer builds them."""

    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None, *, device=None):
        super().__init__()
        _attr_unported("weight_attr", weight_attr)
        _attr_unported("bias_attr", bias_attr)
        dev = get_device(device)
        shape = ((normalized_shape,) if isinstance(normalized_shape, int)
                 else tuple(normalized_shape))
        self._shape = list(shape)
        self._epsilon = epsilon
        self.weight = (None if weight_attr is False else
                       _param(shape, Constant(1.0), dev, None))
        self.bias = (None if bias_attr is False else
                     _param(shape, Constant(0.0), dev, None))

    def forward(self, x):
        return F.layer_norm(x, self._shape, self.weight, self.bias,
                            self._epsilon)


class RMSNorm(nn.Module):
    """RMSNorm over the last axis (`F.rms_norm`) with a weight [hidden]
    that starts at 1 (None with `weight_attr=False`)."""

    def __init__(self, hidden_size, epsilon=1e-6, weight_attr=None,
                 name=None, *, device=None):
        super().__init__()
        _attr_unported("weight_attr", weight_attr)
        self._epsilon = epsilon
        self.weight = (None if weight_attr is False else
                       _param((hidden_size,), Constant(1.0),
                              get_device(device), None))

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
    """Paddle's name for an `nn.ModuleList`, built from `sublayers`."""

    def __init__(self, sublayers=None):
        super().__init__(sublayers)


def _attr_unported(name, attr):
    """Paddle's ParamAttr is not ported: None (the default) and False (no
    parameter) are the only values taken."""
    if attr is not None and attr is not False:
        raise NotImplementedError(f"{name}={attr!r} (ParamAttr) is not "
                                  "ported (ROADMAP.md queue 1, item 8)")


class Conv2D(nn.Module):
    """2-D convolution (`F.conv2d`) with Paddle's weight [O, I/groups,
    kH, kW] in either data format, drawn KaimingUniform(fan_in, leaky_relu,
    slope sqrt(5)), i.e. U(+-1/sqrt(fan_in)), and a bias U(+-1/sqrt(fan_in))
    unless `bias_attr=False` (the JAX defaults); fan_in = I/groups * kH *
    kW. The data format resolves at construction."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format=None, *,
                 device=None, generator=None):
        super().__init__()
        if padding_mode != "zeros":
            raise NotImplementedError(f"Conv2D(padding_mode="
                                      f"{padding_mode!r}) is not ported")
        if in_channels % groups:
            raise ValueError(f"in_channels {in_channels} is not a multiple "
                             f"of groups {groups}")
        if weight_attr is not None:
            raise NotImplementedError(f"Conv2D(weight_attr={weight_attr!r})"
                                      " (ParamAttr) is not ported")
        _attr_unported("bias_attr", bias_attr)
        dev = get_device(device)
        k = (tuple(kernel_size) if isinstance(kernel_size, (list, tuple))
             else (kernel_size,) * 2)
        self._stride, self._padding = stride, padding
        self._dilation, self._groups = dilation, groups
        self._data_format = resolve_data_format(data_format, 2)
        fan_in = (in_channels // groups) * math.prod(k)
        self.weight = _param((out_channels, in_channels // groups) + k,
                             KaimingUniform(fan_in, math.sqrt(5.0),
                                            "leaky_relu"), dev, generator)
        bound = 1.0 / math.sqrt(fan_in)
        self.bias = (None if bias_attr is False else
                     _param((out_channels,), Uniform(-bound, bound), dev,
                            generator))

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)


class BatchNorm2D(nn.Module):
    """Batch norm (`F.batch_norm`) over the channel axis of the data
    format; weight 1 and bias 0 (None with `weight_attr` / `bias_attr`
    False), buffers `_mean` 0 and `_variance` 1 in f32, updated in place by
    each training forward with Paddle's momentum."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format=None,
                 use_global_stats=None, name=None, *, device=None):
        super().__init__()
        _attr_unported("weight_attr", weight_attr)
        _attr_unported("bias_attr", bias_attr)
        dev = get_device(device)
        self._momentum, self._epsilon = momentum, epsilon
        self._data_format = resolve_data_format(data_format, 2)
        self._use_global_stats = use_global_stats
        self.weight = (None if weight_attr is False else
                       _param((num_features,), Constant(1.0), dev, None))
        self.bias = (None if bias_attr is False else
                     _param((num_features,), Constant(0.0), dev, None))
        self.register_buffer("_mean", torch.zeros(num_features, device=dev))
        self.register_buffer("_variance", torch.ones(num_features,
                                                     device=dev))

    def forward(self, x):
        return F.batch_norm(x, self._mean, self._variance, self.weight,
                            self.bias, training=self.training,
                            momentum=self._momentum, epsilon=self._epsilon,
                            data_format=self._data_format,
                            use_global_stats=self._use_global_stats)


class MaxPool2D(nn.Module):
    """`F.max_pool2d` with its arguments fixed; the data format resolves
    at construction."""

    def __init__(self, kernel_size, stride=None, padding=0,
                 return_mask=False, ceil_mode=False, data_format=None,
                 name=None):
        super().__init__()
        if return_mask:
            raise NotImplementedError("MaxPool2D(return_mask=True) is not "
                                      "ported")
        self.kernel_size, self.stride, self.padding = (kernel_size, stride,
                                                       padding)
        self.ceil_mode = ceil_mode
        self.data_format = resolve_data_format(data_format, 2)

    def forward(self, x):
        return F.max_pool2d(x, self.kernel_size, self.stride, self.padding,
                            ceil_mode=self.ceil_mode,
                            data_format=self.data_format)


class AdaptiveAvgPool2D(nn.Module):
    """`F.adaptive_avg_pool2d` to `output_size`; the data format
    resolves at construction."""

    def __init__(self, output_size, data_format=None, name=None):
        super().__init__()
        self.output_size = output_size
        self.data_format = resolve_data_format(data_format, 2)

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self.output_size, self.data_format)


class ReLU(nn.Module):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.relu(x)


class Sequential(nn.Sequential):
    """Layers called in order, named "0", "1", ... as in Paddle, or by the
    names of (name, layer) pairs."""

    def __init__(self, *layers):
        if len(layers) == 1 and isinstance(layers[0], (list, tuple)) and \
                layers[0] and isinstance(layers[0][0], (list, tuple)):
            layers = layers[0]
        if layers and isinstance(layers[0], tuple):
            super().__init__(collections.OrderedDict(layers))
        else:
            super().__init__(*layers)
