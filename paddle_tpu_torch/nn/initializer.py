"""Parameter initializers (counterpart of `paddle_tpu/nn/initializer`):
each fills a tensor in place, drawing from the `torch.Generator` it is
given (a generator on the tensor's device)."""
import math

import torch

__all__ = ["Normal", "Constant", "XavierUniform"]


class Normal:
    """N(mean, std)."""

    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = float(mean), float(std)

    def __call__(self, tensor, generator=None):
        with torch.no_grad():
            return tensor.normal_(self.mean, self.std, generator=generator)


class Constant:
    """A constant value; draws nothing."""

    def __init__(self, value=0.0):
        self.value = float(value)

    def __call__(self, tensor, generator=None):
        with torch.no_grad():
            return tensor.fill_(self.value)


class XavierUniform:
    """U(-a, a) with a = sqrt(6 / (fan_in + fan_out)); Paddle's fans: a
    [in, out] weight has fan_in = in and fan_out = out, a 1-D shape has
    both equal to its length (the JAX `_fans`, 2-D and 1-D)."""

    def __call__(self, tensor, generator=None):
        if tensor.dim() > 2:
            raise NotImplementedError("XavierUniform of a conv weight is "
                                      "not ported")
        fi = fo = tensor.shape[0] if tensor.dim() else 1
        if tensor.dim() == 2:
            fo = tensor.shape[1]
        limit = math.sqrt(6.0 / (fi + fo))
        with torch.no_grad():
            return tensor.uniform_(-limit, limit, generator=generator)
