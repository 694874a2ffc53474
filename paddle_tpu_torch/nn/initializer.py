"""Parameter initializers (counterpart of `paddle_tpu/nn/initializer`):
each fills a tensor in place, drawing from the `torch.Generator` it is
given (a generator on the tensor's device)."""
import math

import torch

__all__ = ["Normal", "Constant", "XavierUniform", "Uniform", "KaimingUniform"]


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


class Uniform:
    """U(low, high)."""

    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = float(low), float(high)

    def __call__(self, tensor, generator=None):
        with torch.no_grad():
            return tensor.uniform_(self.low, self.high, generator=generator)


class KaimingUniform:
    """U(-a, a) with a = gain * sqrt(3 / fan_in); `fan_in` given, or
    Paddle's (a conv weight [O, I, *k] has I * prod(k), a [in, out]
    weight in); the gain of "relu" or "leaky_relu" with
    `negative_slope` (the JAX `calculate_gain`). Paddle's conv default,
    leaky_relu at slope sqrt(5), gives a = 1 / sqrt(fan_in)."""

    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        if nonlinearity not in ("relu", "leaky_relu"):
            raise NotImplementedError(f"KaimingUniform({nonlinearity!r}) "
                                      "is not ported")
        self.fan_in, self.negative_slope = fan_in, negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, tensor, generator=None):
        fi = self.fan_in
        if fi is None:
            fi = (tensor.shape[1] * math.prod(tensor.shape[2:])
                  if tensor.dim() > 2 else tensor.shape[0])
        slope = 0.01 if self.negative_slope is None else self.negative_slope
        gain = (math.sqrt(2.0) if self.nonlinearity == "relu"
                else math.sqrt(2.0 / (1 + slope ** 2)))
        limit = gain * math.sqrt(3.0 / fi)
        with torch.no_grad():
            return tensor.uniform_(-limit, limit, generator=generator)
