"""Parameter initializers (counterpart of `paddle_tpu/nn/initializer`):
each fills a tensor in place, drawing from the `torch.Generator` it is
given (a generator on the tensor's device)."""
import torch

__all__ = ["Normal", "Constant"]


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
