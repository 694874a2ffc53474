"""Quantization-aware-training layers (counterpart of
`paddle_tpu/nn/quant`, reference python/paddle/nn/quant/quant_layers.py).
Fake-quant: quantize -> dequantize in the forward with a straight-through
estimator (`v + (q - v).detach()`, the difference computed outside the
graph), so training still runs dense float
products (real int8 execution lives in `paddle_tpu_torch.quantization`).

The observers update their buffers with device ops only (no `.item()` a
forward), and their arithmetic follows the JAX layers' dtypes: a
moving-average scale is an f32 buffer, so a bf16 input is fake-quantized
in f32 (JAX promotes it) and comes out f32. `QuantizedConv2DTranspose`
raises: the port has no transposed convolution yet.
"""
import torch
from torch import nn as tnn
from torch.func import functional_call

from ...device import div_const

__all__ = [
    "FakeQuantAbsMax", "FakeQuantMovingAverageAbsMax",
    "FakeQuantChannelWiseAbsMax", "QuantizedConv2D",
    "QuantizedConv2DTranspose", "QuantizedLinear",
    "MovingAverageAbsMaxScale", "MAOutputScaleLayer",
    "FakeQuantMAOutputScaleLayer", "QuantStub",
]


def _fake_quant(x, scale, bits):
    """Quantize-dequantize with a straight-through gradient, in the
    promoted dtype of x and scale (JAX's promotion: an f32 scale lifts a
    bf16 x)."""
    qmax = float(2 ** (bits - 1) - 1)
    dt = torch.promote_types(x.dtype, scale.dtype)
    v = x.to(dt)
    with torch.no_grad():               # the detached branch: no graph
        s = torch.clamp_min(scale.to(dt), 1e-9)
        q = div_const(torch.clamp(torch.round(v / s * qmax), -qmax, qmax)
                      * s, qmax)
        d = q - v
    return v + d


def _absmax(x):
    return x.detach().abs().amax()


def _weak(value, dtype):
    """A Python float as JAX's weak typing applies it to a tensor of
    `dtype`: rounded to that dtype first (bf16(0.1) for a bf16 abs-max),
    where torch would multiply by its f32 value."""
    return float(torch.tensor(value, dtype=dtype))


def _ema(scale, cur, rate):
    """scale * rate + cur * (1 - rate), each product in its operand's
    dtype (the f32 buffer, the input's abs-max), the sum promoted."""
    return scale * rate + cur * _weak(1 - rate, cur.dtype)


class FakeQuantAbsMax(tnn.Module):
    def __init__(self, name=None, quant_bits=8, dtype="float32",
                 quant_on_weight=False):
        super().__init__()
        self._quant_bits = quant_bits

    def forward(self, input):
        return _fake_quant(input, _absmax(input), self._quant_bits)


class FakeQuantChannelWiseAbsMax(tnn.Module):
    def __init__(self, name=None, channel_num=None, quant_bits=8,
                 quant_axis=0, dtype="float32", quant_on_weight=False):
        super().__init__()
        self._quant_bits = quant_bits
        self._quant_axis = quant_axis

    def forward(self, input):
        axes = tuple(a for a in range(input.dim()) if a != self._quant_axis)
        scale = input.detach().abs().amax(dim=axes, keepdim=True)
        return _fake_quant(input, scale, self._quant_bits)


class FakeQuantMovingAverageAbsMax(tnn.Module):
    """Fake-quant on a moving-average abs-max scale: in training the first
    forward seeds `scale` with the batch abs-max, later ones take scale *
    rate + absmax * (1 - rate); eval reads it. `seen` and `scale` are
    persistable, so a restored QAT checkpoint keeps its EMA."""

    def __init__(self, name=None, moving_rate=0.9, quant_bits=8,
                 dtype="float32"):
        super().__init__()
        self._moving_rate = moving_rate
        self._quant_bits = quant_bits
        self.register_buffer("seen", torch.zeros([], dtype=torch.int32))
        self.register_buffer("scale", torch.ones([]))

    def forward(self, input):
        if self.training:
            cur = _absmax(input)
            ema = _ema(self.scale, cur, self._moving_rate)
            self.scale.copy_(torch.where(self.seen > 0, ema, cur))
            self.seen.fill_(1)
        return _fake_quant(input, self.scale, self._quant_bits)


class MovingAverageAbsMaxScale(tnn.Module):
    """Observes the abs-max scale of activations without quantizing."""

    def __init__(self, name=None, moving_rate=0.9, dtype="float32"):
        super().__init__()
        self._moving_rate = moving_rate
        self.register_buffer("scale", torch.ones([]))

    def forward(self, input):
        if self.training:
            self.scale.copy_(_ema(self.scale, _absmax(input),
                                  self._moving_rate))
        return input


class _QuantizedWrapper(tnn.Module):
    """Wraps a float layer: fake-quants its weight and its input, then
    runs it with the fake-quantized weight (`functional_call`, so the
    gradient reaches the layer's own parameter through the STE)."""

    def __init__(self, layer, weight_bits=8, activation_bits=8,
                 moving_rate=0.9, weight_quantize_type="abs_max",
                 activation_quantize_type="moving_average_abs_max",
                 **kwargs):
        super().__init__()
        self._inner = layer
        if weight_quantize_type == "channel_wise_abs_max":
            # the JAX layers' axis: the weight's LAST axis (Linear's out)
            self._fake_quant_weight = FakeQuantChannelWiseAbsMax(
                quant_bits=weight_bits, quant_axis=layer.weight.dim() - 1)
        else:
            self._fake_quant_weight = FakeQuantAbsMax(
                quant_bits=weight_bits, quant_on_weight=True)
        self._fake_quant_input = FakeQuantMovingAverageAbsMax(
            moving_rate=moving_rate, quant_bits=activation_bits)

    def forward(self, input):
        qin = self._fake_quant_input(input)
        qw = self._fake_quant_weight(self._inner.weight)
        return functional_call(self._inner, {"weight": qw}, (qin,))


class QuantizedLinear(_QuantizedWrapper):
    pass


class QuantizedConv2D(_QuantizedWrapper):
    pass


class QuantizedConv2DTranspose(_QuantizedWrapper):
    def __init__(self, layer, *args, **kwargs):
        raise NotImplementedError(
            "QuantizedConv2DTranspose is not ported: paddle_tpu_torch has "
            "no transposed convolution yet (ROADMAP.md queue 1, item 6)")


class QuantStub(tnn.Module):
    """Marks a quantization entry point; observes the activation scale."""

    def __init__(self, name=None, moving_rate=0.9):
        super().__init__()
        self._observer = MovingAverageAbsMaxScale(moving_rate=moving_rate)

    def forward(self, input):
        return self._observer(input)


class MAOutputScaleLayer(tnn.Module):
    def __init__(self, layer=None, moving_rate=0.9, name=None,
                 dtype="float32"):
        super().__init__()
        self._layer = layer
        self._ma_output_scale = MovingAverageAbsMaxScale(
            moving_rate=moving_rate)

    def forward(self, *inputs, **kwargs):
        out = self._layer(*inputs, **kwargs)
        if isinstance(out, (list, tuple)):
            return out
        return self._ma_output_scale(out)


class FakeQuantMAOutputScaleLayer(tnn.Module):
    def __init__(self, layer, weight_bits=8, activation_bits=8,
                 moving_rate=0.9, name=None, *args, **kwargs):
        super().__init__()
        self._layer = layer
        self._fake_quant_output = FakeQuantMovingAverageAbsMax(
            moving_rate=moving_rate, quant_bits=activation_bits)

    def forward(self, *inputs, **kwargs):
        out = self._layer(*inputs, **kwargs)
        if isinstance(out, (list, tuple)):
            return out
        return self._fake_quant_output(out)
