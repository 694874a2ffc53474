"""Int8 / int4 quantization for inference (counterpart of
`paddle_tpu/quantization.py`): the weight recipe, weight-only quantized
Linears, post-training static quantization (PTQ) and the export of
quantization-aware training (QAT).

- `quantize_weight` is the ONE recipe, as in the JAX package: the serving
  decoder's a8w8 and w4a16 weights, `quantize_model`, PTQ and QAT's export
  all come through it.
- `QuantizedLinear`: int8 weight + per-out-channel f32 scale, dequantized
  in x's dtype, then a plain matmul (XLA's product in the JAX package, no
  Pallas kernel). `QuantizedLinearW4`: int4 nibbles through the port's
  `ops.w4_matmul` kernel.
- `QuantizedLinearA8W8`: int8 weights and int8 activations with a static
  activation scale, y = (q_x . q_w) * (s_w * s_x) + b, through the port's
  `ops.a8w8_matmul` (the row quantize and the int8 GEMM, in their `PTQ`
  epilogue order). It keeps Paddle's [in, out] `weight_q` buffer as its
  state and a K-contiguous copy for the kernel, made once (and again after
  `load_state_dict`).
- `PTQ` hooks every Linear and keeps each one's running f32 input absmax on
  the device (no sync a forward); `convert` swaps in `QuantizedLinearA8W8`.
  `QAT` wraps every Linear in `nn.quant.QuantizedLinear` (fake-quant
  weight and input, straight-through gradients) and exports the observer's
  EMA scale the same way.

Layers are `torch.nn.Module`s; a sublayer swap walks `_modules` as the JAX
package walks `_sub_layers`, so names and state-dict keys are the JAX
model's (`models.state_dict_from_numpy` carries a quantized JAX model's
buffers across).
"""
import warnings

import torch
from torch import nn as tnn

from .device import div_const
from .nn import Linear
from .ops import a8w8_matmul as a8

__all__ = ["quantize_weight", "dequantize_weight", "QuantizedLinear",
           "QuantizedLinearW4", "quantize_model", "QuantizedLinearA8W8",
           "PTQ", "QAT"]


def quantize_weight(w, axis=0, bits=8):
    """w [in, out] float -> (int8 w_q, f32 scale) per channel, symmetric;
    `bits` sets the grid (8 -> +-127, 4 -> +-7). The f32 amax over `axis`
    gives scale = max(amax / qmax, 1e-8), then q = clip(round(w / scale)).
    It divides, on the card too (`div_const`: a multiply by the reciprocal
    rounds differently), and `torch.round` rounds half to even like
    `jnp.round`, so the same f32 input gives the JAX package's bytes and
    scales."""
    qmax = float(2 ** (bits - 1) - 1)
    w32 = w.detach().float()
    amax = w32.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp_min(div_const(amax, qmax), 1e-8)
    q = torch.clamp(torch.round(w32 / scale), -qmax, qmax).to(torch.int8)
    return q, scale


def dequantize_weight(q, scale):
    return q.float() * scale


def _features(linear):
    return tuple(linear.weight.shape)            # Paddle's [in, out]


class QuantizedLinear(tnn.Module):
    """Drop-in Linear with an int8 weight + per-out-channel scale.
    Subclasses swap the quantizer / matmul pair (QuantizedLinearW4)."""

    def __init__(self, linear):
        super().__init__()
        q, scale = self._quantize(linear)
        self.register_buffer("weight_q", q)
        self.register_buffer("weight_scale", scale)
        self.bias = linear.bias
        self._in_features, self._out_features = _features(linear)

    def _quantize(self, linear):
        return quantize_weight(linear.weight, axis=0)

    def _matmul(self, v, q, s):
        return v @ (q.to(v.dtype) * s.to(v.dtype))

    def forward(self, x):
        out = self._matmul(x, self.weight_q, self.weight_scale)
        if self.bias is not None:
            out = out + self.bias.to(out.dtype)
        return out


class QuantizedLinearW4(QuantizedLinear):
    """Weight-only int4 Linear: two nibbles a byte along `in`, per-out
    scales, through the port's W4A16 kernel (`ops.w4_matmul`, the
    counterpart of the JAX Pallas `w4_matmul`). A quarter of bf16's weight
    bytes at ~2x int8's quantization error."""

    def _quantize(self, linear):
        from .ops.w4_matmul import quantize_w4
        return quantize_w4(linear.weight.detach())

    def _matmul(self, v, q, s):
        from .ops.w4_matmul import w4_matmul
        return w4_matmul(v, q, s, self._in_features)


def _swap_sublayers(layer, visit, prefix=""):
    """Shared sublayer-swap traversal (quantize_model, PTQ.convert,
    QAT.quantize/convert all walk the same way). `visit(full_name, sub)`
    returns a replacement layer, False to skip recursing into `sub`, or
    None to recurse."""
    for name, sub in list(layer._modules.items()):
        if sub is None:
            continue
        full = f"{prefix}{name}"
        r = visit(full, sub)
        if r is False:
            continue
        if r is not None:
            layer._modules[name] = r
        else:
            _swap_sublayers(sub, visit, f"{full}.")


def quantize_model(model, min_out_features=64, weight_bits=8):
    """Replace every Linear (>= min_out_features) with its weight-only
    quantized form: int8 (default) or int4 (weight_bits=4)."""
    assert weight_bits in (8, 4), weight_bits
    cls = QuantizedLinear if weight_bits == 8 else QuantizedLinearW4
    _swap_sublayers(model, lambda full, sub: cls(sub)
                    if isinstance(sub, Linear)
                    and _features(sub)[1] >= min_out_features else None)
    return model


class QuantizedLinearA8W8(tnn.Module):
    """Linear with int8 weights AND int8 activations (static scale from
    calibration): y = (q_x . q_w) * (s_w * s_x) + b, cast to x's dtype."""

    def __init__(self, linear, act_scale):
        super().__init__()
        q, scale = quantize_weight(linear.weight, axis=0)
        self.register_buffer("weight_q", q)               # [in, out]
        self.register_buffer("weight_scale", scale)       # [1, out]
        self.register_buffer("act_scale", torch.tensor(
            act_scale, dtype=torch.float32, device=q.device))
        # the int8 kernel's B operand: [out, in], K-contiguous
        self.register_buffer("_weight_qt", q.t().contiguous(),
                             persistent=False)
        self.bias = linear.bias
        self._in_features, self._out_features = _features(linear)

    def _load_from_state_dict(self, *args, **kwargs):
        super()._load_from_state_dict(*args, **kwargs)
        self._weight_qt = self.weight_q.t().contiguous()

    def forward(self, x):
        return a8.a8w8_linear(x, self._weight_qt,
                              self.weight_scale.reshape(-1), self.bias,
                              a8.PTQ, sx=self.act_scale)


class PTQ:
    """Post-training static quantization driver.

        ptq = PTQ(model)                 # hooks every Linear
        for batch in calib: model(batch) # observe activation abs-max
        model = ptq.convert()            # Linears -> int8 A8W8

    Calibration keeps the running f32 abs-max of each Linear's INPUT, a
    device scalar updated without a sync; convert swaps in
    QuantizedLinearA8W8 with the static scale max(amax / 127, 1e-8) and
    removes the hooks.
    """

    def __init__(self, model, min_out_features=16):
        self.model = model
        self.min_out = min_out_features
        self._amax = {}
        self._handles = []
        for name, sub in model.named_modules():
            if name and isinstance(sub, Linear) and \
                    _features(sub)[1] >= min_out_features:
                self._hook(name, sub)

    def _hook(self, name, layer):
        def pre(lyr, inputs):
            amax = inputs[0].detach().float().abs().amax()
            prev = self._amax.get(name)
            self._amax[name] = amax if prev is None else \
                torch.maximum(prev, amax)
            return None
        self._handles.append(layer.register_forward_pre_hook(pre))

    def convert(self):
        for h in self._handles:
            h.remove()
        # the one sync: each observed abs-max as the JAX driver's float
        amax = {k: float(v) for k, v in self._amax.items()}
        if self._handles and not any(v > 0 for v in amax.values()):
            warnings.warn(
                "PTQ.convert(): calibration observed no activations (no "
                "calibration forward ran); returning the model UNQUANTIZED",
                RuntimeWarning)

        def visit(full, sub):
            if isinstance(sub, Linear) and amax.get(full, 0) > 0:
                return QuantizedLinearA8W8(
                    sub, max(amax[full] / 127.0, 1e-8))
            return None
        _swap_sublayers(self.model, visit)
        return self.model


class QAT:
    """Quantization-aware training driver.

        qat = QAT()                 # weight_bits=8, activation_bits=8
        qat.quantize(model)         # Linears -> fake-quant wrappers
        ... train as usual ...      # STE learns int8-friendly weights
        qat.convert(model)          # wrappers -> int8 A8W8 execution

    quantize() wraps every Linear (>= min_out_features) in
    nn.quant.QuantizedLinear: the weight is fake-quantized per forward
    (abs-max) and the input through a trained moving-average abs-max
    observer. convert() swaps each wrapper for QuantizedLinearA8W8,
    carrying the OBSERVED activation scale (EMA buffer / 127) and the
    trained weights, so the deployed int8 model computes on the grid the
    training loop optimized against. A recomputed forward (the Trainer's
    remat 'full' / 'dots') would update the observers twice a step, which
    JAX's eager loop never does: train a QAT model with remat 'none'.
    """

    def __init__(self, weight_bits=8, activation_bits=8, moving_rate=0.9,
                 min_out_features=16,
                 weight_quantize_type="abs_max",
                 activation_quantize_type="moving_average_abs_max"):
        if weight_bits != 8 or activation_bits != 8:
            # the int8 execution path (QuantizedLinearA8W8) is the only
            # deployment grid
            raise NotImplementedError(
                "QAT export currently targets int8 only: weight_bits and "
                f"activation_bits must be 8, got {weight_bits}/"
                f"{activation_bits}")
        self.weight_bits = weight_bits
        self.activation_bits = activation_bits
        self.moving_rate = moving_rate
        self.min_out = min_out_features
        self.weight_quantize_type = weight_quantize_type
        self.activation_quantize_type = activation_quantize_type

    def quantize(self, model):
        from .nn.quant import QuantizedLinear as FakeQuantLinear

        def visit(full, sub):
            if isinstance(sub, FakeQuantLinear):
                return False            # idempotent: never double-wrap
            if isinstance(sub, Linear) and \
                    _features(sub)[1] >= self.min_out:
                return FakeQuantLinear(
                    sub, weight_bits=self.weight_bits,
                    activation_bits=self.activation_bits,
                    moving_rate=self.moving_rate,
                    weight_quantize_type=self.weight_quantize_type,
                    activation_quantize_type=self.activation_quantize_type)
            return None
        _swap_sublayers(model, visit)
        return model

    def convert(self, model):
        from .nn.quant import QuantizedLinear as FakeQuantLinear

        def visit(full, sub):
            if not isinstance(sub, FakeQuantLinear):
                return None
            obs = sub._fake_quant_input
            if int(obs.seen) == 0:
                warnings.warn(
                    f"QAT.convert(): {full} never observed an activation "
                    "(no train-mode forward ran); exporting with the "
                    "uninitialized scale 1.0 will saturate inputs |x|>1",
                    RuntimeWarning)
            act_scale = max(float(obs.scale) / 127.0, 1e-8)
            return QuantizedLinearA8W8(sub._inner, act_scale)
        _swap_sublayers(model, visit)
        return model
