"""The port's fake-quant layers (paddle_tpu_torch.nn.quant) against the JAX
package's (paddle_tpu.nn.quant), on the same inputs made with numpy.

- Forward values: each layer's quantize-dequantize is exact arithmetic
  done op by op in both packages (divide, multiply by qmax, round half to
  even, clip, multiply, divide), so f32 values are equal; bf16 inputs
  (whose abs-max and fake-quant run in bf16, or in f32 where an f32
  observer scale promotes them, as in JAX) within one bf16 ulp of the
  value, XLA's CPU fusions being free to keep an f32 intermediate.
- Gradients: the straight-through estimator passes the cotangent through
  unchanged (`v + (q - v).detach()`), equal to `jax.vjp` of the JAX layer;
  the wrappers' gradients with respect to the input, the weight and the
  bias within f32 1e-5 of `jax.vjp` (two frameworks' matmuls).
- The moving-average observers: `seen` and `scale` after three train-mode
  forwards equal the JAX buffers (f32 exact; bf16 inputs multiply their
  abs-max by bf16(1 - rate), as JAX's weak float does), and an eval-mode
  forward leaves them untouched.
- `QuantizedConv2DTranspose` raises NotImplementedError.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.framework.core import Tensor as JTensor
from paddle_tpu.nn import quant as jquant
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.nn import quant


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread while a test of this module runs: the suite
    runs in several worker processes beside XLA's thread pools, and
    PyTorch's default of a thread per core then oversubscribes the CPU
    many times over. Results do not depend on it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _x(seed, shape, scale=3.0):
    x = (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)
    x.flat[0] = 0.0
    return x


def _t(a, dtype="float32"):
    return torch.from_numpy(np.array(a)).to(getattr(torch, dtype))


def _j(a, dtype="float32"):
    return jnp.asarray(a).astype(dtype)


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.detach().float().numpy()
    return np.asarray(jnp.asarray(v).astype(jnp.float32))


def _bf16_ulp(v):
    mag = np.maximum(np.abs(v), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(mag)) - 7).astype(np.float32)


def _close(got, want, dtype):
    got, want = _np(got), _np(want)
    if dtype == "float32":
        np.testing.assert_array_equal(got, want)
    else:
        assert (np.abs(got - want) <= _bf16_ulp(want)).all()


def _jax_vjp(layer, x, g):
    out, pull = jax.vjp(lambda v: layer(JTensor(v))._value, x)
    return out, pull(g)[0]


def _port_vjp(layer, x, g):
    x = x.clone().requires_grad_()
    out = layer(x)
    out.backward(g.to(out.dtype))
    return out, x.grad


STATELESS = [
    ("abs_max", lambda: jquant.FakeQuantAbsMax(quant_bits=8),
     lambda: quant.FakeQuantAbsMax(quant_bits=8)),
    ("abs_max_4bit", lambda: jquant.FakeQuantAbsMax(quant_bits=4),
     lambda: quant.FakeQuantAbsMax(quant_bits=4)),
    ("channel_wise_axis1",
     lambda: jquant.FakeQuantChannelWiseAbsMax(quant_axis=1),
     lambda: quant.FakeQuantChannelWiseAbsMax(quant_axis=1)),
    ("channel_wise_axis0",
     lambda: jquant.FakeQuantChannelWiseAbsMax(quant_axis=0, quant_bits=4),
     lambda: quant.FakeQuantChannelWiseAbsMax(quant_axis=0, quant_bits=4)),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,jmake,tmake", STATELESS,
                         ids=[c[0] for c in STATELESS])
def test_fake_quant_values_and_ste_grads(name, jmake, tmake, dtype):
    x = _x(1, (6, 12))
    x[2, :3] = [1.5, -1.5, 0.0]               # a row with exact halves
    g = _x(2, (6, 12), 1.0)
    jout, jgrad = _jax_vjp(jmake(), _j(x, dtype), _j(g, dtype))
    tout, tgrad = _port_vjp(tmake(), _t(x, dtype), _t(g, dtype))
    assert tout.dtype == getattr(torch, dtype)
    _close(tout, jout, dtype)
    np.testing.assert_array_equal(_np(tgrad), _np(jgrad))   # identity
    np.testing.assert_array_equal(_np(tgrad), _np(_t(g, dtype)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["fake_quant", "scale_only", "stub",
                                  "ma_output", "fq_ma_output"])
def test_moving_average_observers(kind, dtype):
    """Three train-mode forwards: buffers equal JAX's after each; the
    outputs equal; then eval forwards leave the buffers as they were."""
    rate = 0.7
    if kind == "fake_quant":
        jl = jquant.FakeQuantMovingAverageAbsMax(moving_rate=rate)
        tl = quant.FakeQuantMovingAverageAbsMax(moving_rate=rate)
    elif kind == "scale_only":
        jl = jquant.MovingAverageAbsMaxScale(moving_rate=rate)
        tl = quant.MovingAverageAbsMaxScale(moving_rate=rate)
    elif kind == "stub":
        jl = jquant.QuantStub(moving_rate=rate)
        tl = quant.QuantStub(moving_rate=rate)
    elif kind == "ma_output":
        jl = jquant.MAOutputScaleLayer(paddle.nn.ReLU(), moving_rate=rate)
        tl = quant.MAOutputScaleLayer(tnn.ReLU(), moving_rate=rate)
    else:
        jl = jquant.FakeQuantMAOutputScaleLayer(paddle.nn.ReLU(),
                                                moving_rate=rate)
        tl = quant.FakeQuantMAOutputScaleLayer(tnn.ReLU(), moving_rate=rate)

    def buffers(layer, port):
        if port:
            return {k: v.clone() for k, v in layer.state_dict().items()}
        return {k: np.asarray(v._value) for k, v in
                layer.state_dict().items()}

    jl.train()
    tl.train()
    assert set(buffers(jl, False)) == set(buffers(tl, True))
    for step in range(3):
        x = _x(10 + step, (4, 16), scale=1.0 + step)
        jout = jl(paddle.to_tensor(x).astype(dtype))
        tout = tl(_t(x, dtype))
        _close(tout, jout._value, dtype)
        jb, tb = buffers(jl, False), buffers(tl, True)
        for k in jb:
            assert tb[k].dtype == torch.from_numpy(np.array(jb[k])).dtype
            np.testing.assert_array_equal(tb[k].numpy(), jb[k])
    before = buffers(tl, True)
    tl.eval()
    jl.eval()
    x = _x(20, (4, 16), scale=9.0)
    _close(tl(_t(x, dtype)), jl(paddle.to_tensor(x).astype(dtype))._value,
           dtype)
    for k, v in buffers(tl, True).items():
        assert torch.equal(v, before[k])


def test_observer_seeds_from_the_first_batch():
    """The first train forward seeds `scale` with the batch abs-max (no
    EMA against the initial 1.0) and sets `seen`, as in JAX."""
    x = _x(3, (5, 7), scale=4.0)
    tl = quant.FakeQuantMovingAverageAbsMax(moving_rate=0.9)
    jl = jquant.FakeQuantMovingAverageAbsMax(moving_rate=0.9)
    tl(_t(x))
    jl(paddle.to_tensor(x))
    assert int(tl.seen) == int(jl.seen._value) == 1
    assert float(tl.scale) == float(jl.scale._value) == float(np.abs(x).max())


def _jax_linear(seed, i, o):
    paddle.seed(seed)
    return paddle.nn.Linear(i, o)


@pytest.mark.parametrize("wtype", ["abs_max", "channel_wise_abs_max"])
def test_quantized_linear_wrapper_matches_jax(wtype):
    """nn.quant.QuantizedLinear around the same Linear: train-mode
    forward values, the observer after it, and the gradients with respect
    to x, weight and bias against `jax.vjp` of the JAX wrapper."""
    jlin = _jax_linear(4, 12, 20)
    tlin = tnn.Linear(12, 20, device="cpu")
    with torch.no_grad():
        tlin.weight.copy_(_t(np.asarray(jlin.weight._value)))
        tlin.bias.copy_(_t(np.asarray(jlin.bias._value)))
    jw = jquant.QuantizedLinear(jlin, weight_quantize_type=wtype)
    tw = quant.QuantizedLinear(tlin, weight_quantize_type=wtype)
    if wtype == "channel_wise_abs_max":
        assert tw._fake_quant_weight._quant_axis == 1     # out channels
    x = _x(5, (3, 12))
    g = _x(6, (3, 20), 1.0)
    w0, b0 = jlin.weight._value, jlin.bias._value

    def fn(v, w, b):
        jlin.weight._value, jlin.bias._value = w, b
        try:
            return jw(JTensor(v))._value
        finally:
            jlin.weight._value, jlin.bias._value = w0, b0

    jw.eval()        # the observer keeps its state under the trace
    jout, pull = jax.vjp(fn, _j(x), w0, b0)
    jgx, jgw, jgb = pull(_j(g))
    tw.eval()
    xt = _t(x).requires_grad_()
    tout = tw(xt)
    tout.backward(_t(g))
    np.testing.assert_allclose(_np(tout), _np(jout), atol=1e-5, rtol=0)
    np.testing.assert_allclose(_np(xt.grad), _np(jgx), atol=1e-5, rtol=0)
    np.testing.assert_allclose(_np(tlin.weight.grad), _np(jgw), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(_np(tlin.bias.grad), _np(jgb), atol=1e-5,
                               rtol=0)
    # train mode: the observer seeds from this batch, in both
    jw.train()
    tw.train()
    jy = jw(paddle.to_tensor(x))
    ty = tw(_t(x))
    np.testing.assert_allclose(_np(ty), _np(jy._value), atol=1e-5, rtol=0)
    assert float(tw._fake_quant_input.scale) == \
        float(jw._fake_quant_input.scale._value)


def test_quantized_conv2d_wrapper_matches_jax():
    paddle.seed(5)
    jconv = paddle.nn.Conv2D(3, 4, 3, padding=1)
    tconv = tnn.Conv2D(3, 4, 3, padding=1, device="cpu")
    with torch.no_grad():
        tconv.weight.copy_(_t(np.asarray(jconv.weight._value)))
        tconv.bias.copy_(_t(np.asarray(jconv.bias._value)))
    jw = jquant.QuantizedConv2D(jconv)
    tw = quant.QuantizedConv2D(tconv)
    x = _x(7, (2, 3, 6, 6))
    jy = jw(paddle.to_tensor(x))
    xt = _t(x).requires_grad_()
    ty = tw(xt)
    np.testing.assert_allclose(_np(ty), _np(jy._value), atol=1e-5, rtol=0)
    assert float(tw._fake_quant_input.scale) == \
        float(jw._fake_quant_input.scale._value)
    ty.sum().backward()
    assert tconv.weight.grad is not None and xt.grad is not None
    with pytest.raises(NotImplementedError, match="transposed"):
        quant.QuantizedConv2DTranspose(tconv)
