"""The port's convolution, batch norm and pooling functionals and layers
(paddle_tpu_torch.nn) against the JAX package's on the CPU: the same
numpy inputs from a seed through `paddle_tpu.nn.functional` (values, and
gradients by `jax.vjp`) and through the port (values, and autograd).

Tolerances, each with its reason:
  * f32 convolutions, values and gradients: 1e-5 of (1 + the largest
    magnitude of the reference), the same products summed in another
    order (at most a few hundred terms here, ~1e-7 relative each).
  * bf16 (the f32-into-bf16-weight cast, bf16 batch norm and pooling):
    one bf16 step (2^-7 relative: 8 significant bits) of the reference's
    largest magnitude, plus 1e-6: the f32 sums inside differ by rounding
    and can move a result across one bf16 rounding boundary. bf16 batch
    norm from bf16 running statistics (eval, `use_global_stats`): two
    steps, since rsqrt(var + eps) is rounded to bf16 there and XLA's and
    PyTorch's f32 rsqrt differ in their last bits (1 of 6 channels here
    lands on the other side of a bf16 boundary), an ulp of rstd that
    every output of its channel carries, before their own rounding.
  * f32 batch norm, values, gradients and running statistics: 1e-5 of
    (1 + the largest magnitude): the f32 mean and variance sum the same
    values in another order.
  * The bf16 running-statistic update is held bit-equal, on inputs whose
    f32 mean and variance are exact in any order (multiples of 1/16 over
    a power-of-two count): bf16 momentum 0.8984375 and 1 - momentum
    0.10009765625, each product rounded. Rounding the scalars in f32
    instead (PyTorch's `0.9 * t`) gives other bits on ~30% of channels.
  * Max pooling's values are exact; its gradients are held equal to
    `jax.vjp`'s on windows of tied values (the first largest element of a
    window takes the gradient).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.framework.core import Tensor
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.tensor import flatten


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


def _j(a):
    return jnp.asarray(a)


def _t(a):
    """numpy -> a torch copy (numpy's bfloat16 extension type through
    f32). A copy, never a view: jnp.asarray may alias a numpy array on the
    CPU, and JAX's dispatch is asynchronous, so a port op writing in place
    through a view could change the JAX reference's input before JAX
    reads it."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).bfloat16()
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().float().numpy()


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(got, want, rel):
    want = _f32(want)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=rel * (1 + np.abs(want).max()))


def _bf16_close(got, want, steps=1):
    want = _f32(want)
    np.testing.assert_allclose(
        _np(got), want, rtol=0,
        atol=steps * 2.0 ** -7 * np.abs(want).max() + 1e-6)


def _vjp(fn, args, g):
    """Values and input gradients of a JAX-package functional: `fn` takes
    raw jax arrays (wrapped in Tensors inside) and returns a raw array."""
    out, pull = jax.vjp(fn, *[_j(a) for a in args])
    return out, pull(_j(g))


def _torch_grads(fn, args, g):
    ts = [_t(a).requires_grad_() for a in args]
    out = fn(*ts)
    out.backward(_t(g))
    return out, [t.grad for t in ts]


# (padding, stride, dilation, groups, kernel, the JAX padding): every
# padding form. The JAX `_padding` raises TypeError on the nested forms
# in 2-D (it reads 2 or 4 entries as ints first), so those cases hold the
# port's nested form against JAX's flat form of the same pads.
CONV_CASES = [
    (0, 1, 1, 1, 3, None), (1, 2, 1, 1, 3, None), ([1, 2], 1, 1, 1, 3, None),
    ([0, 1, 2, 1], 2, 1, 1, 3, None),
    ([[0, 0], [0, 0], [1, 0], [2, 1]], 1, 1, 1, 3, [1, 0, 2, 1]),
    ([[1, 2], [0, 1]], 1, 1, 1, 2, [1, 2, 0, 1]),
    ("SAME", 2, 1, 1, 4, None), ("same", 1, 1, 1, 3, None),
    ("VALID", 2, 1, 1, 3, None), (2, 1, 2, 1, 3, None),
    (1, 1, 1, 4, 3, None), (1, 2, 1, 8, 3, None), (3, 2, 1, 1, 7, None),
    (0, 2, 1, 1, 1, None), ([-1, 2, 1, 0], 1, 1, 1, 3, None)]


@pytest.mark.parametrize("df", ["NCHW", "NHWC"])
@pytest.mark.parametrize("case", CONV_CASES, ids=str)
def test_conv2d_values_and_vjp_match_jax(case, df):
    padding, stride, dilation, groups, k, jpadding = case
    rng = np.random.RandomState(0)
    C, O = 8, 16
    x = rng.randn(2, 9, 10, C) if df == "NHWC" else rng.randn(2, C, 9, 10)
    x = x.astype(np.float32)
    w = (rng.randn(O, C // groups, k, k) * 0.3).astype(np.float32)
    b = rng.randn(O).astype(np.float32)
    kw = dict(stride=stride, padding=padding, dilation=dilation,
              groups=groups, data_format=df)

    jkw = kw if jpadding is None else {**kw, "padding": jpadding}

    def jfn(x_, w_, b_):
        return JF.conv2d(Tensor(x_), Tensor(w_), Tensor(b_), **jkw)._value

    jout = jfn(_j(x), _j(w), _j(b))
    g = rng.randn(*jout.shape).astype(np.float32)
    jout, jgrads = _vjp(jfn, (x, w, b), g)
    out, grads = _torch_grads(lambda *a: F.conv2d(*a, **kw), (x, w, b), g)
    assert tuple(out.shape) == tuple(jout.shape)
    _close(out, jout, 1e-5)
    for got, want in zip(grads, jgrads):
        _close(got, want, 1e-5)


@pytest.mark.parametrize("df", ["NCHW", "NHWC"])
def test_conv2d_casts_f32_input_to_a_bf16_weight(df):
    """bench.py feeds f32 images to a bf16 model: the stem convolution
    computes in bf16 (`amp_compute_cast`), and a bf16 x with an f32
    weight casts the weight to bf16 (the JAX `w.astype(v.dtype)`)."""
    rng = np.random.RandomState(1)
    x = rng.randn(2, 16, 16, 3) if df == "NHWC" else rng.randn(2, 3, 16, 16)
    x = x.astype(np.float32)
    w = (rng.randn(8, 3, 7, 7) * 0.1).astype(np.float32)
    wb = _j(w).astype(jnp.bfloat16)
    kw = dict(stride=2, padding=3, data_format=df)
    want = JF.conv2d(paddle.to_tensor(_j(x)), Tensor(wb), **kw)._value
    got = F.conv2d(_t(x), _t(w).bfloat16(), **kw)
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    _bf16_close(got, want)
    xb = _j(x).astype(jnp.bfloat16)
    want = JF.conv2d(Tensor(xb), paddle.to_tensor(_j(w)), **kw)._value
    got = F.conv2d(_t(x).bfloat16(), _t(w), **kw)
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    _bf16_close(got, want)


def _jbn(x, rm, rv, w, b, training, df, momentum=0.9, use_global=None):
    """The JAX F.batch_norm with eager buffers: (out, new running mean,
    new running variance)."""
    tm, tv = Tensor(_j(rm)), Tensor(_j(rv))
    out = JF.batch_norm(Tensor(_j(x)), tm, tv,
                        None if w is None else Tensor(_j(w)),
                        None if b is None else Tensor(_j(b)),
                        training=training, momentum=momentum,
                        data_format=df, use_global_stats=use_global)
    return [np.asarray(v) for v in (out._value, tm._value, tv._value)]


def _bn_inputs(rng, df, dtype, C=6):
    shape = (4, 5, 3, C) if df == "NHWC" else (4, C, 5, 3)
    x = (rng.randn(*shape) * 2 + 0.5).astype(np.float32)
    rm = (rng.randn(C) * 0.1).astype(np.float32)
    rv = (rng.rand(C) + 0.5).astype(np.float32)
    w = (rng.rand(C) + 0.5).astype(np.float32)
    b = rng.randn(C).astype(np.float32)
    cast = (lambda a: np.asarray(_j(a).astype(jnp.bfloat16))) \
        if dtype == "bfloat16" else (lambda a: a)
    return [cast(a) for a in (x, rm, rv, w, b)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("df", ["NCHW", "NHWC"])
@pytest.mark.parametrize("mode", ["train", "eval", "global_stats_in_train"])
def test_batch_norm_values_and_running_stats_match_jax(mode, df, dtype):
    rng = np.random.RandomState(2)
    x, rm, rv, w, b = _bn_inputs(rng, df, dtype)
    training = mode != "eval"
    use_global = True if mode == "global_stats_in_train" else None
    jout, jrm, jrv = _jbn(x, rm, rv, w, b, training, df,
                          use_global=use_global)
    trm, trv = _t(rm), _t(rv)
    out = F.batch_norm(_t(x), trm, trv, _t(w), _t(b), training=training,
                       data_format=df, use_global_stats=use_global)
    assert out.dtype == _t(x).dtype and trm.dtype == _t(rm).dtype
    if dtype == "float32":
        for got, want in ((out, jout), (trm, jrm), (trv, jrv)):
            _close(got, want, 1e-5)
    else:
        for got, want in ((out, jout), (trm, jrm), (trv, jrv)):
            _bf16_close(got, want, 1 if mode == "train" else 2)
    if mode != "train":
        assert torch.equal(trm, _t(rm)) and torch.equal(trv, _t(rv))


@pytest.mark.parametrize("df", ["NCHW", "NHWC"])
@pytest.mark.parametrize("affine", [True, False])
def test_batch_norm_vjp_matches_jax(df, affine):
    """Gradients through the batch statistics (training) to x, weight and
    bias, f32."""
    rng = np.random.RandomState(3)
    x, rm, rv, w, b = _bn_inputs(rng, df, "float32")
    g = rng.randn(*x.shape).astype(np.float32)
    args = (x, w, b) if affine else (x,)

    def jfn(x_, *wb):
        return JF.batch_norm(Tensor(x_), Tensor(_j(rm)), Tensor(_j(rv)),
                             *(Tensor(a) for a in wb), training=True,
                             data_format=df)._value

    jout, jgrads = _vjp(jfn, args, g)
    out, grads = _torch_grads(
        lambda x_, *wb: F.batch_norm(x_, _t(rm), _t(rv), *wb, training=True,
                                     data_format=df), args, g)
    _close(out, jout, 1e-5)
    for got, want in zip(grads, jgrads):
        _close(got, want, 1e-5)


@pytest.mark.parametrize("momentum", [0.9, 0.99, 0.1])
def test_bf16_running_stats_bit_equal_to_jax(momentum):
    """bf16 buffers (a bf16 model's) after one training forward: the f32
    batch mean and variance are exact here, so the buffers' bits are the
    update's alone. Random bf16 running statistics, 4096 channels."""
    rng = np.random.RandomState(4)
    C = 4096
    x = (rng.randint(-8, 9, (2, 4, 4, C)) / 16.0).astype(np.float32)
    xb = np.asarray(_j(x).astype(jnp.bfloat16))
    rm = np.asarray(_j(rng.randn(C)).astype(jnp.bfloat16))
    rv = np.asarray(_j(rng.rand(C) * 2).astype(jnp.bfloat16))
    jout, jrm, jrv = _jbn(xb, rm, rv, None, None, True, "NHWC", momentum)
    trm, trv = _t(rm), _t(rv)
    out = F.batch_norm(_t(xb), trm, trv, training=True, momentum=momentum,
                       data_format="NHWC")
    for got, want in ((trm, jrm), (trv, jrv)):
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(_np(got), _f32(want))
    _bf16_close(out, jout)
    # the control: the scalars kept in f32 (PyTorch's own `0.9 * t`) part
    # from JAX's bits on many channels
    batch_mean = _t(x).mean((0, 1, 2))
    naive = (momentum * _t(rm) + (1 - momentum) * batch_mean.bfloat16())
    assert (_np(naive) != _f32(jrm)).sum() > C // 20


def _raw_pool(kernel, stride, padding, df, ceil_mode):
    from paddle_tpu.nn.functional.pooling import _pool

    def fn(v):
        return _pool(Tensor(v), kernel, stride, padding, 2, "max",
                     df == "NHWC", ceil_mode)._value
    return fn


# (kernel, stride, padding, ceil_mode, H, W)
POOL_CASES = [(3, 2, 1, False, 9, 9), (3, 2, 1, True, 8, 10),
              (2, 2, 0, True, 7, 9), (3, 1, 0, False, 6, 6),
              (3, 2, [0, 1], False, 9, 8), (3, 2, [1, 0, 2, 1], True, 8, 9),
              (2, None, "SAME", False, 7, 7), (3, 2, "VALID", True, 10, 9),
              (2, 3, 2, False, 9, 9), ([3, 2], [2, 1], [1, 1], True, 9, 7)]


@pytest.mark.parametrize("df", ["NCHW", "NHWC"])
@pytest.mark.parametrize("case", POOL_CASES, ids=str)
def test_max_pool2d_values_and_tie_gradients_equal_jax(case, df):
    """Values exact; gradients equal `jax.vjp`'s on windows of ties (a
    post-ReLU map of zeros and a few values) and on distinct values."""
    kernel, stride, padding, ceil_mode, H, W = case
    rng = np.random.RandomState(5)
    C = 3
    shape = (2, H, W, C) if df == "NHWC" else (2, C, H, W)
    ties = np.maximum(rng.randint(-3, 2, shape), 0).astype(np.float32)
    for x in (ties, rng.randn(*shape).astype(np.float32)):
        fn = _raw_pool(kernel, stride, padding, df, ceil_mode)
        jout = fn(_j(x))
        g = rng.randn(*jout.shape).astype(np.float32)
        jout, (jg,) = _vjp(fn, (x,), g)
        out, (tg,) = _torch_grads(
            lambda v: F.max_pool2d(v, kernel, stride, padding,
                                   ceil_mode=ceil_mode, data_format=df),
            (x,), g)
        np.testing.assert_array_equal(_np(out), _f32(jout))
        np.testing.assert_array_equal(_np(tg), _f32(jg))


def test_max_pool2d_bf16_and_return_mask():
    rng = np.random.RandomState(6)
    x = np.asarray(_j(rng.randn(2, 9, 9, 4)).astype(jnp.bfloat16))
    want = JF.max_pool2d(Tensor(_j(x)), 3, 2, 1, data_format="NHWC")._value
    got = F.max_pool2d(_t(x), 3, 2, 1, data_format="NHWC")
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got), _f32(want))
    with pytest.raises(NotImplementedError):
        F.max_pool2d(_t(x), 3, return_mask=True)


# (output_size, H, W): ResNet's (1, 1) at 7 x 7 and at 1 x 1, uneven bins
ADAPTIVE_CASES = [((1, 1), 7, 7), ((1, 1), 1, 1), (1, 4, 6), ((2, 3), 5, 7),
                  ((3, None), 7, 4), (4, 4, 4)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("df", ["NCHW", "NHWC"])
@pytest.mark.parametrize("case", ADAPTIVE_CASES, ids=str)
def test_adaptive_avg_pool2d_matches_jax(case, df, dtype):
    """Values and the vjp; bf16 rounds each axis' mean (H first, then W)
    as the JAX `_adaptive_avg` does, from an f32 sum."""
    osz, H, W = case
    rng = np.random.RandomState(7)
    shape = (2, H, W, 5) if df == "NHWC" else (2, 5, H, W)
    x = rng.randn(*shape).astype(np.float32)
    if dtype == "bfloat16":
        x = np.asarray(_j(x).astype(jnp.bfloat16))

    def jfn(v):
        return JF.adaptive_avg_pool2d(Tensor(v), osz, data_format=df)._value

    jout = jfn(_j(x))
    g = rng.randn(*jout.shape).astype(np.float32)
    if dtype == "bfloat16":
        g = np.asarray(_j(g).astype(jnp.bfloat16))
    jout, (jg,) = _vjp(jfn, (x,), g)
    out, (tg,) = _torch_grads(
        lambda v: F.adaptive_avg_pool2d(v, osz, data_format=df), (x,), g)
    assert tuple(out.shape) == tuple(jout.shape)
    if dtype == "float32":
        _close(out, jout, 1e-6)
        _close(tg, jg, 1e-6)
    else:
        assert out.dtype == torch.bfloat16
        _bf16_close(out, jout)
        _bf16_close(tg, jg)


@pytest.mark.parametrize("axes", [(1, -1), (0, 2), (2, 3), (0, -1), (3, 3)])
def test_flatten_matches_jax(axes):
    from paddle_tpu.tensor.manipulation import flatten as jflatten
    x = np.arange(2 * 3 * 4 * 5, dtype=np.float32).reshape(2, 3, 4, 5)
    want = jflatten(paddle.to_tensor(x), *axes).numpy()
    got = flatten(torch.from_numpy(x), *axes)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_layers_follow_the_jax_defaults():
    """Conv2D / BatchNorm2D / MaxPool2D / AdaptiveAvgPool2D / ReLU /
    Sequential: Paddle's names and shapes, the JAX initializers' ranges,
    the data format resolved at construction, unported options raising."""
    import paddle_tpu.nn as jnn
    paddle.seed(0)
    jconv = jnn.Conv2D(8, 16, 3, groups=2, data_format="NHWC")
    g = torch.Generator().manual_seed(0)
    conv = tnn.Conv2D(8, 16, 3, groups=2, data_format="NHWC", device="cpu",
                      generator=g)
    assert [k for k, _ in conv.named_parameters()] == \
        [k for k, _ in jconv.named_parameters()]
    assert tuple(conv.weight.shape) == tuple(jconv.weight.shape) == \
        (16, 4, 3, 3)
    bound = 1 / 36 ** 0.5
    for t in (conv.weight.detach(), conv.bias.detach()):
        assert float(t.abs().max()) <= bound
        assert abs(float(t.std()) / (bound / 3 ** 0.5) - 1) < 0.35
    assert tnn.Conv2D(8, 16, 1, bias_attr=False, device="cpu").bias is None
    bn = tnn.BatchNorm2D(16, data_format="NHWC", device="cpu")
    jbn = jnn.BatchNorm2D(16, data_format="NHWC")
    assert list(bn.state_dict()) == list(jbn.state_dict())
    assert torch.equal(bn.weight, torch.ones(16))
    assert torch.equal(bn._variance, torch.ones(16))
    assert not bn.bias.any() and not bn._mean.any()
    seq = tnn.Sequential(conv, bn, tnn.ReLU(),
                         tnn.MaxPool2D(3, 2, 1, data_format="NHWC"),
                         tnn.AdaptiveAvgPool2D(1, data_format="NHWC"))
    jseq = jnn.Sequential(jconv, jbn)
    assert list(seq.state_dict())[:6] == list(jseq.state_dict())
    assert seq(torch.randn(2, 9, 9, 8)).shape == (2, 1, 1, 16)
    named = tnn.Sequential(("a", tnn.ReLU()), ("b", tnn.ReLU()))
    assert [n for n, _ in named.named_children()] == ["a", "b"]
    prev = tnn.set_channels_last(True)
    try:
        assert tnn.Conv2D(3, 4, 1, device="cpu")._data_format == "NHWC"
        assert tnn.MaxPool2D(2).data_format == "NHWC"
    finally:
        tnn.set_channels_last(prev)
    assert tnn.BatchNorm2D(4, device="cpu")._data_format == "NCHW"
    for bad in (lambda: tnn.Conv2D(3, 4, 1, padding_mode="reflect",
                                   device="cpu"),
                lambda: tnn.Conv2D(3, 4, 1, weight_attr=object(),
                                   device="cpu"),
                lambda: tnn.Conv2D(3, 4, 1, weight_attr=False,
                                   device="cpu"),
                lambda: tnn.BatchNorm2D(4, bias_attr=object(),
                                        device="cpu"),
                lambda: tnn.MaxPool2D(2, return_mask=True)):
        with pytest.raises(NotImplementedError):
            bad()
