"""The port's ResNets (paddle_tpu_torch.vision.models) against the JAX
package's on the CPU: one JAX model's parameters and BatchNorm buffers
carried across by `state_dict_from_numpy`, the same numpy batch from a
seed, the JAX side jitted (`jax.value_and_grad` over `functional_call`,
the JAX `Trainer`'s own route, with its buffer-update sink).

Tolerances, each with its reason:
  * Eval mode (running statistics) at batch 2 x 32 x 32, f32: logits,
    loss and every parameter's gradient within 1e-5 of (1 + the largest
    magnitude): the same math summed in other orders (measured <= 5e-6).
  * Training mode (batch statistics), f32, at 2 x 64 x 64. At 32 x 32
    layer4's BatchNorm normalizes 2 values a channel, which maps their
    difference to +-1 and so multiplies f32 rounding noise by orders of
    magnitude (ResNet-50's logits then differ by ~2 between any two f32
    evaluations); at 64 x 64 it normalizes 8. Buffers after the forward
    within 1e-4 of (1 + magnitude) (measured <= 1.6e-5). Logits and loss
    within 1e-4 for ResNet-18 (measured 1e-5), 2e-3 and 1e-3 for the
    bottleneck nets (measured 3e-4 and 1.2e-4; JAX's own f32 logits
    differ from a float64 evaluation by as much). The gradients are
    ill-conditioned there: JAX's own f32 gradients differ from a float64
    evaluation of the same weights (the port in float64) by up to 3.3% in
    relative Frobenius norm on some parameters (1% on ResNet-18 NHWC's
    stem bias). So each parameter's gradient, from JAX and from the port
    in f32, is held within 10% (relative Frobenius) of the port's float64
    gradient, which a wrong stride, padding, statistic or layout would
    miss by far more.

Trainer + Momentum steps on ResNet-18 are in test_torch_momentum.py.
"""
import functools

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.nn.layer_base import collect_buffer_updates, functional_call
from paddle_tpu.vision import models as JV
from paddle_tpu_torch.models import state_dict_from_numpy
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.vision import models as TV


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


MODELS = [("resnet18", "NHWC"), ("resnet18", "NCHW"), ("resnet50", "NHWC"),
          ("resnet50", "NCHW"), ("resnext50_32x4d", "NHWC"),
          ("resnext50_32x4d", "NCHW")]
NC = 10


@functools.lru_cache(maxsize=None)
def _jax_model(name, df, **kw):
    """A JAX model of seed 7 and its state as numpy (built once a worker:
    the JAX initializers compile a program per shape)."""
    paddle.seed(7)
    jm = getattr(JV, name)(num_classes=NC, data_format=df, **kw)
    return jm, {k: np.asarray(v._value) for k, v in jm.state_dict().items()}


def _port_model(name, df, np_state, dtype=torch.float32, **kw):
    m = getattr(TV, name)(num_classes=NC, data_format=df, device="cpu", **kw)
    m.load_state_dict(state_dict_from_numpy(np_state, device="cpu"))
    return m.to(dtype)


def _batch(df, B=2, S=32, seed=0):
    rng = np.random.RandomState(seed)
    shape = (B, S, S, 3) if df == "NHWC" else (B, 3, S, S)
    return (rng.randn(*shape).astype(np.float32),
            rng.randint(0, NC, (B,)).astype(np.int64))


def _jax_run(jm, x, y, training):
    """(loss, logits, {param: grad}, {buffer: value after}) of one jitted
    forward and backward of the JAX model."""
    jm.train() if training else jm.eval()
    params = {k: p._value for k, p in jm.named_parameters()}
    bufs = {k: b._value for k, b in jm.named_buffers()}
    by_id = {id(b): k for k, b in jm.named_buffers()}

    def loss_fn(p):
        with collect_buffer_updates() as sink:
            with functional_call(jm, {**p, **bufs}):
                logits = jm(paddle.to_tensor(x))
                loss = JF.cross_entropy(logits, paddle.to_tensor(y))
        upd = {by_id[i]: v for i, (_, v) in sink.items()}
        return loss._value, (logits._value, upd)

    (loss, (logits, upd)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)
    after = {**bufs, **upd}
    return (float(loss), np.asarray(logits),
            {k: np.asarray(v) for k, v in grads.items()},
            {k: np.asarray(v) for k, v in after.items()})


def _port_run(m, x, y, training):
    m.train(training)
    logits = m(torch.from_numpy(x).to(next(m.parameters()).dtype))
    loss = F.cross_entropy(logits, torch.from_numpy(y))
    loss.backward()
    return (float(loss.detach()), logits.detach().double().numpy(),
            {k: p.grad.double().numpy() for k, p in m.named_parameters()},
            {k: b.double().numpy() for k, b in m.named_buffers()})


def _close(got, want, rel, what):
    want = np.asarray(want, np.float64)
    err = np.abs(np.asarray(got, np.float64) - want).max()
    assert err <= rel * (1 + np.abs(want).max()), (what, err)


@pytest.mark.parametrize("name,df", MODELS)
def test_eval_logits_loss_grads_match_jax(name, df):
    jm, st = _jax_model(name, df)
    x, y = _batch(df)
    jl, jlog, jg, jb = _jax_run(jm, x, y, training=False)
    tl, tlog, tg, tb = _port_run(_port_model(name, df, st), x, y, False)
    assert tlog.shape == (2, NC)
    _close(tlog, jlog, 1e-5, "logits")
    _close(tl, jl, 1e-5, "loss")
    assert set(tg) == set(jg)
    for k in jg:
        _close(tg[k], jg[k], 1e-5, k)
    for k in jb:
        np.testing.assert_array_equal(tb[k], jb[k])


def _rel_frob(got, want):
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


# ResNet-18 in both layouts and ResNet-50 in bench.py's (eval mode above
# holds all six; the grouped convolution's vjp is held in
# test_torch_conv_bn_pool.py): a jitted ResNet-50 forward and backward
# compiles in ~7 s here
@pytest.mark.parametrize("name,df", MODELS[:3])
def test_train_forward_backward_and_buffers_match_jax(name, df):
    jm, st = _jax_model(name, df)
    x, y = _batch(df, S=64, seed=1)
    jl, jlog, jg, jb = _jax_run(jm, x, y, training=True)
    tl, tlog, tg, tb = _port_run(_port_model(name, df, st), x, y, True)
    assert set(tb) == set(jb) and set(tg) == set(jg)
    for k in jb:
        _close(tb[k], jb[k], 1e-4, k)
    moved = [k for k in jb if not np.array_equal(jb[k], st[k])]
    assert len(moved) == len(jb), "every BatchNorm buffer moves"
    tight = name == "resnet18"
    _close(tlog, jlog, 1e-4 if tight else 2e-3, "logits")
    _close(tl, jl, 1e-4 if tight else 1e-3, "loss")
    dl, dlog, dg, _ = _port_run(_port_model(name, df, st, torch.float64),
                                x, y, True)
    _close(jlog, dlog, 1e-4 if tight else 2e-3, "JAX logits vs float64")
    for k in dg:
        for who, g in (("jax", jg[k]), ("port", tg[k])):
            assert _rel_frob(g, dg[k]) <= 0.1, (who, k, _rel_frob(g, dg[k]))


def test_stem_s2d_computes_the_plain_stem():
    """stem_s2d (the JAX package's space-to-depth stem, an exact rewrite)
    is the plain 7x7/s2 convolution in the port: the same logits as the
    JAX s2d model; NCHW refused at construction, odd H or W at the
    call."""
    jm, st = _jax_model("resnet18", "NHWC", stem_s2d=True)
    x, y = _batch("NHWC")
    jl, jlog, jg, _ = _jax_run(jm, x, y, training=False)
    m = _port_model("resnet18", "NHWC", st, stem_s2d=True)
    tl, tlog, tg, _ = _port_run(m, x, y, False)
    _close(tlog, jlog, 1e-5, "logits")
    _close(tg["conv1.weight"], jg["conv1.weight"], 1e-5, "stem grad")
    with pytest.raises(ValueError):
        TV.resnet18(data_format="NCHW", stem_s2d=True, device="cpu")
    with pytest.raises(ValueError):
        m(torch.zeros(1, 33, 32, 3))


def test_own_init_follows_the_jax_recipe():
    """The port's seeded ResNet-50: the JAX keys, shapes and buffers,
    convolutions U(+-1/sqrt(fan_in)), BatchNorm 1/0 with buffers 0/1, the
    fc XavierUniform with a bias 0; the same numbers for the same seed,
    other numbers for another."""
    sd = TV.resnet50(device="cpu", seed=3).state_dict()
    _, jst = _jax_model("resnet50", "NCHW")
    assert list(sd) == list(jst)
    assert len(sd) == 267 and sd["fc.weight"].shape == (2048, 1000)
    for k, v in sd.items():
        if k.endswith("_mean") or k.endswith("bias"):
            assert not v.any(), k
        elif k.endswith("_variance") or (".bn" in k or k.startswith("bn")
                                         or "downsample.1" in k):
            assert torch.equal(v, torch.ones_like(v)), k
        elif k == "fc.weight":
            limit = (6.0 / (2048 + 1000)) ** 0.5
            assert float(v.abs().max()) <= limit
        else:
            bound = 1 / np.sqrt(np.prod(v.shape[1:]))
            assert float(v.abs().max()) <= bound, k
            assert abs(float(v.std()) / (bound / 3 ** 0.5) - 1) < 0.2, k
    again = TV.resnet50(device="cpu", seed=3).state_dict()
    other = TV.resnet50(device="cpu", seed=4).state_dict()
    assert all(torch.equal(sd[k], again[k]) for k in sd)
    assert not torch.equal(sd["conv1.weight"], other["conv1.weight"])
    with pytest.raises(NotImplementedError):
        TV.resnet50(pretrained=True, device="cpu")


@pytest.mark.parametrize("bf16", [False, True])
def test_state_dict_carries_parameters_and_buffers(bf16):
    """A JAX ResNet's parameters and buffers, after a training forward
    moved the buffers, load into the port by name, bit for bit, in f32
    and (both models cast) in bf16; the features without pool and fc
    (with_pool=False, num_classes 0) match."""
    paddle.seed(5)
    jm = JV.resnet18(num_classes=0, with_pool=False, data_format="NHWC")
    x, _ = _batch("NHWC")
    jm(paddle.to_tensor(x))
    if bf16:
        jm.bfloat16()
    st = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    m = TV.resnet18(num_classes=0, with_pool=False, data_format="NHWC",
                    device="cpu")
    if bf16:
        m.bfloat16()
    m.load_state_dict(state_dict_from_numpy(st, device="cpu"))
    for k, v in m.state_dict().items():
        assert v.dtype == (torch.bfloat16 if bf16 else torch.float32), k
        np.testing.assert_array_equal(v.float().numpy(),
                                      st[k].astype(np.float32))
    assert not hasattr(m, "fc") and not hasattr(m, "avgpool")
    if not bf16:
        jm.eval()
        m.eval()
        want = np.asarray(jm(paddle.to_tensor(x))._value)
        with torch.no_grad():
            got = m(torch.from_numpy(x)).numpy()
        assert got.shape == want.shape == (2, 1, 1, 512)
        _close(got, want, 1e-5, "features")
