"""The port's `paddle_tpu_torch.quantization` (quantize_model, the weight-only
QuantizedLinear / QuantizedLinearW4, QuantizedLinearA8W8, PTQ, QAT) against
the JAX package's `paddle_tpu.quantization`, on the same weights and data.

Each case mirrors a JAX test (`tests/test_ptq.py`, `tests/test_qat_e2e.py`)
and holds the port's outputs to the JAX package's, besides the JAX test's
own thresholds:
- quantized buffers (`weight_q`, `weight_scale`, `act_scale`, the
  observers' `seen` and `scale`) equal the JAX buffers exactly when both
  quantize the same f32 weights (one recipe, `quantize_weight`);
- forwards on the same weights within f32 1e-5 (two frameworks' matmuls;
  an int8 activation cannot move: A8W8's static scale divides the same f32
  inputs), W4 within the W4 kernel test's 1e-5;
- training (Adam, the port's `apply_gradients`) follows the JAX run: the
  last losses within 1e-6 absolute or 1e-3 relative (they fall to ~3e-5)
  and the weights within 1e-3 (f32 matmul bits differ), or 3 lr under
  fake quant (`_train_both`), after 10-60 steps; the deployed int8 models are compared on the JAX run's trained
  state, carried across with `models.state_dict_from_numpy`, within 1e-5.
"""
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import quantization as jq
from paddle_tpu.models import GPT
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.nn.quant import QuantizedLinear as JFakeQuantLinear
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import quantization as tq
from paddle_tpu_torch.models import GPT as TGPT
from paddle_tpu_torch.models import gpt_tiny, state_dict_from_numpy
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.nn.quant import QuantizedLinear as FakeQuantLinear
from paddle_tpu_torch.ops import a8w8_matmul as a8
from paddle_tpu_torch.ops import w4_matmul as w4
from paddle_tpu_torch.optimizer import Adam


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


def _np_state(jmodel):
    return {k: np.asarray(v._value) for k, v in jmodel.state_dict().items()}


def _carry(jmodel, tmodel):
    """Load the JAX model's state (parameters and every buffer) into the
    port's model of the same structure; strict, so every key matches."""
    tmodel.load_state_dict(state_dict_from_numpy(_np_state(jmodel),
                                                 device="cpu"))


def _out(v):
    return np.asarray(v._value if hasattr(v, "_value") else
                      v.detach().float().numpy())


def _assert_buffers_equal(jmodel, tmodel):
    js, ts = _np_state(jmodel), tmodel.state_dict()
    assert set(js) == set(ts)
    for k, v in js.items():
        if k.endswith(("weight_q", "weight_scale", "act_scale", "seen")):
            assert ts[k].dtype == torch.from_numpy(np.array(v)).dtype, k
            np.testing.assert_array_equal(ts[k].numpy(), v, err_msg=k)


class JMLP(paddle.nn.Layer):
    def __init__(self, widths=(16, 32, 4)):
        super().__init__()
        self.fc1 = paddle.nn.Linear(widths[0], widths[1])
        self.act = paddle.nn.ReLU()
        self.fc2 = paddle.nn.Linear(widths[1], widths[2])

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class TMLP(torch.nn.Module):
    def __init__(self, widths=(16, 32, 4)):
        super().__init__()
        self.fc1 = tnn.Linear(widths[0], widths[1], device="cpu")
        self.act = tnn.ReLU()
        self.fc2 = tnn.Linear(widths[1], widths[2], device="cpu")

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


def _pair(seed, widths=(16, 32, 4)):
    paddle.seed(seed)
    jm = JMLP(widths)
    tm = TMLP(widths)
    _carry(jm, tm)
    return jm, tm


# ------------------------------------------------------ quantize_model

@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_model_matches_jax(bits):
    """Weight-only int8 / int4 on an MLP (min_out_features 64 leaves the
    8-wide head in float) and on gpt_tiny's logits."""
    jm, tm = _pair(1, (24, 64, 8))
    jq.quantize_model(jm, weight_bits=bits)
    tq.quantize_model(tm, weight_bits=bits)
    cls = tq.QuantizedLinear if bits == 8 else tq.QuantizedLinearW4
    assert type(tm.fc1) is cls and isinstance(tm.fc2, tnn.Linear)
    _assert_buffers_equal(jm, tm)
    x = np.random.RandomState(1).randn(5, 24).astype(np.float32)
    np.testing.assert_allclose(_out(tm(torch.from_numpy(x))),
                               _out(jm(paddle.to_tensor(x))), atol=1e-5,
                               rtol=0)

    paddle.seed(2)
    jg = GPT(jax_gpt_tiny(max_seq_len=64, dtype="float32", remat=False))
    tg = TGPT(gpt_tiny(max_seq_len=64, dtype="float32", remat=False),
              device="cpu")
    _carry(jg, tg)
    jg.eval()
    tg.eval()
    jq.quantize_model(jg, weight_bits=bits)
    tq.quantize_model(tg, weight_bits=bits)
    assert isinstance(tg.blocks[0].fc2, cls)
    _assert_buffers_equal(jg, tg)
    ids = np.random.RandomState(2).randint(0, 1024, (2, 16))
    w4.reset_counts()
    with torch.no_grad():
        got = _out(tg(torch.from_numpy(ids)))
    assert w4.plain_launches == (8 if bits == 4 else 0)   # 2 blocks x 4
    np.testing.assert_allclose(got, _out(jg(paddle.to_tensor(ids))),
                               atol=1e-5, rtol=0)


def test_quantized_linear_a8w8_matches_manual_and_jax():
    """The JAX `test_a8w8_kernel_matches_manual` on the port, and the
    port's layer against the JAX layer on the same Linear."""
    paddle.seed(1)
    jlin = paddle.nn.Linear(8, 32)
    tlin = tnn.Linear(8, 32, device="cpu")
    _carry(jlin, tlin)
    rng = np.random.RandomState(1)
    x = rng.randn(4, 8).astype("float32")
    act_scale = np.abs(x).max() / 127.0
    got = _out(tq.QuantizedLinearA8W8(tlin, act_scale)(torch.from_numpy(x)))
    w = tlin.weight.detach().numpy()
    amax = np.abs(w).max(axis=0, keepdims=True)
    sw = np.maximum(amax / 127.0, 1e-8)
    qw = np.clip(np.round(w / sw), -127, 127).astype(np.int8)
    qx = np.clip(np.round(x / act_scale), -127, 127).astype(np.int8)
    want = (qx.astype(np.int32) @ qw.astype(np.int32)).astype(np.float32) \
        * (sw * act_scale) + tlin.bias.detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    a8.reset_counts()
    jgot = _out(jq.QuantizedLinearA8W8(jlin, act_scale)(paddle.to_tensor(x)))
    np.testing.assert_allclose(got, jgot, rtol=0, atol=1e-5)


# ----------------------------------------------------------------- PTQ

def test_ptq_calibrate_convert_accuracy():
    """JAX `test_ptq_calibrate_convert_accuracy`: the same calibration in
    both packages gives the same abs-max and scales, and the converted
    models agree."""
    jm = paddle.nn.Sequential(paddle.nn.Linear(16, 64), paddle.nn.ReLU(),
                              paddle.nn.Linear(64, 8))
    paddle.seed(0)
    jm = paddle.nn.Sequential(paddle.nn.Linear(16, 64), paddle.nn.ReLU(),
                              paddle.nn.Linear(64, 8))
    tm = tnn.Sequential(tnn.Linear(16, 64, device="cpu"), tnn.ReLU(),
                        tnn.Linear(64, 8, device="cpu"))
    _carry(jm, tm)
    jm.eval()
    tm.eval()
    rng = np.random.RandomState(0)
    calib = [rng.randn(4, 16).astype("float32") for _ in range(4)]
    x_test = rng.randn(8, 16).astype("float32")
    ref = _out(tm(torch.from_numpy(x_test)))
    jptq = jq.PTQ(jm, min_out_features=1)
    tptq = tq.PTQ(tm, min_out_features=1)
    for b in calib:
        jm(paddle.to_tensor(b))
        tm(torch.from_numpy(b))
    assert set(tptq._amax) == set(jptq._amax) == {"0", "2"}
    for k, v in jptq._amax.items():
        assert float(tptq._amax[k]) == v > 0
    jm = jptq.convert()
    tm = tptq.convert()
    kinds = [type(m).__name__ for _, m in tm.named_modules()]
    assert kinds.count("QuantizedLinearA8W8") == 2
    _assert_buffers_equal(jm, tm)
    got = _out(tm(torch.from_numpy(x_test)))
    np.testing.assert_allclose(got, _out(jm(paddle.to_tensor(x_test))),
                               atol=1e-5, rtol=0)
    err = np.abs(got - ref).max() / (np.abs(ref).max() + 1e-9)
    assert err < 0.08, err


def test_hooks_removed_after_convert():
    tm = tnn.Sequential(tnn.Linear(8, 32, device="cpu"))
    ptq = tq.PTQ(tm)
    tm(torch.ones((2, 8)))
    before = {k: float(v) for k, v in ptq._amax.items()}
    ptq.convert()
    # further forwards must not touch the collector
    tm(torch.full((2, 8), 100.0))
    assert {k: float(v) for k, v in ptq._amax.items()} == before
    jm = paddle.nn.Sequential(paddle.nn.Linear(8, 32))
    jptq = jq.PTQ(jm)
    jm(paddle.to_tensor(np.ones((2, 8), np.float32)))
    assert jptq._amax == before


def test_ptq_without_calibration_warns_and_keeps_floats():
    tm = TMLP()
    with pytest.warns(RuntimeWarning, match="observed no activations"):
        tq.PTQ(tm, min_out_features=4).convert()
    assert isinstance(tm.fc1, tnn.Linear)


# ----------------------------------------------------------------- QAT

def _data(n=256, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 16).astype("float32")
    w = rng.randn(16, 4).astype("float32")
    y = np.argmax(x @ w + 0.1 * rng.randn(n, 4), axis=1).astype("int64")
    return x, y


def _jtrain(model, x, y, steps, lr=0.05):
    opt = paddle.optimizer.Adam(learning_rate=lr,
                                parameters=model.parameters())
    for _ in range(steps):
        loss = paddle.nn.functional.cross_entropy(
            model(paddle.to_tensor(x)), paddle.to_tensor(y)).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
    return float(loss)


def _ttrain(model, x, y, steps, lr=0.05):
    params = list(model.parameters())
    opt = Adam(learning_rate=lr, parameters=params)
    for _ in range(steps):
        loss = TF.cross_entropy(model(torch.from_numpy(x)),
                                torch.from_numpy(y)).mean()
        loss.backward()
        opt.apply_gradients([(p, p.grad) for p in params])
        for p in params:
            p.grad = None
    return float(loss.detach())


def _train_both(jm, tm, x, y, steps, lr=0.05):
    """The same steps in both packages. Float weights follow within 1e-3;
    under fake quant a weight or activation that the two runs put on
    neighbouring grid points changes its gradient, and Adam moves each
    weight by up to ~lr a step, so QAT weights are held within 3 lr."""
    jl, tl = _jtrain(jm, x, y, steps, lr), _ttrain(tm, x, y, steps, lr)
    np.testing.assert_allclose(tl, jl, rtol=1e-3, atol=1e-6)
    js = _np_state(jm)
    fake = any(isinstance(m, FakeQuantLinear) for m in tm.modules())
    for k, v in tm.state_dict().items():
        if v.is_floating_point():
            np.testing.assert_allclose(v.numpy(), js[k], rtol=0, err_msg=k,
                                       atol=3 * lr if fake else 1e-3)


def _acc(logits, y):
    return float((np.argmax(logits, -1) == y).mean())


def test_qat_end_to_end_vs_ptq():
    """JAX `test_qat_end_to_end_vs_ptq`: fp training, a PTQ branch and a
    QAT branch, each in both packages; the deployed models compared on the
    JAX run's state."""
    x, y = _data()
    jbase, tbase = _pair(0)
    _train_both(jbase, tbase, x, y, 60)
    state = _np_state(jbase)

    def fresh():
        paddle.seed(0)
        jm, tm = JMLP(), TMLP()
        jm.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
        tm.load_state_dict(state_dict_from_numpy(state, device="cpu"))
        return jm, tm

    jp, tp = fresh()
    jptq, tptq = jq.PTQ(jp), tq.PTQ(tp)
    jp.eval()
    tp.eval()
    jp(paddle.to_tensor(x))
    tp(torch.from_numpy(x))
    jp, tp = jptq.convert(), tptq.convert()
    assert isinstance(tp.fc1, tq.QuantizedLinearA8W8)
    _assert_buffers_equal(jp, tp)
    ptq_logits = _out(tp(torch.from_numpy(x)))
    np.testing.assert_allclose(ptq_logits, _out(jp(paddle.to_tensor(x))),
                               atol=1e-5, rtol=0)

    jm, tm = fresh()
    jqat, tqat = jq.QAT(min_out_features=4), tq.QAT(min_out_features=4)
    jqat.quantize(jm)
    tqat.quantize(tm)
    assert isinstance(tm.fc1, FakeQuantLinear)
    w_before = tm.fc1._inner.weight.detach().clone()
    jm.train()
    tm.train()
    _train_both(jm, tm, x, y, 30, lr=0.01)
    assert not torch.allclose(w_before, tm.fc1._inner.weight)
    # the deployed models on the JAX run's trained state
    _carry(jm, tm)
    jm.eval()
    tm.eval()
    fake = _out(tm(torch.from_numpy(x)))
    np.testing.assert_allclose(fake, _out(jm(paddle.to_tensor(x))),
                               atol=1e-5, rtol=0)
    jqat.convert(jm)
    tqat.convert(tm)
    assert isinstance(tm.fc1, tq.QuantizedLinearA8W8)
    assert isinstance(tm.fc2, tq.QuantizedLinearA8W8)
    _assert_buffers_equal(jm, tm)
    int8 = _out(tm(torch.from_numpy(x)))
    np.testing.assert_allclose(int8, _out(jm(paddle.to_tensor(x))),
                               atol=1e-5, rtol=0)
    assert np.abs(int8 - fake).mean() < 0.1 * np.abs(fake).mean()
    fp_acc = _acc(_out(tbase(torch.from_numpy(x))), y)
    assert _acc(int8, y) >= _acc(ptq_logits, y) - 0.02
    assert _acc(int8, y) >= fp_acc - 0.05


def test_qat_observer_learns_activation_scale():
    x, y = _data(128, seed=3)
    jm, tm = _pair(1)
    for m, q in ((jm, jq.QAT(min_out_features=4, moving_rate=0.5)),
                 (tm, tq.QAT(min_out_features=4, moving_rate=0.5))):
        q.quantize(m)
        m.train()
    _train_both(jm, tm, x, y, 10, lr=0.01)
    observed = float(tm.fc1._fake_quant_input.scale)
    jobserved = float(jm.fc1._fake_quant_input.scale._value)
    np.testing.assert_allclose(observed, jobserved, rtol=1e-6)
    true_amax = float(np.abs(x).max())
    assert 0.2 * true_amax < observed < 2.0 * true_amax
    tq.QAT(min_out_features=4).convert(tm)
    np.testing.assert_allclose(float(tm.fc1.act_scale),
                               max(observed / 127.0, 1e-8), rtol=1e-6)


def test_qat_channel_wise_trains_on_export_grid():
    x, y = _data(128, seed=5)
    jm, tm = _pair(2)
    kw = {"min_out_features": 4,
          "weight_quantize_type": "channel_wise_abs_max"}
    jqat, tqat = jq.QAT(**kw), tq.QAT(**kw)
    jqat.quantize(jm)
    tqat.quantize(tm)
    assert tm.fc1._fake_quant_weight._quant_axis == 1   # [in, out] -> out
    jm.train()
    tm.train()
    _train_both(jm, tm, x, y, 15, lr=0.01)
    _carry(jm, tm)
    jm.eval()
    tm.eval()
    fake = _out(tm(torch.from_numpy(x)))
    tqat.convert(tm)
    jqat.convert(jm)
    int8 = _out(tm(torch.from_numpy(x)))
    np.testing.assert_allclose(int8, _out(jm(paddle.to_tensor(x))),
                               atol=1e-5, rtol=0)
    assert np.abs(int8 - fake).mean() < 0.1 * np.abs(fake).mean()


def test_qat_is_idempotent_and_guards_bits():
    _, tm = _pair(0)
    qat = tq.QAT(min_out_features=4)
    qat.quantize(tm)
    inner = tm.fc1._inner
    qat.quantize(tm)                     # second call must not re-wrap
    assert tm.fc1._inner is inner
    for bits in ({"activation_bits": 4}, {"weight_bits": 4}):
        with pytest.raises(NotImplementedError, match="int8 only"):
            tq.QAT(**bits)
        with pytest.raises(NotImplementedError, match="int8 only"):
            jq.QAT(**bits)
    # convert before any training forward warns about the dead observer,
    # and exports the initial scale 1.0 as JAX does
    with pytest.warns(RuntimeWarning, match="never observed"):
        qat.convert(tm)
    assert float(tm.fc1.act_scale) == np.float32(1.0 / 127.0)


def test_qat_respects_min_out_features():
    jm, tm = _pair(0)
    jq.QAT(min_out_features=10).quantize(jm)
    tq.QAT(min_out_features=10).quantize(tm)
    assert isinstance(tm.fc1, FakeQuantLinear)     # out=32 wrapped
    assert isinstance(tm.fc2, tnn.Linear)          # out=4 skipped
    assert isinstance(jm.fc1, JFakeQuantLinear)
    assert sorted(tm.state_dict()) == sorted(_np_state(jm))


def test_jax_quantized_models_carry_across():
    """A JAX model quantized by PTQ or QAT (observers trained) loads into
    the port's model quantized the same way: every buffer (int8 weights,
    scales, act_scale, seen / scale) arrives with its dtype and the
    outputs agree; the A8W8 kernel's transposed weight follows the load."""
    x, y = _data(64, seed=7)
    jm, tm = _pair(4)
    jqat, tqat = jq.QAT(min_out_features=4), tq.QAT(min_out_features=4)
    jqat.quantize(jm)
    tqat.quantize(tm)
    jm.train()
    _jtrain(jm, x, y, 3, lr=0.01)          # the port model is not trained
    _carry(jm, tm)
    _assert_buffers_equal(jm, tm)
    assert int(tm.fc1._fake_quant_input.seen) == 1
    with warnings.catch_warnings():
        warnings.simplefilter("error")     # the observers were carried
        tqat.convert(tm)
    jqat.convert(jm)
    zeroed = tq.QuantizedLinearA8W8(tnn.Linear(16, 32, device="cpu"), 0.5)
    tm.fc1.load_state_dict({k: torch.zeros_like(v) for k, v in
                            tm.fc1.state_dict().items()})
    assert torch.equal(tm.fc1._weight_qt, torch.zeros(32, 16,
                                                      dtype=torch.int8))
    _carry(jm, tm)                         # the JAX int8 model
    assert torch.equal(tm.fc1._weight_qt, tm.fc1.weight_q.t())
    np.testing.assert_allclose(_out(tm(torch.from_numpy(x))),
                               _out(jm(paddle.to_tensor(x))), atol=1e-5,
                               rtol=0)
    assert zeroed.act_scale.dtype == torch.float32


def test_state_dict_from_numpy_casts_only_floats():
    """`dtype=` casts the floating-point arrays and leaves a quantized
    model's int8 weights and int32 observer counts as they are (it cast
    every array before, turning `weight_q` into bf16 values)."""
    np_state = {"fc.weight_q": np.array([[-127, 5], [0, 127]], np.int8),
                "fc.weight_scale": np.array([[0.5, 0.25]], np.float32),
                "obs.seen": np.array(1, np.int32)}
    sd = state_dict_from_numpy(np_state, device="cpu", dtype=torch.bfloat16)
    assert sd["fc.weight_q"].dtype == torch.int8
    assert sd["obs.seen"].dtype == torch.int32 and sd["obs.seen"].dim() == 0
    assert sd["fc.weight_scale"].dtype == torch.bfloat16
    np.testing.assert_array_equal(sd["fc.weight_q"].numpy(),
                                  np_state["fc.weight_q"])
