"""Four places where the port's API answered differently from the JAX
package's, each held against JAX:

  * `F.linear` on mixed dtypes: a low-precision weight casts an f32 x
    down (`amp_compute_cast`), any other mix promotes as `v @ w` does in
    JAX, and the bias is added in the output's dtype. So `GPT` on the
    default config (f32 parameters, `dtype="bfloat16"`) runs, with the
    JAX model's logits;
  * Paddle's positional order for `F.dropout`, `nn.Dropout`,
    `F.cross_entropy`, `nn.Embedding`, `Adam`, `AdamW`, `F.linear` and
    `F.scaled_dot_product_attention`, with the port-only parameters
    keyword-only; `F.dropout`'s `axis` and `mode`, bit-equal to JAX on
    the same salt; the options still unported raise;
  * `GPTConfig` takes every `sp_mode` / `tp_overlap` value the JAX config
    takes (and `tp_overlap_chunks`), refuses the same bad values, and
    runs the plain path on one device;
  * the untied head returns its Linear's dtype, while the criterion and
    the Trainer still give an f32 loss.

Tolerances: `F.linear` within 1e-6 of |x| @ |w| + |b| in f32 (one
product of 16 terms, summed in another order) and, where the output is bf16, two bf16 steps
of |x| @ |w| + |b| (each package rounds the product and then the sum);
GPT logits within 1e-5 (two f32 layers, |logits| < 2; measured 6e-7), bf16 logits within 0.05 (bf16 layers, rounded at other
places in the two packages; |logits| < 2). Dropout is exact (integer
masks, one f32 division).
"""
import inspect

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import GPT as JaxGPT
from paddle_tpu.models import GPTConfig as JaxGPTConfig
from paddle_tpu.models import GPTPretrainingCriterion as JaxCriterion
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.nn.functional import common as JC
from paddle_tpu.nn.functional import extension as JE
from paddle_tpu.nn.functional import loss as JL
from paddle_tpu_torch import nn
from paddle_tpu_torch.distributed import Trainer
from paddle_tpu_torch.models import (GPT, GPTConfig, GPTPretrainingCriterion,
                                     gpt_tiny, state_dict_from_numpy)
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import Adam, AdamW


def _jt(a, dtype="float32"):
    return paddle.to_tensor(a).astype(dtype)


def _np(t):
    return np.asarray(t._value.astype("float32"))


# ------------------------------------------------------------ F.linear

@pytest.mark.parametrize("xd,wd,bd,out", [
    ("float32", "bfloat16", "bfloat16", "bfloat16"),   # cast x down
    ("bfloat16", "float32", "float32", "float32"),     # promote
    ("bfloat16", "float32", "bfloat16", "float32"),
    ("float32", "float32", None, "float32")])
def test_linear_dtype_rule_matches_jax(xd, wd, bd, out):
    rng = np.random.RandomState(0)
    x, w, b = (rng.randn(3, 16).astype(np.float32),
               rng.randn(16, 8).astype(np.float32),
               rng.randn(8).astype(np.float32))
    want = JC.linear(_jt(x, xd), _jt(w, wd),
                     None if bd is None else _jt(b, bd))
    tb = None if bd is None else torch.from_numpy(b).to(getattr(torch, bd))
    got = F.linear(torch.from_numpy(x).to(getattr(torch, xd)),
                   torch.from_numpy(w).to(getattr(torch, wd)), tb)
    assert str(want._value.dtype) == out and got.dtype == getattr(torch, out)
    # bf16 out: each side rounds the product, then the sum, to bf16
    scale = np.abs(x) @ np.abs(w) + np.abs(b)
    tol = (2 ** -6 if out == "bfloat16" else 1e-6) * scale
    assert np.all(np.abs(got.float().numpy() - _np(want)) <= tol)


def _jax_model(**kw):
    paddle.seed(7)
    jm = JaxGPT(jax_gpt_tiny(**kw))
    jm.eval()
    return jm


def _port_model(jm, **kw):
    m = GPT(gpt_tiny(**kw), device="cpu")
    m.load_state_dict(state_dict_from_numpy(
        {k: np.asarray(v._value) for k, v in jm.state_dict().items()},
        device="cpu"))
    m.eval()
    return m


IDS = np.random.RandomState(0).randint(0, 1024, (2, 16)).astype("int32")


@pytest.mark.parametrize("tie", [True, False])
def test_gpt_default_config_matches_jax(tie):
    """The default `dtype="bfloat16"` with f32 parameters: the embeddings
    round to bf16, the first Linear promotes back to f32 (JAX's rule)."""
    jm = _jax_model(tie_embeddings=tie)
    want = np.asarray(jm(paddle.to_tensor(IDS))._value)
    with torch.no_grad():
        got = _port_model(jm, tie_embeddings=tie)(torch.from_numpy(IDS))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


# -------------------------------------------------- positional order

_SIGNATURES = [   # (port callable, JAX callable, port-only keywords)
    (F.dropout, JC.dropout, ("generator",)),
    (nn.Dropout.__init__, paddle.nn.Dropout.__init__, ("generator",)),
    (F.cross_entropy, JL.cross_entropy, ()),
    (nn.Embedding.__init__, paddle.nn.Embedding.__init__,
     ("weight_init", "device", "generator")),
    (Adam.__init__, paddle.optimizer.Adam.__init__, ()),
    (AdamW.__init__, paddle.optimizer.AdamW.__init__, ()),
    (F.linear, JC.linear, ()),
    (F.scaled_dot_product_attention, JE.scaled_dot_product_attention,
     ("dropout_seed", "generator")),
]


def _positional(fn):
    return [p.name for p in inspect.signature(fn).parameters.values()
            if p.kind == p.POSITIONAL_OR_KEYWORD and p.name != "self"]


@pytest.mark.parametrize("port,ref,port_only", _SIGNATURES,
                         ids=lambda v: getattr(v, "__qualname__", None))
def test_positional_parameters_follow_paddle(port, ref, port_only):
    mine = _positional(port)
    assert mine == _positional(ref)[:len(mine)]
    params = inspect.signature(port).parameters
    for name in port_only:
        assert params[name].kind == inspect.Parameter.KEYWORD_ONLY, name


def _salt(key):
    return int(jax.random.randint(key, (), 0, 2 ** 31 - 1))


@pytest.mark.parametrize("axis", [None, 0, [0, 2], -1])
@pytest.mark.parametrize("mode", ["upscale_in_train", "downscale_in_infer"])
def test_dropout_axis_and_mode_equal_jax(axis, mode, monkeypatch):
    """The mask over the listed axes only, broadcast over the others
    (axes matched as given: -1 lists none, so one draw covers x), and
    keep-without-scaling for 'downscale_in_infer', bit for bit."""
    key = jax.random.PRNGKey(5)
    monkeypatch.setattr(JC, "next_key", lambda: key)
    monkeypatch.setattr(F, "_draw_salt", lambda generator=None: _salt(key))
    x = np.random.RandomState(1).randn(6, 5, 33).astype(np.float32)
    want = JC.dropout(paddle.to_tensor(x), 0.4, axis, True, mode).numpy()
    got = F.dropout(torch.from_numpy(x), 0.4, axis, True, mode).numpy()
    assert np.array_equal(got, want)
    if axis != -1:
        assert 0 < (got == 0).mean() < 1
    layer = nn.Dropout(0.4, axis, mode)
    assert np.array_equal(layer(torch.from_numpy(x)).numpy(), want)
    layer.eval()
    assert np.array_equal(layer(torch.from_numpy(x)).numpy(), x)


def test_positional_training_flag_reaches_dropout():
    """`F.dropout(x, p, axis, training)`: a positional False means eval."""
    x = torch.ones(4, 8)
    assert F.dropout(x, 0.5, None, False) is x
    assert not torch.equal(F.dropout(x, 0.5, 0), x)


def test_unported_options_raise():
    with pytest.raises(NotImplementedError):
        nn.Embedding(10, 4, None, True, device="cpu")
    with pytest.raises(NotImplementedError):
        F.cross_entropy(torch.zeros(2, 3), torch.zeros(2, dtype=torch.long),
                        torch.ones(3))
    with pytest.raises(NotImplementedError):
        AdamW(1e-3, lr_ratio=lambda p: 1.0)
    with pytest.raises(NotImplementedError):
        AdamW(1e-3, apply_decay_param_fun=lambda n: True)
    with pytest.raises(NotImplementedError):
        Adam(1e-3, lazy_mode=True)
    with pytest.raises(ValueError):
        F.dropout(torch.ones(2), 0.5, mode="upscale")


# ------------------------------------------------------------ GPTConfig

@pytest.mark.parametrize("sp_mode,tp_overlap", [
    ("zigzag", "off"), ("ulysses", "bulk"), ("ring", "ring")])
def test_gpt_config_parallel_values_run_plain_path(sp_mode, tp_overlap):
    kw = dict(sp_mode=sp_mode, tp_overlap=tp_overlap, tp_overlap_chunks=2)
    cfg, jcfg = gpt_tiny(**kw), jax_gpt_tiny(**kw)
    assert (cfg.sp_mode, cfg.tp_overlap, cfg.tp_overlap_chunks) == \
        (jcfg.sp_mode, jcfg.tp_overlap, jcfg.tp_overlap_chunks)
    assert GPTConfig().tp_overlap_chunks == JaxGPTConfig().tp_overlap_chunks
    jm = _jax_model()
    with torch.no_grad():
        plain = _port_model(jm)(torch.from_numpy(IDS))
        got = _port_model(jm, **kw)(torch.from_numpy(IDS))
    assert torch.equal(got, plain)


@pytest.mark.parametrize("bad", [dict(sp_mode="tree"),
                                 dict(tp_overlap="async")])
def test_gpt_config_refuses_what_jax_refuses(bad):
    with pytest.raises(ValueError):
        JaxGPTConfig(**bad)
    with pytest.raises(ValueError):
        GPTConfig(**bad)


# ------------------------------------------------------------ untied head

def test_untied_head_returns_linear_dtype_loss_stays_f32():
    jm = _jax_model(tie_embeddings=False)
    m = _port_model(jm, tie_embeddings=False).bfloat16()
    jm.to(dtype="bfloat16")
    want = jm(paddle.to_tensor(IDS))
    with torch.no_grad():
        got = m(torch.from_numpy(IDS))
    assert str(want._value.dtype) == "bfloat16" and got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), _np(want), atol=0.05,
                               rtol=0)
    labels = np.roll(IDS, -1, axis=1)
    jloss = JaxCriterion()(want, paddle.to_tensor(labels))
    loss = GPTPretrainingCriterion()(got, torch.from_numpy(labels))
    assert str(jloss._value.dtype) == "float32" and loss.dtype == torch.float32
    np.testing.assert_allclose(float(loss), float(jloss._value), atol=1e-2)
    tr = Trainer(m.train(), AdamW(1e-3), lambda mm, b: GPTPretrainingCriterion()(
        mm(b["input_ids"]), b["labels"]), device="cpu")
    step = tr.step({"input_ids": IDS, "labels": labels})
    assert step.dtype == torch.float32 and torch.isfinite(step)
