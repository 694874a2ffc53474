"""The port's BERT/ERNIE (paddle_tpu_torch.models.bert) against the JAX
package on the CPU, one JAX model's weights carried across by
`state_dict_from_numpy`: a head_dim-64 `bert_tiny` (hidden 128, 2 heads,
so attention takes the flash route with its padding-mask branch) and the
stock `bert_tiny` (head_dim 32, `mha_reference`), with padding masks.
Dropout is 0 here (the hash dropout is held bit for bit against the JAX
package in test_torch_dropout.py and test_torch_flash_masked.py); the
port's own dropout path is checked for determinism by seed.

Tolerances, each with its reason:
  * f32 MLM/NSP logits within 1e-4, the loss within 1e-5, gradients
    within 1e-4: the same f32 weights and math, summed in other orders
    (~1e-6 relative a layer; logits ~0.5, loss ~8).
  * 3 Trainer + AdamW(1e-3, weight_decay 0.01, no clip) steps: losses
    within 1e-5, parameters within 1e-4 (a tenth of lr: an entry whose
    gradient cancels to the f32 noise moves by a part of lr the noise
    decides), f32 and bf16 moment slots. The key projections' biases,
    whose gradient is 0 in exact arithmetic (softmax over keys ignores
    them), move by about lr a step in either package as the rounding
    noise decides; they are held within 3 lr of their start instead.
  * bf16 (cfg.dtype "bfloat16" in both packages): logits within 2^-7
    of their largest magnitude plus 2^-7 — one bf16 step a layer's
    worth of rounding at other places (the tolerance
    test_torch_training.py gives a bf16 update).
"""
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed import build_mesh
from paddle_tpu.distributed.trainer import Trainer as JaxTrainer
from paddle_tpu.models import bert as JB
from paddle_tpu_torch.distributed import Trainer
from paddle_tpu_torch.models import bert as TB
from paddle_tpu_torch.models import state_dict_from_numpy
from paddle_tpu_torch.nn import MultiHeadAttention
from paddle_tpu_torch.ops import attention as A
from paddle_tpu_torch.ops import layer_norm as LN
from paddle_tpu_torch.optimizer import AdamW


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


V, LR, PARAM_TOL = 1024, 1e-3, 1e-4
NO_DROP = dict(hidden_dropout=0.0, attention_dropout=0.0)
FLASH = dict(hidden_size=128, num_heads=2)          # head_dim 64


def _batch(B=2, L=64, seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, V, (B, L)).astype("int32")
    lens = rng.randint(L * 3 // 4, L + 1, (B,))
    mask = (np.arange(L)[None] < lens[:, None]).astype("int32")
    ids[mask == 0] = 0
    labels = rng.randint(0, V, (B, L))
    labels[rng.rand(B, L) > 0.15] = -100
    return {"input_ids": ids, "attention_mask": mask,
            "mlm_labels": labels.astype("int32"),
            "nsp_labels": rng.randint(0, 2, (B,)).astype("int64")}


def _jax_model(cls=JB.BertForPretraining, **kw):
    paddle.seed(7)
    return cls(JB.bert_tiny(**kw))


def _np_state(jmodel):
    return {k: np.asarray(v._value) for k, v in jmodel.state_dict().items()}


def _port_model(np_state, cls=TB.BertForPretraining, **kw):
    m = cls(TB.bert_tiny(**kw), device="cpu")
    m.load_state_dict(state_dict_from_numpy(np_state, device="cpu"))
    return m


def _jax_forward(jm, b):
    return jm(paddle.to_tensor(b["input_ids"]),
              attention_mask=paddle.to_tensor(b["attention_mask"]))


def _port_forward(m, b):
    return m(torch.as_tensor(b["input_ids"]),
             attention_mask=torch.as_tensor(b["attention_mask"]))


def _jax_loss(out, b):
    return JB.BertPretrainingCriterion(V)(
        *out, paddle.to_tensor(b["mlm_labels"]),
        paddle.to_tensor(b["nsp_labels"]))


def _port_loss(out, b):
    return TB.BertPretrainingCriterion(V)(
        *out, torch.as_tensor(b["mlm_labels"]),
        torch.as_tensor(b["nsp_labels"]))


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=tol, rtol=0)


@pytest.mark.parametrize("kw,flash", [(FLASH, True), ({}, False)])
def test_pretraining_logits_loss_grads_match_jax(kw, flash):
    jm = _jax_model(**NO_DROP, **kw)
    model = _port_model(_np_state(jm), **NO_DROP, **kw)
    b = _batch()
    jout = _jax_forward(jm, b)
    jloss = _jax_loss(jout, b)
    jloss.backward()
    A.reset_counts()
    LN.reset_counts()
    out = _port_forward(model, b)
    loss = _port_loss(out, b)
    loss.backward()
    assert out[0].dtype == torch.float32
    _close(out[0], jout[0].numpy(), 1e-4)
    _close(out[1], jout[1].numpy(), 1e-4)
    _close(loss, jloss.numpy(), 1e-5)
    jgrads = {k: p.grad.numpy() for k, p in jm.named_parameters()}
    for k, p in model.named_parameters():
        _close(p.grad, jgrads[k], 1e-4)
    # 2 layers of attention (flash route only); LayerNorm: embeddings, 2
    # a layer, the MLM head
    assert A.plain_launches == dict.fromkeys(A.KERNELS, 2 * flash)
    assert LN.plain_launches == 6


def _jax_train(jm, b, steps, acc_dtype):
    build_mesh(dp=1)
    crit = JB.BertPretrainingCriterion(V)
    opt = paddle.optimizer.AdamW(learning_rate=LR, weight_decay=0.01,
                                 accumulator_dtype=acc_dtype)

    def loss_fn(m, batch):
        return crit(*m(paddle.to_tensor(batch["input_ids"]),
                       attention_mask=paddle.to_tensor(
                           batch["attention_mask"])),
                    paddle.to_tensor(batch["mlm_labels"]),
                    paddle.to_tensor(batch["nsp_labels"]))

    # donate=False: the suite's multi-device compile memo does not take
    # donating programs here; it changes no number
    tr = JaxTrainer(jm, opt, loss_fn, donate=False)
    losses = [float(tr.step(b)) for _ in range(steps)]
    return losses, {k: np.asarray(v) for k, v in tr.params.items()}


@pytest.mark.parametrize("acc_dtype", [None, "bfloat16"])
def test_trainer_steps_match_jax(acc_dtype):
    jm = _jax_model(**NO_DROP, **FLASH)
    model = _port_model(_np_state(jm), **NO_DROP, **FLASH)
    b = _batch(seed=1)
    jlosses, jparams = _jax_train(jm, b, 3, acc_dtype)
    crit = TB.BertPretrainingCriterion(V)
    tr = Trainer(model, AdamW(LR, weight_decay=0.01,
                              accumulator_dtype=acc_dtype),
                 lambda m, bt: crit(*m(bt["input_ids"],
                                       attention_mask=bt["attention_mask"]),
                                    bt["mlm_labels"], bt["nsp_labels"]),
                 device="cpu")
    losses = [float(tr.step(b)) for _ in range(3)]
    np.testing.assert_allclose(losses, jlosses, atol=1e-5, rtol=0)
    assert losses[-1] < losses[0]
    params = dict(model.named_parameters())
    assert set(params) == set(jparams)
    for k, want in jparams.items():
        if k.endswith("k_proj.bias"):
            # its gradient is 0 in exact arithmetic (a key bias adds
            # q.b to a whole row of logits; softmax ignores it), so Adam
            # moves it by about lr a step in a direction the rounding
            # noise decides, in either package: both stay within
            # 3 steps of lr of where they started
            start = _np_state(_jax_model(**NO_DROP, **FLASH))[k]
            for got in (params[k].detach().numpy(), want):
                assert np.abs(got - start).max() <= 3 * LR * 1.01, k
            continue
        _close(params[k], want, PARAM_TOL)


def test_bf16_forward_matches_jax():
    jm = _jax_model(**NO_DROP, **FLASH, dtype="bfloat16")
    model = _port_model(_np_state(jm), **NO_DROP, **FLASH, dtype="bfloat16")
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    b = _batch(seed=2)
    jout = _jax_forward(jm, b)
    with torch.no_grad():
        out = _port_forward(model, b)
    assert out[0].dtype == torch.float32
    for got, want in zip(out, jout):
        want = np.asarray(want.numpy(), np.float32)
        _close(got, want, 2.0 ** -7 * (1 + np.abs(want).max()))


def test_sequence_classification_logits_match_jax():
    jm = _jax_model(JB.BertForSequenceClassification, **NO_DROP, **FLASH)
    model = _port_model(_np_state(jm), TB.BertForSequenceClassification,
                        **NO_DROP, **FLASH)
    b = _batch(seed=3)
    _close(_port_forward(model, b), _jax_forward(jm, b).numpy(), 1e-4)
    assert TB.ErnieForSequenceClassification is \
        TB.BertForSequenceClassification


def test_own_init_follows_the_jax_recipe():
    """The port's seeded weights: the JAX keys and shapes (46 for
    bert_tiny, mlm_bias first), N(0, 0.02) embeddings with the padding
    row 0, XavierUniform Linears, LayerNorm 1/0, biases 0, each encoder
    layer its own draw; the same numbers for the same seed."""
    sd = TB.BertForPretraining(TB.bert_tiny(), device="cpu",
                               seed=3).state_dict()
    jsd = _jax_model().state_dict()
    assert list(sd) == list(jsd) and len(sd) == 46
    assert all(tuple(sd[k].shape) == tuple(jsd[k].shape) for k in sd)
    for k, v in sd.items():
        if "embeddings." in k and k.endswith("weight") and "norm" not in k:
            assert abs(float(v.std()) / 0.02 - 1) < 0.15, k
        elif "norm" in k and k.endswith("weight"):
            assert torch.equal(v, torch.ones_like(v)), k
        elif k.endswith("bias"):
            assert torch.equal(v, torch.zeros_like(v)), k
        else:
            limit = (6.0 / sum(v.shape)) ** 0.5
            assert float(v.abs().max()) <= limit, k
            assert abs(float(v.std()) / (limit / 3 ** 0.5) - 1) < 0.15, k
    assert not sd["bert.embeddings.word_embeddings.weight"][0].any()
    w = "bert.encoder.layers.{}.self_attn.q_proj.weight"
    assert not torch.equal(sd[w.format(0)], sd[w.format(1)])
    again = TB.BertForPretraining(TB.bert_tiny(), device="cpu",
                                  seed=3).state_dict()
    assert all(torch.equal(sd[k], again[k]) for k in sd)


def test_dropout_draws_follow_the_model_seed():
    """With dropout on, two models of one seed draw the same salts and
    attention seeds (from their CPU generators) and give the same loss;
    eval mode drops nothing."""
    b = _batch(seed=4)
    losses = []
    for _ in range(2):
        m = TB.BertForPretraining(TB.bert_tiny(**FLASH), device="cpu",
                                  seed=5)
        losses.append(float(_port_loss(_port_forward(m, b), b).detach()))
    m.eval()
    with torch.no_grad():
        eval_loss = float(_port_loss(_port_forward(m, b), b))
    assert losses[0] == losses[1] and eval_loss != losses[0]


def test_unported_options_raise():
    with pytest.raises(NotImplementedError):
        MultiHeadAttention(64, 2, need_weights=True, device="cpu")
    mha = MultiHeadAttention(64, 1, device="cpu")
    x = torch.zeros(1, 4, 64)
    with pytest.raises(NotImplementedError):
        mha.gen_cache(x)
    with pytest.raises(NotImplementedError):
        mha(x, cache=MultiHeadAttention.Cache(x, x))


def test_bert_builds_without_jax():
    code = """
import sys
sys.modules["jax"] = None
import paddle_tpu_torch
from paddle_tpu_torch.models import BertForPretraining, bert_tiny
m = BertForPretraining(bert_tiny(), device="cpu")
print(len(m.state_dict()))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "46", out.stderr
