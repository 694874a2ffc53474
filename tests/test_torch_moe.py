"""The port's Mixture-of-Experts GPT (`paddle_tpu_torch.models.moe`)
against the JAX package (`paddle_tpu.models.moe`) on the CPU: the
index-routed `_moe_dispatch` against the JAX one-hot einsum dispatch for
every gate policy, train and eval, with capacity factors 1.25 and 0.5
(tokens dropped); `GPTMoE(gpt_moe_tiny())` with one JAX model's weights
carried across by `convert`; 3 Trainer steps with AdamW against the JAX
Trainer; a JAX trainer's state carried across with bf16 slots. Inputs
come from numpy seeds.

Tolerances, each with its reason:
  * f32 dispatch: y within 1e-5 and aux within 1e-6 (values ~1; the same
    f32 routing, the expert products and the router summed in other
    orders, ~1e-7 measured); each gradient within 1e-5 of its largest
    magnitude (~1e-6 measured).
  * bf16 dispatch: the routing is f32 in both and must agree, so aux is
    held within 1e-6; y within 2^-6 of max |y| (bf16 products and gelu
    rounded at the same points, their f32 sums in other orders: a few
    bf16 steps at most).
  * GPTMoE f32: logits within 1e-4, loss and aux loss within 1e-5 (the
    GPT tolerances of `test_torch_training.py`), gradients within 1e-4.
  * 3 Trainer steps: losses within 1e-5, parameters within 1e-4 (a tenth
    of lr: Adam moves an entry whose gradient cancels to the f32 noise by
    a part of lr that the noise decides).
"""
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed import build_mesh
from paddle_tpu.distributed.trainer import Trainer as JaxTrainer
from paddle_tpu.models import GPTPretrainingCriterion as JaxCriterion
from paddle_tpu.models import moe as JM
from paddle_tpu.models import moe_gate as JG
from paddle_tpu.nn import ClipGradForMOEByGlobalNorm as JaxMoEClip
from paddle_tpu_torch import random as R
from paddle_tpu_torch.distributed import LossBuffer, Trainer
from paddle_tpu_torch.models import (GPTPretrainingCriterion,
                                     state_dict_from_numpy,
                                     trainer_state_from_numpy)
from paddle_tpu_torch.models import moe as TM
from paddle_tpu_torch.models import moe_gate as TG
from paddle_tpu_torch.nn import ClipGradForMOEByGlobalNorm
from paddle_tpu_torch.optimizer import AdamW

LR = 1e-3
GATES = {"topk": (lambda: JG.NaiveTopKGate(2), lambda: TG.NaiveTopKGate(2)),
         "switch": (JG.SwitchGate, TG.SwitchGate),
         "gshard": (JG.GShardGate, TG.GShardGate)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread while a test of this module runs (the suite's
    workers beside XLA's thread pools oversubscribe the CPU otherwise).
    Results do not depend on it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dispatch_inputs(T=64, H=32, E=4, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(T, H).astype("float32"),
            rng.randn(H, E).astype("float32"),
            (rng.randn(E, H, 2 * H) * 0.05).astype("float32"),
            (rng.randn(E, 2 * H) * 0.05).astype("float32"),
            (rng.randn(E, 2 * H, H) * 0.05).astype("float32"),
            (rng.randn(E, H) * 0.05).astype("float32")]


def _jax_dispatch(args, policy, cf, train, dy, dtype=jnp.float32):
    def f(*a):
        y, aux = JM._moe_dispatch(a[0].astype(dtype), *a[1:], policy, cf,
                                  key=jax.random.key(5), train=train)
        return jnp.sum(y.astype(jnp.float32) * dy) + aux, (y, aux)
    (_, (y, aux)), grads = jax.value_and_grad(
        f, argnums=tuple(range(6)), has_aux=True)(
            *[jnp.asarray(a) for a in args])
    return (np.asarray(y.astype(jnp.float32)), float(aux),
            [np.asarray(g) for g in grads])


def _port_dispatch(args, policy, cf, train, dy, dtype=torch.float32):
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    y, aux = TM._moe_dispatch(ts[0].to(dtype), *ts[1:], policy, cf,
                              key=R.PRNGKey(5, device="cpu"), train=train)
    loss = (y.float() * torch.from_numpy(dy)).sum() + aux
    grads = torch.autograd.grad(loss, ts)
    return (y.detach().float().numpy(), float(aux.detach()),
            [g.numpy() for g in grads])


@pytest.mark.parametrize("cf", [1.25, 0.5])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("gate", list(GATES))
def test_dispatch_matches_jax(gate, train, cf):
    args = _dispatch_inputs()
    dy = np.random.RandomState(3).randn(64, 32).astype("float32")
    jpol, tpol = (make() for make in GATES[gate])
    jy, jaux, jgrads = _jax_dispatch(args, jpol, cf, train, dy)
    y, aux, grads = _port_dispatch(args, tpol, cf, train, dy)
    np.testing.assert_allclose(y, jy, atol=1e-5, rtol=0)
    assert abs(aux - jaux) <= 1e-6
    names = ("x", "gate_w", "w1", "b1", "w2", "b2")
    for name, g, jg in zip(names, grads, jgrads):
        scale = float(np.abs(jg).max())
        assert scale > 0, name
        np.testing.assert_allclose(g, jg, atol=1e-5 * scale, rtol=0,
                                   err_msg=name)


def test_dispatch_drops_tokens_at_low_capacity():
    """cf 0.5 gives C = 16 slots an expert for 64 tokens x 2 rounds:
    tokens are dropped, every expert's kept count is at most C, each slot
    holds one token, and the top-2 weights are >= 0 with sums <= 1."""
    x, gw = (torch.from_numpy(a) for a in _dispatch_inputs()[:2])
    w, aux, r = TM._route(x, gw, 4, TG.NaiveTopKGate(2), 0.5)
    assert r.capacity == 16
    kept = r.slots[r.keep]
    assert len(kept) < 128
    assert torch.bincount(kept, minlength=64).max() == 1
    assert torch.bincount(kept // 16, minlength=4).max() <= 16
    assert (w >= 0).all() and (w.sum(1) <= 1 + 1e-6).all()
    assert (r.slots[~r.keep] == 64).all()


def test_dispatch_bf16_matches_jax():
    args = _dispatch_inputs(T=128)
    dy = np.random.RandomState(4).randn(128, 32).astype("float32")
    jy, jaux, _ = _jax_dispatch(args, JG.NaiveTopKGate(2), 1.25, True, dy,
                                jnp.bfloat16)
    y, aux, grads = _port_dispatch(args, TG.NaiveTopKGate(2), 1.25, True,
                                   dy, torch.bfloat16)
    assert abs(aux - jaux) <= 1e-6
    np.testing.assert_allclose(y, jy, atol=2 ** -6 * np.abs(jy).max(),
                               rtol=0)
    assert all(np.isfinite(g).all() for g in grads)


# ------------------------------------------------------------ GPTMoE


def _batch(B=4, L=16, V=256, seed=0):
    ids = np.random.RandomState(seed).randint(0, V, (B, L + 1))
    return {"input_ids": ids[:, :-1].astype("int32"),
            "labels": ids[:, 1:].astype("int32")}


def _jax_model(**kw):
    paddle.seed(7)
    return JM.GPTMoE(JM.gpt_moe_tiny(**kw))


def _np_state(jmodel):
    return {k: np.asarray(v._value) for k, v in jmodel.state_dict().items()}


def _port_model(np_state, **kw):
    m = TM.GPTMoE(TM.gpt_moe_tiny(**kw), device="cpu")
    m.load_state_dict(state_dict_from_numpy(np_state, device="cpu"))
    return m


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=0, err_msg=msg)


def test_gpt_moe_logits_loss_aux_grads_match_jax():
    jm = _jax_model()
    model = _port_model(_np_state(jm))
    b = _batch()
    jlogits = jm(paddle.to_tensor(b["input_ids"]))
    jce = JaxCriterion()(jlogits, paddle.to_tensor(b["labels"]))
    jaux = jm.aux_loss()
    (jce + jaux).backward()
    logits = model(torch.from_numpy(b["input_ids"]))
    ce = GPTPretrainingCriterion()(logits, torch.from_numpy(b["labels"]))
    aux = model.aux_loss()
    (ce + aux).backward()
    assert logits.dtype == torch.float32 and aux.dtype == torch.float32
    _close(logits, jlogits.numpy(), 1e-4)
    _close(ce, jce.numpy(), 1e-5)
    _close(aux, jaux.numpy(), 1e-5)
    assert float(aux.detach()) > 0
    jgrads = {k: p.grad.numpy() for k, p in jm.named_parameters()}
    assert set(jgrads) == {k for k, _ in model.named_parameters()}
    for k, p in model.named_parameters():
        _close(p.grad, jgrads[k], 1e-4, k)


def _loss_fns():
    jcrit, crit = JaxCriterion(), GPTPretrainingCriterion()

    def jloss(m, b):
        logits = m(paddle.to_tensor(b["input_ids"]))
        return jcrit(logits, paddle.to_tensor(b["labels"])) + m.aux_loss()

    def loss(m, b):
        return crit(m(b["input_ids"]), b["labels"]) + m.aux_loss()
    return jloss, loss


def _is_expert(name):
    return ".moe.w" in name or ".moe.b" in name


@pytest.mark.parametrize("acc_dtype", [None, "bfloat16"])
def test_trainer_steps_match_jax(acc_dtype):
    """3 steps of AdamW under the MoE clip (expert parameters picked by
    name, the Trainer's path) against the JAX Trainer."""
    jm = _jax_model()
    model = _port_model(_np_state(jm))
    b = _batch(seed=1)
    jloss, loss = _loss_fns()
    build_mesh(dp=1)
    jopt = paddle.optimizer.AdamW(
        learning_rate=LR, grad_clip=JaxMoEClip(0.5, _is_expert),
        accumulator_dtype=acc_dtype)
    jtr = JaxTrainer(jm, jopt, jloss, donate=False)
    jlosses = [float(jtr.step(b)) for _ in range(3)]
    opt = AdamW(LR, grad_clip=ClipGradForMOEByGlobalNorm(0.5, _is_expert),
                accumulator_dtype=acc_dtype)
    tr = Trainer(model, opt, loss, device="cpu")
    buf = LossBuffer(drain_every=3)
    for _ in range(3):
        buf.append(tr.step(b))
    np.testing.assert_allclose(buf.losses, jlosses, atol=1e-5, rtol=0)
    assert buf.losses[-1] < buf.losses[0]
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jtr.params[k]),
                                   atol=1e-4, rtol=0, err_msg=k)


def test_jax_trainer_state_resumes_in_the_port():
    """A JAX GPTMoE trainer's state after 2 steps (bf16 AdamW slots)
    carried across by `trainer_state_from_numpy`: the port's state tree
    is the JAX one bit for bit (names, shapes, bf16 slots), and step 3
    continues as the JAX run does."""
    jm = _jax_model()
    model = _port_model(_np_state(jm))
    b = _batch(seed=2)
    jloss, loss = _loss_fns()
    build_mesh(dp=1)
    jtr = JaxTrainer(jm, paddle.optimizer.AdamW(
        learning_rate=LR, accumulator_dtype="bfloat16"), jloss,
        donate=False)
    for _ in range(2):
        jtr.step(b)
    jstate = jax.tree_util.tree_map(np.asarray, jtr.state())
    tr = Trainer(model, AdamW(LR, accumulator_dtype="bfloat16"), loss,
                 device="cpu")
    tr.load_state(trainer_state_from_numpy(jstate, device="cpu"))
    got = tr.state()
    for n, slots in jstate["opt_state"]["slots"].items():
        assert slots["moment1"].dtype.name == "bfloat16"
        for s, v in slots.items():
            np.testing.assert_array_equal(
                got["opt_state"]["slots"][n][s], v.astype(np.float32))
        np.testing.assert_array_equal(got["params"][n],
                                      jstate["params"][n])
    assert got["opt_state"]["step"] == 2
    jl = float(jtr.step(b))
    assert abs(float(tr.step(b)) - jl) <= 1e-5
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jtr.params[k]),
                                   atol=1e-4, rtol=0, err_msg=k)


def test_config_counts_match_jax():
    for jcfg, cfg in ((JM.gpt_moe_tiny(), TM.gpt_moe_tiny()),
                      (JM.gpt_moe_small(), TM.gpt_moe_small()),
                      (JM.gpt_moe_small(gate="switch"),
                       TM.gpt_moe_small(gate="switch"))):
        assert cfg.num_params() == jcfg.num_params()
        assert cfg.num_active_params() == jcfg.num_active_params()
        assert cfg._n_moe_blocks() == jcfg._n_moe_blocks()


def test_unsupported_forms_raise():
    with pytest.raises(NotImplementedError):
        TM.GPTMoE(TM.gpt_moe_tiny(tie_embeddings=False), device="cpu")
    model = TM.GPTMoE(TM.gpt_moe_tiny(), device="cpu")
    with pytest.raises(NotImplementedError):
        model.init_cache(1, 8)
    with pytest.raises(NotImplementedError):
        model(torch.zeros(1, 4, dtype=torch.long), cache=[None, None])
    assert float(TM.GPTMoE(TM.gpt_moe_tiny(), device="cpu").aux_loss()) == 0


def test_remat_is_ignored_and_no_jax_is_imported():
    """`cfg.remat` changes nothing (no recompute, as in JAX): the same
    loss and gradients either way; and the MoE modules import neither
    jax nor paddle_tpu."""
    b = _batch(B=2)
    grads = []
    for remat in (False, True):
        m = TM.GPTMoE(TM.gpt_moe_tiny(remat=remat), device="cpu", seed=3)
        loss = GPTPretrainingCriterion()(
            m(torch.from_numpy(b["input_ids"])),
            torch.from_numpy(b["labels"])) + m.aux_loss()
        loss.backward()
        grads.append([p.grad for p in m.parameters()])
    assert all(torch.equal(a, c) for a, c in zip(*grads))
    code = ("import sys; import paddle_tpu_torch.models.moe, "
            "paddle_tpu_torch.nn.clip, paddle_tpu_torch.incubate.moe; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'paddle_tpu')]; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True)
