"""The port's GPT training path (paddle_tpu_torch: GPT, criterion, AdamW
with ClipGradByGlobalNorm, Trainer) against the JAX package on
`gpt_tiny` (2 heads, so head_dim 64 takes the flash attention route in
both packages' rules), with one JAX model's weights carried across by
`state_dict_from_numpy`. Everything is f32, on the CPU, where the port runs
the plain versions of its kernels: flash attention, LayerNorm and the
streaming cross-entropy.

Tolerances, each with its reason:
  * logits within 1e-4 and the loss within 1e-5: the same f32 weights,
    matmuls and softmaxes summed in other orders (~1e-6 relative a
    layer; logits ~1, loss ~7).
  * losses of 3 Trainer steps within 1e-5.
  * parameters after 3 AdamW steps within PARAM_TOL = 1e-4, a tenth of
    lr (1e-3): Adam divides each gradient by its own running RMS, so
    most entries move by lr times a ratio both packages compute alike,
    but an entry whose gradient cancels to ~1e-8 (the size of Adam's
    epsilon and of the f32 summation noise of the sum) moves by a part
    of lr that the noise decides; a few such entries exist (1 in 65536
    here, off by up to 5e-5). bf16 moment slots round m and v to 8 bits
    in both packages, at the same places.
  * remat 'full' against 'none' inside the port: bit-identical (the
    recompute runs the same CPU ops on the same inputs).
"""
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.distributed import build_mesh
from paddle_tpu.distributed.trainer import Trainer as JaxTrainer
from paddle_tpu.models import GPT as JaxGPT
from paddle_tpu.models import GPTPretrainingCriterion as JaxCriterion
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu_torch.distributed import LossBuffer, Trainer
from paddle_tpu_torch.models import (GPT, GPTPretrainingCriterion, gpt_tiny,
                                     init_state_dict, state_dict_from_numpy)
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.ops import attention as A
from paddle_tpu_torch.ops import fused_ops as X
from paddle_tpu_torch.ops import layer_norm as LN
from paddle_tpu_torch.optimizer import Adam, AdamW

LR, PARAM_TOL = 1e-3, 1e-4
CFG = dict(num_heads=2, max_seq_len=128, dtype="float32")


def _batch(B, seed=0, L=128, V=1024):
    ids = np.random.RandomState(seed).randint(0, V, (B, L + 1))
    return {"input_ids": ids[:, :-1].astype("int32"),
            "labels": ids[:, 1:].astype("int32")}


def _jax_model(remat=True):
    paddle.seed(7)
    return JaxGPT(jax_gpt_tiny(remat=remat, **CFG))


def _np_state(jmodel):
    return {k: np.asarray(v._value) for k, v in jmodel.state_dict().items()}


def _port_model(np_state, remat_policy="full"):
    m = GPT(gpt_tiny(remat_policy=remat_policy, **CFG), device="cpu")
    m.load_state_dict(state_dict_from_numpy(np_state, device="cpu"))
    return m


def _jax_train(jmodel, batch, steps, acc_dtype, accum=1):
    build_mesh(dp=1)
    crit = JaxCriterion()
    opt = paddle.optimizer.AdamW(
        learning_rate=LR, weight_decay=0.1,
        grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0),
        accumulator_dtype=acc_dtype)

    def loss_fn(m, b):
        return crit(m(paddle.to_tensor(b["input_ids"])),
                    paddle.to_tensor(b["labels"]))

    # donate=False: buffer donation changes no number, and the suite's
    # multi-device compile memo does not take donating programs here
    tr = JaxTrainer(jmodel, opt, loss_fn, grad_accum_steps=accum,
                    donate=False)
    losses = [float(tr.step(batch)) for _ in range(steps)]
    return losses, {k: np.asarray(v) for k, v in tr.params.items()}


def _port_train(model, batch, steps, acc_dtype, accum=1):
    crit = GPTPretrainingCriterion()
    opt = AdamW(LR, weight_decay=0.1, grad_clip=ClipGradByGlobalNorm(1.0),
                accumulator_dtype=acc_dtype)
    tr = Trainer(model, opt, lambda m, b: crit(m(b["input_ids"]),
                                               b["labels"]),
                 device="cpu", grad_accum_steps=accum)
    buf = LossBuffer(drain_every=steps)
    for _ in range(steps):
        buf.append(tr.step(batch))
    assert buf.fetches == 1
    return buf.losses, {k: v.detach().numpy()
                        for k, v in model.state_dict().items()}


def _params_close(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=PARAM_TOL, rtol=0,
                                   err_msg=k)


def test_logits_and_loss_match_jax():
    jmodel = _jax_model(remat=False)
    model = _port_model(_np_state(jmodel))
    b = _batch(2)
    jlogits = jmodel(paddle.to_tensor(b["input_ids"]))
    jloss = JaxCriterion()(jlogits, paddle.to_tensor(b["labels"]))
    for r in (A, LN, X):
        r.reset_counts()
    with torch.no_grad():
        logits = model(torch.from_numpy(b["input_ids"]))
        loss = GPTPretrainingCriterion()(logits,
                                         torch.from_numpy(b["labels"]))
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits._value),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(float(loss), float(jloss._value), atol=1e-5,
                               rtol=0)
    # the kernels' plain versions ran: 2 blocks x (attention, 2 LN) + ln_f
    assert A.plain_launches["flash_fwd"] == 2
    assert LN.plain_launches == 5
    assert X.plain_launches["xent_fwd"] == 1


@pytest.mark.parametrize("acc_dtype", [None, "bfloat16"])
def test_trainer_steps_match_jax(acc_dtype):
    jmodel = _jax_model()
    np_state = _np_state(jmodel)
    b = _batch(2, seed=1)
    jlosses, jparams = _jax_train(jmodel, b, 3, acc_dtype)
    losses, params = _port_train(_port_model(np_state), b, 3, acc_dtype)
    np.testing.assert_allclose(losses, jlosses, atol=1e-5, rtol=0)
    assert losses[-1] < losses[0]
    _params_close(params, jparams)


def test_grad_accumulation_matches_jax():
    jmodel = _jax_model()
    np_state = _np_state(jmodel)
    b = _batch(4, seed=2)
    jlosses, jparams = _jax_train(jmodel, b, 2, None, accum=2)
    losses, params = _port_train(_port_model(np_state), b, 2, None, accum=2)
    np.testing.assert_allclose(losses, jlosses, atol=1e-5, rtol=0)
    _params_close(params, jparams)


@pytest.mark.parametrize("name,multi_precision,acc_dtype", [
    ("AdamW", True, "bfloat16"), ("AdamW", False, None),
    ("Adam", False, None)])
def test_optimizer_update_matches_jax(name, multi_precision, acc_dtype):
    """The optimizer alone on bf16 parameters against the JAX
    `apply_gradients_pytree`: 3 updates with the global-norm clip, f32
    master weights (multi_precision) or not, bf16 or f32 slots, decoupled
    (AdamW) or L2 (Adam) decay. Both compute each update in f32 from the
    same inputs and round it once to bf16, so the parameters agree
    within one bf16 step of their magnitude (~2: 2^-7) and the f32 master
    copies within 1e-6."""
    import paddle_tpu.optimizer as jopt
    rng = np.random.RandomState(4)
    shapes = {"w": (64, 32), "b": (32,)}
    p0 = {k: (rng.randn(*s) * 2).astype(np.float32) for k, s in
          shapes.items()}
    grads = [{k: (rng.randn(*s) * 3).astype(np.float32) for k, s in
              shapes.items()} for _ in range(3)]
    kw = dict(learning_rate=LR, weight_decay=0.1,
              multi_precision=multi_precision, accumulator_dtype=acc_dtype)
    jo = getattr(jopt, name)(grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0),
                             **kw)
    jp = {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in p0.items()}
    state = jo.init_state_pytree(jp)
    for g in grads:
        jp, state = jo.apply_gradients_pytree(
            jp, {k: jnp.asarray(v).astype(jnp.bfloat16)
                 for k, v in g.items()}, state)
    opt_cls = {"Adam": Adam, "AdamW": AdamW}[name]
    to = opt_cls(grad_clip=ClipGradByGlobalNorm(1.0), **kw)
    tp = [torch.from_numpy(p0[k]).bfloat16() for k in shapes]
    for g in grads:
        to.apply_gradients(tp, [torch.from_numpy(g[k]).bfloat16()
                                for k in shapes])
    for t, k in zip(tp, shapes):
        np.testing.assert_allclose(
            t.float().numpy(), np.asarray(jp[k].astype(jnp.float32)),
            atol=2.0 ** -7, rtol=0, err_msg=k)
        slots = to._state[t]
        assert ("master" in slots) == multi_precision
        assert slots["moment1"].dtype == (torch.bfloat16 if acc_dtype
                                          else torch.float32)
        if multi_precision:
            np.testing.assert_allclose(
                slots["master"].numpy(),
                np.asarray(state["slots"][k]["master"]), atol=1e-6, rtol=0)


def test_remat_full_equals_none():
    np_state = _np_state(_jax_model())
    b = _batch(2, seed=3)
    runs = []
    for policy in ("full", "none"):
        A.reset_counts()
        LN.reset_counts()
        runs.append(_port_train(_port_model(np_state, policy), b, 2, None))
        # remat reruns each block's forward kernels in the backward
        # (attention forwards, LayerNorm forwards) a step: 2 blocks, each
        # with 1 attention and 2 LayerNorms, plus ln_f
        per_step = {"full": (4, 9), "none": (2, 5)}[policy]
        assert A.plain_launches["flash_fwd"] == 2 * per_step[0]
        assert LN.plain_launches == 2 * per_step[1]
    (l1, p1), (l2, p2) = runs
    assert l1 == l2
    for k in p1:
        assert np.array_equal(p1[k], p2[k]), k


def test_init_state_dict_follows_the_jax_recipe():
    """init_state_dict draws the JAX model's initializers: N(0, 0.02) for
    the embeddings, qkv and fc1, N(0, 0.02/sqrt(2L)) for proj and fc2,
    LayerNorm weights 1, biases 0 — the same keys and shapes as the JAX
    GPT's state dict, and the same numbers for the same seed. Sample
    stds within 10% (>= 16k draws each)."""
    cfg = gpt_tiny(**CFG)
    sd = init_state_dict(cfg, seed=3, device="cpu")
    jsd = _jax_model().state_dict()
    assert list(sd) == list(jsd)
    assert all(tuple(sd[k].shape) == tuple(jsd[k].shape) for k in sd)
    out_std = 0.02 / np.sqrt(2 * cfg.num_layers)
    for k, v in sd.items():
        if k.endswith(("ln1.weight", "ln2.weight", "ln_f.weight")):
            assert torch.equal(v, torch.ones_like(v)), k
        elif k.endswith("bias"):
            assert torch.equal(v, torch.zeros_like(v)), k
        else:
            want = out_std if k.endswith(("proj.weight", "fc2.weight")) \
                else 0.02
            assert abs(float(v.std()) / want - 1) < 0.1, k
    again = init_state_dict(cfg, seed=3, device="cpu")
    assert all(torch.equal(sd[k], again[k]) for k in sd)


def test_unported_options_raise():
    with pytest.raises(NotImplementedError):
        GPT(gpt_tiny(remat_policy="dots", **CFG), device="cpu")
    # sp_mode picks a branch that needs a mesh; the port has none, so
    # every value the JAX config takes runs the plain path, as JAX does
    # on one device, and only a value JAX refuses raises
    gpt_tiny(sp_mode="ulysses")
    with pytest.raises(ValueError):
        gpt_tiny(sp_mode="tree")
    with pytest.raises(NotImplementedError):
        AdamW(learning_rate=lambda: 1e-3)


def test_training_entry_points_refuse_missing_card():
    """device=None means the card: without one, the entry points raise
    instead of training on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None uses it")
    cfg = gpt_tiny(**CFG)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GPT(cfg)
    model = GPT(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(model, AdamW(LR), lambda m, b: None)


def test_every_port_module_imports_no_jax():
    """In a fresh interpreter, importing every module of the port pulls
    in neither jax nor paddle_tpu."""
    code = """
import importlib, pkgutil, sys
import paddle_tpu_torch
for m in pkgutil.walk_packages(paddle_tpu_torch.__path__, "paddle_tpu_torch."):
    importlib.import_module(m.name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu"))
assert not bad, bad
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
