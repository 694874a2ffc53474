"""Checkpoint and resume in the port: `Optimizer.state_dict` /
`set_state_dict` in the JAX layout, `Trainer.state()` / `load_state()`
in the JAX `Trainer.state()` tree, and `models.convert.
trainer_state_from_numpy`, which carries a JAX trainer's state into the
port. `gpt_tiny` (2 heads: the flash route) on the CPU.

Tolerances, each with its reason:
  * the port resumed after 3 of 6 steps against its uninterrupted run:
    bit-equal (the same CPU ops on the same restored bits; bf16 slots and
    parameters travel through float32 numpy arrays, which is exact).
  * a JAX `Trainer.state()` after 3 steps continued in the port against
    the JAX run's steps 4-6: losses within 1e-5 and parameters within
    1e-4, the tolerances of `test_torch_training.py` (same f32 model,
    matmuls summed in other orders; bf16 moment slots round at the same
    places in both packages).
  * the slots of one eager JAX optimizer step against the port's: 1e-6
    (one f32 update from the same gradients, summed in other orders).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.optimizer.lr as jlr
from paddle_tpu.distributed import build_mesh
from paddle_tpu.distributed.trainer import Trainer as JaxTrainer
from paddle_tpu.models import GPT as JaxGPT
from paddle_tpu.models import GPTPretrainingCriterion as JaxCriterion
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu_torch.distributed import Trainer
from paddle_tpu_torch.models import (GPT, GPTPretrainingCriterion, gpt_tiny,
                                     state_dict_from_numpy,
                                     trainer_state_from_numpy)
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.optimizer import lr as plr

CFG = dict(num_heads=2, max_seq_len=128, dtype="float32")


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


def _batches(n, B=2, L=128, V=1024):
    out = []
    for s in range(n):
        ids = np.random.RandomState(s).randint(0, V, (B, L + 1))
        out.append({"input_ids": ids[:, :-1].astype("int32"),
                    "labels": ids[:, 1:].astype("int32")})
    return out


def _sched(m):
    return m.LinearWarmup(m.CosineAnnealingDecay(2e-3, T_max=4),
                          warmup_steps=2, start_lr=0.0, end_lr=2e-3)


def _np_state():
    paddle.seed(7)
    jmodel = JaxGPT(jax_gpt_tiny(remat=False, **CFG))
    return jmodel, {k: np.asarray(v._value)
                    for k, v in jmodel.state_dict().items()}


def _port_trainer(np_state, bf16=False, **opt_kw):
    model = GPT(gpt_tiny(**{**CFG, "dtype": "bfloat16" if bf16 else
                            "float32"}), device="cpu")
    model.load_state_dict(state_dict_from_numpy(np_state, device="cpu"))
    if bf16:
        model = model.bfloat16()
    opt = AdamW(_sched(plr), weight_decay=0.1,
                grad_clip=ClipGradByGlobalNorm(1.0), **opt_kw)
    crit = GPTPretrainingCriterion()
    return Trainer(model, opt, lambda m, b: crit(m(b["input_ids"]),
                                                 b["labels"]), device="cpu")


def _host(tree):
    """A state tree with every tensor leaf as a numpy array (what a user
    would save)."""
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().float().numpy().copy()
    return tree


def test_state_dict_layout_matches_jax():
    """One eager step of the JAX AdamW (multi_precision off) against one
    port step on the same model and batch: the same keys (`step`,
    `{index}.moment1/2`, `LR_Scheduler`), the same scheduler state, and
    the same slot values."""
    jmodel, np_state = _np_state()
    b = _batches(1)[0]
    jopt = paddle.optimizer.AdamW(
        learning_rate=_sched(jlr), weight_decay=0.1,
        parameters=jmodel.parameters(),
        grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))
    jloss = JaxCriterion()(jmodel(paddle.to_tensor(b["input_ids"])),
                           paddle.to_tensor(b["labels"]))
    jloss.backward()
    jopt.step()
    jopt._learning_rate.step()
    jsd = jopt.state_dict()

    tr = _port_trainer(np_state)
    tr.step(b)
    sd = tr.optimizer.state_dict()
    assert set(sd) == set(jsd)
    n = len(list(tr.model.parameters()))
    assert {k for k in sd if k.endswith(".moment1")} == {
        f"{i}.moment1" for i in range(n)}
    assert sd["step"] == jsd["step"] == 1
    assert sd["LR_Scheduler"] == jsd["LR_Scheduler"]
    for k, v in sd.items():
        if k not in ("step", "LR_Scheduler"):
            np.testing.assert_allclose(v.numpy(), np.asarray(jsd[k]._value),
                                       atol=1e-6, rtol=0, err_msg=k)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_resume_bit_equal_to_uninterrupted(bf16):
    """Run A takes 6 steps; run B takes 3, saves `Trainer.state()` and the
    optimizer's `state_dict()` as numpy, and a fresh model, optimizer and
    trainer load them and take 3 more. Losses, parameters, slots and the
    scheduler's position are bit-equal. bf16: bf16 parameters with f32
    master copies and bf16 moment slots."""
    _, np_state = _np_state()
    batches = _batches(6)
    kw = ({"multi_precision": True, "accumulator_dtype": "bfloat16"}
          if bf16 else {})
    a = _port_trainer(np_state, bf16, **kw)
    la = [float(a.step(b)) for b in batches]

    b1 = _port_trainer(np_state, bf16, **kw)
    lb = [float(b1.step(b)) for b in batches[:3]]
    state, opt_sd = _host(b1.state()), _host(b1.optimizer.state_dict())
    assert state["step"] == 3 and state["opt_state"]["step"] == 3
    assert set(state) == {"params", "opt_state", "step"}
    slots = state["opt_state"]["slots"]
    assert set(slots) == set(state["params"]) == {
        n for n, _ in b1.model.named_parameters()}
    assert set(slots["wte.weight"]) == (
        {"moment1", "moment2", "master"} if bf16 else {"moment1", "moment2"})

    b2 = _port_trainer(np_state, bf16, **kw)        # fresh, untrained
    b2.optimizer.set_state_dict(opt_sd)
    b2.load_state(state)
    assert b2.optimizer._lr_scheduler.last_epoch == 3
    lb += [float(b2.step(b)) for b in batches[3:]]
    assert lb == la
    for (n, p), (_, q) in zip(a.model.named_parameters(),
                              b2.model.named_parameters()):
        assert p.dtype == q.dtype and torch.equal(p, q), n
    for p, q in zip(a.params, b2.params):
        sa, sb = a.optimizer._state[p], b2.optimizer._state[q]
        assert set(sa) == set(sb)
        for k in sa:
            assert sa[k].dtype == sb[k].dtype and torch.equal(sa[k], sb[k])
    assert (b2.optimizer._lr_scheduler.last_epoch
            == a.optimizer._lr_scheduler.last_epoch == 6)
    assert b2.optimizer._step_count == a.optimizer._step_count == 6
    b2.sync_to_model()              # the model is the trainer's: a no-op


def test_state_dict_is_a_snapshot():
    """`state_dict()` taken after 2 steps, then one more step (the AdamW
    kernel updates the live slots in place), then the snapshot restored
    together with the step-2 parameters: the next 3 steps are bit-equal
    to a fresh trainer resumed from a numpy copy of the same snapshot."""
    _, np_state = _np_state()
    batches = _batches(5)
    a = _port_trainer(np_state)
    for b in batches[:2]:
        a.step(b)
    snap = a.optimizer.state_dict()
    host_sd = _host(snap)
    params = {k: v.detach().clone() for k, v in a.model.state_dict().items()}
    a.step(batches[2])
    a.model.load_state_dict(params)
    a.optimizer.set_state_dict(snap)

    b2 = _port_trainer(np_state)
    b2.model.load_state_dict(params)
    b2.optimizer.set_state_dict(host_sd)
    assert b2.optimizer._lr_scheduler.last_epoch == 2
    la = [float(a.step(b)) for b in batches[2:]]
    lb = [float(b2.step(b)) for b in batches[2:]]
    assert la == lb
    for (n, p), (_, q) in zip(a.model.named_parameters(),
                              b2.model.named_parameters()):
        assert torch.equal(p, q), n


def test_load_state_refuses_a_mismatched_tree():
    _, np_state = _np_state()
    tr = _port_trainer(np_state)
    state = tr.state()
    bad = dict(state, params={**state["params"], "extra": np.zeros(1)})
    with pytest.raises(KeyError):
        tr.load_state(bad)
    w = state["params"]["wte.weight"]
    bad = dict(state, params={**state["params"], "wte.weight": w[:-1]})
    with pytest.raises(ValueError):
        tr.load_state(bad)


def test_jax_trainer_state_resumes_in_the_port():
    """The JAX Trainer takes 3 steps; its `state()` (bf16 moment slots)
    and its optimizer's `state_dict()` (the scheduler) go into a fresh
    port trainer, which takes steps 4-6 as the JAX trainer does."""
    jmodel, np_state = _np_state()
    batches = _batches(6)
    build_mesh(dp=1)
    jcrit = JaxCriterion()
    jopt = paddle.optimizer.AdamW(
        learning_rate=_sched(jlr), weight_decay=0.1,
        grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0),
        accumulator_dtype="bfloat16")
    jtr = JaxTrainer(jmodel, jopt, lambda m, b: jcrit(
        m(paddle.to_tensor(b["input_ids"])), paddle.to_tensor(b["labels"])),
        donate=False)
    for b in batches[:3]:
        jtr.step(b)
    jstate, jopt_sd = jtr.state(), jopt.state_dict()
    jlosses = [float(jtr.step(b)) for b in batches[3:]]

    tr = _port_trainer(np_state, accumulator_dtype="bfloat16")
    tr.optimizer.set_state_dict(jopt_sd)
    tr.load_state(trainer_state_from_numpy(jstate, device="cpu"))
    assert tr.optimizer._step_count == 3 and tr._host_step == 3
    p0 = tr.params[0]
    assert tr.optimizer._state[p0]["moment1"].dtype == torch.bfloat16
    assert tr.optimizer.get_lr() == _lr_after(3)
    losses = [float(tr.step(b)) for b in batches[3:]]
    np.testing.assert_allclose(losses, jlosses, atol=1e-5, rtol=0)
    for k, v in jtr.params.items():
        np.testing.assert_allclose(
            dict(tr.model.named_parameters())[k].detach().numpy(),
            np.asarray(v), atol=1e-4, rtol=0, err_msg=k)


def _lr_after(n):
    s = _sched(plr)
    for _ in range(n):
        s.step()
    return s()
