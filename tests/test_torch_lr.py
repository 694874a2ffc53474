"""The port's LR schedulers (`paddle_tpu_torch.optimizer.lr`, its own copy
of the JAX package's plain-Python module) and their use by the optimizer
and the Trainer, against the JAX package.

Tolerances, each with its reason:
  * scheduler values: equal as Python floats (the same Python
    arithmetic on the same inputs).
  * 5 gpt_tiny Trainer steps under LinearWarmup(CosineAnnealingDecay)
    against the JAX Trainer: losses within 1e-5 and parameters within
    1e-4, the tolerances of `test_torch_training.py` (same f32 model,
    matmuls summed in other orders; see that module), and each step's lr
    equal to the scheduler's value before its `step()`.
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
                                     state_dict_from_numpy)
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import SGD, AdamW
from paddle_tpu_torch.optimizer import lr as plr

STEPS = 200
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


def _schedulers(m):
    """Every schedule class of `lr` (m: either package's module), some in
    two modes, with the same arguments: (name, scheduler)."""
    return [
        ("NoamDecay", m.NoamDecay(d_model=512, warmup_steps=40,
                                  learning_rate=2.0)),
        ("PiecewiseDecay", m.PiecewiseDecay([30, 90, 150],
                                            [0.1, 0.05, 0.01, 0.001])),
        ("NaturalExpDecay", m.NaturalExpDecay(0.5, gamma=0.03)),
        ("InverseTimeDecay", m.InverseTimeDecay(0.5, gamma=0.07)),
        ("PolynomialDecay", m.PolynomialDecay(0.3, decay_steps=120,
                                              end_lr=1e-4, power=2.0)),
        ("PolynomialDecay-cycle", m.PolynomialDecay(
            0.3, decay_steps=45, power=1.5, cycle=True)),
        ("LinearWarmup", m.LinearWarmup(
            m.CosineAnnealingDecay(2e-4, T_max=150), warmup_steps=25,
            start_lr=0.0, end_lr=2e-4)),
        ("LinearWarmup-float", m.LinearWarmup(0.1, warmup_steps=17,
                                              start_lr=0.01, end_lr=0.1)),
        ("ExponentialDecay", m.ExponentialDecay(0.4, gamma=0.97)),
        ("MultiStepDecay", m.MultiStepDecay(0.2, milestones=[20, 70, 140],
                                            gamma=0.3)),
        ("StepDecay", m.StepDecay(0.2, step_size=33, gamma=0.5)),
        ("LambdaDecay", m.LambdaDecay(0.1, lambda e: 0.95 ** e)),
        ("ReduceOnPlateau", m.ReduceOnPlateau(0.1, factor=0.5, patience=4,
                                              cooldown=2, min_lr=1e-4)),
        ("CosineAnnealingDecay", m.CosineAnnealingDecay(0.1, T_max=70,
                                                        eta_min=1e-3)),
        ("MultiplicativeDecay", m.MultiplicativeDecay(
            0.1, lambda e: 0.99 if e % 3 else 0.9)),
        ("OneCycleLR", m.OneCycleLR(0.5, total_steps=180,
                                    three_phase=False)),
        ("OneCycleLR-linear", m.OneCycleLR(0.5, total_steps=120,
                                           anneal_strategy="linear")),
        ("CyclicLR", m.CyclicLR(0.01, 0.1, step_size_up=13,
                                step_size_down=21, mode="triangular2")),
        ("CyclicLR-exp", m.CyclicLR(0.01, 0.1, step_size_up=9,
                                    mode="exp_range", exp_gamma=0.99)),
    ]


def _metrics():
    """A loss curve that falls, stalls and wobbles, so ReduceOnPlateau
    both keeps and cuts its rate."""
    rng = np.random.RandomState(0)
    curve = np.concatenate([np.linspace(5, 2, 60), np.full(80, 2.0),
                            np.linspace(2, 1.5, 60)])
    return curve + rng.randn(STEPS) * 0.01


def _walk(sched, metrics):
    out = []
    for t in range(STEPS):
        out.append(sched())
        if type(sched).__name__ == "ReduceOnPlateau":
            sched.step(metrics[t])
        else:
            sched.step()
    return out


def test_every_scheduler_class_is_covered():
    names = {type(s).__name__ for _, s in _schedulers(plr)}
    assert names == set(plr.__all__) - {"LRScheduler"}
    assert len(plr.__all__) == 16         # 15 schedules and their base
    assert plr.__all__ == jlr.__all__


@pytest.mark.parametrize("idx", range(len(_schedulers(plr))),
                         ids=[n for n, _ in _schedulers(plr)])
def test_scheduler_matches_jax(idx):
    metrics = _metrics()
    name, ours = _schedulers(plr)[idx]
    _, theirs = _schedulers(jlr)[idx]
    got, want = _walk(ours, metrics), _walk(theirs, metrics)
    assert got == want, name
    assert len(set(got)) > 1, name          # the schedule moves


def test_state_dict_round_trip():
    """A scheduler's state_dict restored into a fresh one continues the
    same sequence, also through LinearWarmup's wrapped decay, and an
    optimizer carries it under "LR_Scheduler"."""
    def make():
        return plr.LinearWarmup(plr.CosineAnnealingDecay(1e-3, T_max=40),
                                warmup_steps=10, start_lr=0.0, end_lr=1e-3)
    a = make()
    for _ in range(13):
        a.step()
    b = make()
    b.set_state_dict(a.state_dict())
    assert b.last_epoch == a.last_epoch == 13
    for _ in range(30):
        assert a() == b()
        a.step()
        b.step()

    p = torch.zeros(3)
    opt = SGD(learning_rate=make(), parameters=[p])
    opt._lr_scheduler.step()
    sd = opt.state_dict()
    assert sd["step"] == 0 and sd["LR_Scheduler"]["last_epoch"] == 1
    opt2 = SGD(learning_rate=make(), parameters=[p])
    opt2.set_state_dict(sd)
    assert opt2.get_lr() == opt.get_lr() == 1e-4
    with pytest.raises(TypeError):
        SGD(learning_rate=lambda: 1e-3)


def _batch(B, seed=0, L=128, V=1024):
    ids = np.random.RandomState(seed).randint(0, V, (B, L + 1))
    return {"input_ids": ids[:, :-1].astype("int32"),
            "labels": ids[:, 1:].astype("int32")}


def _sched(m):
    return m.LinearWarmup(m.CosineAnnealingDecay(2e-3, T_max=3),
                          warmup_steps=2, start_lr=0.0, end_lr=2e-3)


def test_trainer_steps_under_warmup_cosine_match_jax():
    paddle.seed(7)
    jmodel = JaxGPT(jax_gpt_tiny(**CFG))
    np_state = {k: np.asarray(v._value)
                for k, v in jmodel.state_dict().items()}
    batches = [_batch(2, seed=s) for s in range(5)]

    build_mesh(dp=1)
    jcrit = JaxCriterion()
    jopt = paddle.optimizer.AdamW(
        learning_rate=_sched(jlr), weight_decay=0.1,
        grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))
    jtr = JaxTrainer(jmodel, jopt, lambda m, b: jcrit(
        m(paddle.to_tensor(b["input_ids"])), paddle.to_tensor(b["labels"])),
        donate=False)
    jlosses, jlrs = [], []
    for b in batches:
        jlrs.append(jopt.get_lr())
        jlosses.append(float(jtr.step(b)))

    model = GPT(gpt_tiny(**CFG), device="cpu")
    model.load_state_dict(state_dict_from_numpy(np_state, device="cpu"))
    crit = GPTPretrainingCriterion()
    opt = AdamW(_sched(plr), weight_decay=0.1,
                grad_clip=ClipGradByGlobalNorm(1.0))
    tr = Trainer(model, opt, lambda m, b: crit(m(b["input_ids"]),
                                               b["labels"]), device="cpu")
    losses, lrs = [], []
    for b in batches:
        lrs.append(opt.get_lr())
        losses.append(float(tr.step(b)))
    assert lrs == jlrs and lrs[0] == 0.0 and lrs[2] == 2e-3
    assert opt._lr_scheduler.last_epoch == 5
    np.testing.assert_allclose(losses, jlosses, atol=1e-5, rtol=0)
    for k, v in jtr.params.items():
        np.testing.assert_allclose(dict(model.named_parameters())[k]
                                   .detach().numpy(), np.asarray(v),
                                   atol=1e-4, rtol=0, err_msg=k)
