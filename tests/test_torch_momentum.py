"""The port's SGD and Momentum (paddle_tpu_torch.optimizer) against the
JAX rule (`Optimizer.apply_gradients_pytree` of paddle_tpu's `SGD` and
`Momentum`) one step at a time: each step starts both from the JAX
state (parameters, velocity, master copy), so a difference cannot
compound. And the decay objects (`regularizer.L2Decay` / `L1Decay`) as
`weight_decay`, which the port's optimizers took only as numbers before.

Tolerances, each with its reason:
  * f32 parameters and slots: 2 f32 ulps of the largest magnitude: the
    same f32 operations, but XLA on the CPU may contract a product and a
    sum into one fused multiply-add (one rounding where PyTorch makes
    two).
  * bf16 parameters (without a master copy): one bf16 step (2^-7 of the
    largest magnitude): the f32 result above is rounded once to bf16, and
    an f32 ulp's difference can cross a bf16 rounding boundary.
  * Trainer + Momentum steps (ResNet-18 NHWC in training mode, 2 x 64 x
    64 a micro-batch, lr 0.01, momentum 0.9, L2Decay 1e-4): losses and
    the first step's buffers within 1e-4; parameters, and the second
    step's buffers (the statistics of step 1's weights), within 1e-3 of
    (1 + magnitude), a tenth of lr: batch statistics over few values
    make the f32 gradients ill-conditioned (JAX's own differ from a
    float64 evaluation by up to a few % on some parameters;
    test_torch_resnet.py), times lr over two momentum steps (measured
    1.4e-4 on the stem's weight, 6.5e-4 on a second-step running mean).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.distributed import build_mesh
from paddle_tpu.distributed.trainer import Trainer as JaxTrainer
from paddle_tpu.vision import models as JV
from paddle_tpu_torch import regularizer
from paddle_tpu_torch.distributed import Trainer
from paddle_tpu_torch.models import state_dict_from_numpy
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import SGD, Adam, AdamW, Momentum
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


SHAPES = [(7, 5), (33,), (4, 3, 3, 2)]
LR = 0.1


def _state(seed, dtype):
    rng = np.random.RandomState(seed)
    params = {f"p{i}": jnp.asarray(rng.randn(*s).astype(np.float32))
              .astype(dtype) for i, s in enumerate(SHAPES)}
    grads = {k: jnp.asarray(rng.randn(*v.shape).astype(np.float32))
             .astype(dtype) for k, v in params.items()}
    return params, grads


def _t(a):
    """A torch copy of a JAX array (f32, or bf16 through f32)."""
    a = jnp.asarray(a)
    t = torch.from_numpy(np.array(a.astype(jnp.float32)))
    return t.bfloat16() if a.dtype == jnp.bfloat16 else t


def _close(got, want, dtype):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    mag = np.abs(want).max()
    tol = (2.0 ** -7 * mag if dtype == jnp.bfloat16
           else 2 * np.finfo(np.float32).eps * mag)
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=0,
                               atol=tol)


def _jax_decay(wd):
    if isinstance(wd, regularizer.L2Decay):
        return paddle.regularizer.L2Decay(wd.coeff)
    if isinstance(wd, regularizer.L1Decay):
        return paddle.regularizer.L1Decay(wd.coeff)
    return wd


# (name, port class, kwargs, parameter dtype)
CASES = [
    ("sgd", SGD, {}, jnp.float32),
    ("sgd_wd", SGD, {"weight_decay": 0.01}, jnp.float32),
    ("sgd_l2", SGD, {"weight_decay": regularizer.L2Decay(0.01)}, jnp.float32),
    ("sgd_bf16", SGD, {}, jnp.bfloat16),
    ("sgd_master", SGD, {"multi_precision": True}, jnp.bfloat16),
    ("momentum", Momentum, {"momentum": 0.9}, jnp.float32),
    ("nesterov", Momentum, {"momentum": 0.9, "use_nesterov": True},
     jnp.float32),
    ("rescale", Momentum, {"momentum": 0.9, "rescale_grad": 0.5,
                           "weight_decay": 1e-4}, jnp.float32),
    ("l2decay", Momentum, {"momentum": 0.9,
                           "weight_decay": regularizer.L2Decay(1e-4)},
     jnp.float32),
    ("l1decay", Momentum, {"momentum": 0.9,
                           "weight_decay": regularizer.L1Decay(1e-3)},
     jnp.float32),
    ("momentum_bf16", Momentum, {"momentum": 0.9, "weight_decay": 1e-4},
     jnp.bfloat16),
    ("momentum_master", Momentum, {"momentum": 0.9, "weight_decay": 1e-4,
                                   "multi_precision": True,
                                   "use_nesterov": True}, jnp.bfloat16),
]


@pytest.mark.parametrize("name,cls,kw,dtype", CASES, ids=[c[0] for c in CASES])
def test_steps_match_the_jax_rule(name, cls, kw, dtype):
    jcls = getattr(paddle.optimizer, cls.__name__)
    jkw = {k: _jax_decay(v) for k, v in kw.items()}
    jopt = jcls(learning_rate=LR, **jkw)
    params, grads = _state(0, dtype)
    jstate = jopt.init_state_pytree(params)
    tparams = [_t(v) for v in params.values()]
    opt = cls(learning_rate=LR, parameters=tparams, **kw)
    for step in range(3):
        _, grads = _state(step + 1, dtype)
        # start the port from the JAX state of this step
        for p, k in zip(tparams, params):
            p.copy_(_t(params[k]))
            slots = opt._slots(p)
            for s, v in jstate["slots"][k].items():
                slots[s] = _t(v).float() if s == "master" else _t(v)
        opt.apply_gradients(list(zip(tparams,
                                      [_t(g) for g in grads.values()])))
        params, jstate = jopt.apply_gradients_pytree(params, grads, jstate)
        for p, k in zip(tparams, params):
            assert p.dtype == _t(params[k]).dtype
            _close(p, params[k], dtype)
            for s, v in jstate["slots"][k].items():
                assert opt._slots(p)[s].dtype == torch.float32, s
                _close(opt._slots(p)[s], v, jnp.float32)


def test_momentum_velocity_is_f32_and_rescale_precedes_decay():
    """Momentum's velocity is f32 whatever the parameter's dtype, as in
    JAX; rescale_grad multiplies the raw gradient before the decay."""
    p = torch.ones(4, dtype=torch.bfloat16)
    opt = Momentum(learning_rate=1.0, momentum=0.5, parameters=[p],
                   rescale_grad=0.5, weight_decay=0.25)
    opt.apply_gradients([(p, torch.full((4,), 2.0, dtype=torch.bfloat16))])
    v = opt._slots(p)["velocity"]
    assert v.dtype == torch.float32
    # v = 0.5 * 2 + 0.25 * 1 = 1.25; p = 1 - 1.25
    assert torch.equal(v, torch.full((4,), 1.25))
    assert torch.equal(p, torch.full((4,), -0.25, dtype=torch.bfloat16))


@pytest.mark.parametrize("cls", [Adam, AdamW, Momentum, SGD])
@pytest.mark.parametrize("decay", [regularizer.L2Decay, regularizer.L1Decay])
def test_decay_objects_act_as_their_coefficient(cls, decay):
    """A `weight_decay` given as an L2Decay / L1Decay object takes its
    coefficient, as the JAX `Optimizer` does (optimizer.py:45-50): the
    same update bit for bit as the number. The port's optimizers raised
    TypeError on one before."""
    runs = []
    for wd in (decay(0.05), 0.05):
        params, grads = _state(4, jnp.float32)
        ps = [_t(v) for v in params.values()]
        opt = cls(learning_rate=LR, parameters=ps, weight_decay=wd)
        for _ in range(2):
            opt.apply_gradients(list(zip(ps, [_t(g) for g in grads.values()])))
        runs.append(ps)
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    term = decay(0.05)(torch.tensor([-2.0, 3.0]))
    want = [-0.05, 0.05] if decay is regularizer.L1Decay else [-0.1, 0.15]
    assert torch.allclose(term, torch.tensor(want))


def _resnet18(np_state):
    m = TV.resnet18(num_classes=10, data_format="NHWC", device="cpu")
    m.load_state_dict(state_dict_from_numpy(np_state, device="cpu"))
    return m


def _rel_close(got, want, rel, what):
    err = np.abs(np.asarray(got, np.float64) - want).max()
    assert err <= rel * (1 + np.abs(want).max()), (what, err)


def _jax_train(jm, x, y, steps, lr, accum):
    build_mesh(dp=1)
    opt = paddle.optimizer.Momentum(
        learning_rate=lr, momentum=0.9,
        weight_decay=paddle.regularizer.L2Decay(1e-4))

    def loss_fn(m, b):
        return JF.cross_entropy(m(paddle.to_tensor(b["image"])),
                                paddle.to_tensor(b["label"]))

    # donate=False: the suite's multi-device compile memo does not take
    # donating programs here; it changes no number
    tr = JaxTrainer(jm, opt, loss_fn, donate=False, grad_accum_steps=accum)
    batch = {"image": x, "label": y}
    names = set(jm.state_dict())
    out = []
    for _ in range(steps):
        loss = float(tr.step(batch))
        out.append((loss, {k: np.asarray(v) for k, v in
                           {**tr.params, **tr.consts}.items() if k in names}))
    return out


@pytest.mark.parametrize("accum", [1, 2])
def test_trainer_momentum_steps_match_jax(accum):
    """2 steps of Trainer + Momentum(0.01, 0.9, L2Decay(1e-4)) on
    ResNet-18 NHWC in training mode; with grad_accum_steps 2 (micro-
    batches of 2) the buffers must end with the last micro-batch's
    update from the step's starting buffers, as the JAX Trainer's."""
    paddle.seed(11)
    jm = JV.resnet18(num_classes=10, data_format="NHWC")
    st = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    rng = np.random.RandomState(2)
    x = rng.randn(2 * accum, 64, 64, 3).astype(np.float32)
    y = rng.randint(0, 10, (2 * accum,)).astype(np.int64)
    jsteps = _jax_train(jm, x, y, 2, 0.01, accum)
    model = _resnet18(st)
    tr = Trainer(model, Momentum(0.01, 0.9,
                                 weight_decay=regularizer.L2Decay(1e-4)),
                 lambda m, b: F.cross_entropy(m(b["image"]), b["label"]),
                 device="cpu", grad_accum_steps=accum)
    for step, (jloss, jstate) in enumerate(jsteps):
        loss = float(tr.step({"image": x, "label": y}))
        assert abs(loss - jloss) <= 1e-4, (step, loss, jloss)
        state = model.state_dict()
        assert set(state) == set(jstate)
        for k, want in jstate.items():
            # step 1's buffers come from the starting weights; step 2's
            # from step 1's, which carry the gradients' f32 noise
            buffer = k.endswith("_mean") or k.endswith("_variance")
            tol = 1e-4 if buffer and step == 0 else 1e-3
            _rel_close(state[k].numpy(), want, tol, (step, k))
            assert not np.array_equal(want, st[k]), k
    if accum == 2:
        # the buffers' first step, again in the port alone: the second
        # micro-batch's statistics from the starting buffers
        again = _resnet18(st).train()
        with torch.no_grad():
            again(torch.from_numpy(x[2:]))
        for k, b in again.named_buffers():
            _rel_close(b.numpy(), jsteps[0][1][k], 1e-4, k)
