"""The port's four gradient clips (`paddle_tpu_torch.nn.clip`) against
the JAX package's on `(param, grad)` pairs and on the Trainer's
`{name: grad}` form: `None` gradients and `need_clip=False` parameters
pass through unclipped, `group_name` / `auto_skip_clip` are accepted, the
MoE clip takes a parameter predicate on pairs and a name predicate in
`clip_pytree`; the optimizers take Paddle's pair form in
`apply_gradients`, and AdamW's folded clip scale equals a clip followed
by an unclipped update, bit for bit.

Tolerances: clipped gradients within 1e-6 of JAX's (f32 squares summed in
another order; values ~1); optimizer updates against JAX within 1e-6 (one
f32 step); the folded scale inside the port bit-equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.framework.core import Parameter as JaxParameter
from paddle_tpu.nn import clip as JC
from paddle_tpu_torch.nn import (ClipGradByGlobalNorm, ClipGradByNorm,
                                 ClipGradByValue, ClipGradForMOEByGlobalNorm)
from paddle_tpu_torch.optimizer import SGD, AdamW, Momentum

SHAPES = ((6, 5), (5,), (3, 4, 2), (7,))


def _arrays(seed=0, scale=3.0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(*s) * scale).astype("float32") for s in SHAPES]


def _pairs(grads, no_grad=(1,), no_clip=(3,)):
    """(JAX pairs, port pairs): parameter i has no gradient if i is in
    `no_grad` and `need_clip=False` if in `no_clip`."""
    jp, tp = [], []
    for i, g in enumerate(grads):
        jparam = JaxParameter(jnp.zeros(g.shape, jnp.float32))
        tparam = torch.nn.Parameter(torch.zeros(g.shape))
        if i in no_clip:
            jparam.need_clip = False
            tparam.need_clip = False
        jg = None if i in no_grad else paddle.to_tensor(g)
        tg = None if i in no_grad else torch.from_numpy(g.copy())
        jp.append((jparam, jg))
        tp.append((tparam, tg))
    return jp, tp


CLIPS = {
    "value": (lambda: JC.ClipGradByValue(0.5),
              lambda: ClipGradByValue(0.5)),
    "value_min": (lambda: JC.ClipGradByValue(0.5, -0.2),
                  lambda: ClipGradByValue(0.5, -0.2)),
    "norm": (lambda: JC.ClipGradByNorm(1.0), lambda: ClipGradByNorm(1.0)),
    "global": (lambda: JC.ClipGradByGlobalNorm(1.0),
               lambda: ClipGradByGlobalNorm(1.0)),
    "global_group": (
        lambda: JC.ClipGradByGlobalNorm(1.0, "default_group", True),
        lambda: ClipGradByGlobalNorm(1.0, "default_group", True)),
    "moe_param": (
        lambda: JC.ClipGradForMOEByGlobalNorm(
            1.0, lambda p: p.shape == [3, 4, 2]),
        lambda: ClipGradForMOEByGlobalNorm(
            1.0, lambda p: tuple(p.shape) == (3, 4, 2))),
}


@pytest.mark.parametrize("name", list(CLIPS))
def test_clip_pairs_match_jax(name):
    grads = _arrays()
    jpairs, tpairs = _pairs(grads)
    jclip, tclip = (make() for make in CLIPS[name])
    jout, tout = jclip(jpairs), tclip(tpairs)
    assert len(tout) == len(tpairs)
    for (jp, jg), (tp, tg), (p0, g0) in zip(jout, tout, tpairs):
        assert tp is p0
        if g0 is None:
            assert tg is None and jg is None
            continue
        np.testing.assert_allclose(tg.numpy(), jg.numpy(), atol=1e-6,
                                   rtol=0)
    assert tout[3][1] is tpairs[3][1]          # need_clip=False: untouched
    if name.startswith(("global", "moe")):
        clipped = [g for i, (_, g) in enumerate(tout) if i in (0, 2)]
        norm = float(torch.sqrt(sum(g.square().sum() for g in clipped)))
        assert abs(norm - 1.0) < 1e-5


@pytest.mark.parametrize("name", ["value", "norm", "global"])
def test_clip_pytree_matches_jax(name):
    grads = _arrays(seed=1)
    names = [f"blocks.{i}.w" for i in range(len(grads))]
    jclip, tclip = (make() for make in CLIPS[name])
    jout = jclip.clip_pytree(dict(zip(names, map(jnp.asarray, grads))))
    tout = tclip.clip_pytree({n: torch.from_numpy(g)
                              for n, g in zip(names, grads)})
    assert list(tout) == names
    for n in names:
        np.testing.assert_allclose(tout[n].numpy(), np.asarray(jout[n]),
                                   atol=1e-6, rtol=0)


def test_moe_clip_name_predicate_matches_jax():
    """The Trainer's form: the predicate sees dotted names; expert and
    dense squares form one global norm."""
    grads = _arrays(seed=2, scale=2.0)
    names = ["blocks.1.moe.w1", "blocks.1.ln2.weight", "blocks.1.moe.b2",
             "wte.weight"]

    def is_expert(n):
        return ".moe." in n
    seen = []
    jout = JC.ClipGradForMOEByGlobalNorm(0.5, is_expert).clip_pytree(
        dict(zip(names, map(jnp.asarray, grads))))
    tout = ClipGradForMOEByGlobalNorm(
        0.5, lambda n: seen.append(n) or is_expert(n)).clip_pytree(
            {n: torch.from_numpy(g) for n, g in zip(names, grads)})
    assert seen == names
    for n in names:
        np.testing.assert_allclose(tout[n].numpy(), np.asarray(jout[n]),
                                   atol=1e-6, rtol=0)
    norm = float(torch.sqrt(sum(g.square().sum() for g in tout.values())))
    assert abs(norm - 0.5) < 1e-5


@pytest.mark.parametrize("gdtype", [torch.float32, torch.bfloat16])
def test_adamw_folded_moe_clip_equals_clip_then_update(gdtype):
    """AdamW folds a global-norm clip into its fused update as one scale:
    on the pair path and on the Trainer's named path the parameters and
    slots equal a clip applied first and an unclipped AdamW, bit for
    bit."""
    grads = [torch.from_numpy(g).to(gdtype) for g in _arrays(seed=3)]
    names = ["moe.w1", "ln.w", "moe.b1", "wte.w"]

    def is_expert(t):
        return t.startswith("moe.") if isinstance(t, str) else t.dim() == 3
    p0 = [torch.from_numpy(g).float() * 0.1 for g in _arrays(seed=4)]
    runs = []
    for mode in ("pairs", "named", "clip_first"):
        ps = [torch.nn.Parameter(p.clone()) for p in p0]
        clip = ClipGradForMOEByGlobalNorm(1.0, is_expert)
        if mode == "clip_first":
            opt = AdamW(1e-2, weight_decay=0.1)
            opt.apply_gradients(clip(list(zip(ps, grads))))
        else:
            opt = AdamW(1e-2, weight_decay=0.1, grad_clip=clip)
            if mode == "pairs":
                opt.apply_gradients(list(zip(ps, grads)))
            else:
                opt._apply_named(names, ps, grads)
        runs.append([t for p in ps for t in (p, *opt._slots(p).values())])
    for run in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(runs[0], run))


def test_apply_gradients_pairs_match_jax():
    """SGD and Momentum take (param, grad) pairs with ClipGradByValue /
    ClipGradByNorm (clipped before the update) and skip a None gradient,
    as the JAX `Optimizer.apply_gradients` does for its clipped pairs."""
    grads = _arrays(seed=5)
    p0 = _arrays(seed=6, scale=1.0)
    for jcls, tcls, jclip, tclip in (
            (paddle.optimizer.SGD, SGD, JC.ClipGradByValue(0.5),
             ClipGradByValue(0.5)),
            (paddle.optimizer.Momentum, Momentum, JC.ClipGradByNorm(1.0),
             ClipGradByNorm(1.0))):
        jps = [JaxParameter(jnp.asarray(p)) for p in p0]
        tps = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
        jopt = jcls(learning_rate=0.1, parameters=jps, grad_clip=jclip)
        topt = tcls(learning_rate=0.1, parameters=tps, grad_clip=tclip)
        for _ in range(2):
            jopt.apply_gradients([(p, paddle.to_tensor(g))
                                  for p, g in zip(jps[:3], grads[:3])])
            topt.apply_gradients(
                [(p, torch.from_numpy(g)) for p, g in zip(tps[:3], grads[:3])]
                + [(tps[3], None)])
        for jp, tp, p in zip(jps, tps, p0):
            np.testing.assert_allclose(tp.detach().numpy(), jp.numpy(),
                                       atol=1e-6, rtol=0)
        assert np.array_equal(tps[3].detach().numpy(), p0[3])
